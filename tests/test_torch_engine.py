"""The port's graph engine (``seldon_core_tpu_torch/runtime/engine.py``) held
against the JAX package's ``GraphEngine`` on the CPU: every local-node
scenario of ``tests/test_engine.py`` (its two remote-node tests are held in
``tests/test_torch_remote.py``) runs the same spec and the same seeded numpy request
through both engines, fused and unfused.

- Built-ins and host components answer bit-equal: the whole response dict,
  meta (tags, routing, requestPath, metrics) included, equal but for the
  puid; errors raise the same status and message.
- The port fuses exactly the units the JAX engine fuses (each node's fused
  flag and covered units), and its fused answer equals its unfused one;
  ``_fused_calls`` counts the fused runs.
- JAX_SERVER leaves (live-weight folded ResNet-18s at 64x64 from the JAX
  package's ``export_checkpoint(use_orbax=False)``) under an
  AVERAGE_COMBINER: the port's fused and unfused logits within FWD_TOL of
  max|logit| of the JAX engine's (the JAX package serves the flax module,
  the port its bf16 serve forward; ``tests/test_torch_torchserver.py``'s
  tolerance), top-1 equal where the margin is clear; the port's fused and
  unfused within 1e-5 of max|logit| (a float32 mean on the device against
  a float64 mean on the host of the same logits).
- Deadlines, breakers (a router reroutes around an open branch; with
  allow-partial a combiner drops it), a router's ``observe_outcome`` hook,
  and what the remote-node slice brought in place of its refusals.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.components.component import SeldonComponent as JaxComponent
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import Feedback as JaxFeedback
from seldon_core_tpu.contracts.payload import SeldonError as JaxError
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models.resnet import fold_batchnorm as jax_fold_batchnorm
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.runtime.resilience import Deadline as JaxDeadline
from seldon_core_tpu.runtime.resilience import ResilienceConfig as JaxConfig
from seldon_core_tpu.servers.jaxserver import export_checkpoint as jax_export
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import PredictorSpec, load_predictor_spec_from_env
from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonError, SeldonMessage
from seldon_core_tpu_torch.runtime.engine import GraphEngine
from seldon_core_tpu_torch.runtime.resilience import Deadline, ResilienceConfig

FWD_TOL = 0.03
FUSE_TOL = 1e-5


def tensor_body(shape, seed=0, puid="req-1"):
    x = np.random.default_rng(seed).standard_normal(shape).round(3)
    return {"meta": {"puid": puid},
            "data": {"tensor": {"shape": list(shape), "values": x.ravel().tolist()}}}


def build(graph, comps=None, fuse=True, annotations=None):
    """(JAX engine, port engine) of one spec; ``comps(base)`` makes each
    side's components over its own SeldonComponent base."""
    spec = {"name": "p", "graph": graph}
    j = JaxEngine(JaxSpec.from_dict(spec), components=comps(JaxComponent) if comps else None,
                  fuse=fuse, annotations=annotations)
    p = GraphEngine(PredictorSpec.from_dict(spec),
                    components=comps(SeldonComponent) if comps else None, fuse=fuse,
                    annotations=annotations, device="cpu")
    return j, p


def answers(j, p, body):
    return (j.predict_sync(JaxMessage.from_dict(body)).to_dict(),
            p.predict_sync(SeldonMessage.from_dict(body)).to_dict())


def fused_layout(engine):
    return {s.name: (s.fused_fn is not None, [u.name for u in s.fused_units])
            for s in engine.state.walk()}


# --------------------------------------------------------------- components
def doubler_echo(base):
    class Doubler(base):
        def transform_input(self, X, names, meta=None):
            return np.asarray(X) * 2

    class Echo(base):
        def predict(self, X, names, meta=None):
            return X

    return {"t": Doubler(), "m": Echo()}


def consts(base):
    class Const(base):
        def __init__(self, v):
            self.v = v

        def predict(self, X, names, meta=None):
            return np.full((1, 2), self.v)

    return {"m1": Const(1.0), "m2": Const(3.0)}


def pick_one(base):
    class PickOne(base):
        def route(self, X, names):
            return 1

    class Const(base):
        def __init__(self, v):
            self.v = v

        def predict(self, X, names, meta=None):
            return np.array([[self.v]])

    return {"r": PickOne(), "a": Const(10.0), "b": Const(20.0)}


def neg(base):
    class Neg(base):
        def transform_output(self, X, names, meta=None):
            return -np.asarray(X)

    return {"ot": Neg()}


def jit_double(base):
    class JitDouble(base):
        def transform_input(self, X, names, meta=None):
            return np.asarray(X) * 2

        def jax_fn(self):
            return (lambda p, x: x * 2), None

        def torch_fn(self):
            return (lambda p, x: x * 2), None

    return {"t": JitDouble()}


def tagged(base):
    class T1(base):
        def transform_input(self, X, names, meta=None):
            return X

        def tags(self):
            return {"from_t": 1}

    class M1(base):
        def predict(self, X, names, meta=None):
            return X

        def tags(self):
            return {"from_m": 2}

    return {"t": T1(), "m": M1()}


SIMPLE = {"type": "MODEL", "implementation": "SIMPLE_MODEL"}
AVERAGE = {"name": "combiner", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
           "children": [dict(SIMPLE, name="m1"), dict(SIMPLE, name="m2")]}
CHAIN = {"name": "t", "type": "TRANSFORMER", "children": [{"name": "m", "type": "MODEL"}]}

# (graph, components, request shape): the answering scenarios of
# tests/test_engine.py, each through both engines
SCENARIOS = {
    "simple model": ({"name": "m", **SIMPLE}, None, (1, 2)),
    "transformer chain": (CHAIN, doubler_echo, (1, 2)),
    "average combiner": ({**AVERAGE, "children": [{"name": "m1", "type": "MODEL"},
                                                  {"name": "m2", "type": "MODEL"}]},
                         consts, (1, 1)),
    "router branch": ({"name": "r", "type": "ROUTER",
                       "children": [{"name": "a", "type": "MODEL"},
                                    {"name": "b", "type": "MODEL"}]}, pick_one, (1, 1)),
    "output transformer": ({"name": "ot", "type": "OUTPUT_TRANSFORMER",
                            "children": [dict(SIMPLE, name="m")]}, neg, (1, 1)),
    "builtin combiner": (AVERAGE, None, (3, 2)),
    "fused chain": ({"name": "t", "type": "TRANSFORMER", "children": [dict(SIMPLE, name="m")]},
                    jit_double, (1, 1)),
    "tags merged": (CHAIN, tagged, (1, 1)),
    "leaf combiner": ({"name": "c", "type": "COMBINER", "implementation": "AVERAGE_COMBINER"},
                      None, (2, 2)),
    "combiner over chains": ({**AVERAGE, "children": [
        {"name": "t1", "type": "TRANSFORMER", "children": [dict(SIMPLE, name="m1")]},
        {"name": "t2", "type": "TRANSFORMER", "children": [dict(SIMPLE, name="m2")]}]},
        lambda base: {k: jit_double(base)["t"] for k in ("t1", "t2")}, (2, 3)),
}


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_answers_equal_jax(name, fuse):
    graph, comps, shape = SCENARIOS[name]
    j, p = build(graph, comps, fuse=fuse)
    assert fused_layout(p) == fused_layout(j)
    got_j, got_p = answers(j, p, tensor_body(shape, seed=len(name)))
    assert got_p == got_j
    fused_nodes = sum(s.fused_fn is not None for s in p.state.walk())
    assert p._fused_calls == (1 if fused_nodes else 0)


def test_puid_is_made_when_missing():
    j, p = build({"name": "m", **SIMPLE})
    body = tensor_body((1, 2))
    del body["meta"]
    got_j, got_p = answers(j, p, body)
    assert len(got_p["meta"].pop("puid")) == len(got_j["meta"].pop("puid")) == 32
    assert got_p == got_j
    assert got_p["meta"]["requestPath"] == {"m": "SimpleModel"}
    assert {m["key"] for m in got_p["meta"]["metrics"]} == {"mycounter", "mygauge", "mytimer"}


@pytest.mark.parametrize("case", ["fused", "leaf combiner", "fused chain"])
def test_fusion_layout(case):
    """The JAX suite's fusion cases: a builtin combiner fuses whole and
    answers as unfused; a leaf combiner is not fused (it averages the
    singleton [request]); a jittable transformer over SIMPLE_MODEL fuses,
    the leaf owning the class names."""
    graph = {"fused": AVERAGE, "leaf combiner": SCENARIOS["leaf combiner"][0],
             "fused chain": SCENARIOS["fused chain"][0]}[case]
    comps = jit_double if case == "fused chain" else None
    _, p = build(graph, comps, fuse=True)
    _, u = build(graph, comps, fuse=False)
    body = tensor_body((2, 2))
    fused = p.predict_sync(SeldonMessage.from_dict(body)).to_dict()
    unfused = u.predict_sync(SeldonMessage.from_dict(body)).to_dict()
    if case == "leaf combiner":
        assert p.state.root.fused_fn is None and p._fused_calls == 0
        assert fused["data"]["tensor"] == body["data"]["tensor"]
    else:
        assert p.state.root.fused_fn is not None and p._fused_calls == 1
        np.testing.assert_allclose(fused["data"]["tensor"]["values"],
                                   unfused["data"]["tensor"]["values"], rtol=1e-6)
        assert fused["meta"]["requestPath"] == unfused["meta"]["requestPath"]
        assert sorted(m["key"] for m in fused["meta"]["metrics"]) == \
            sorted(m["key"] for m in unfused["meta"]["metrics"])
    if case == "fused chain":
        assert fused["data"]["names"] == ["class0", "class1", "class2"]


@pytest.mark.parametrize("case", ["out of range", "fan-out without combiner"])
def test_graph_errors_equal_jax(case):
    if case == "out of range":
        def comps(base):
            class Bad(base):
                def route(self, X, names):
                    return 5
            return {"r": Bad()}
        graph = {"name": "r", "type": "ROUTER", "children": [dict(SIMPLE, name="a")]}
        j, p = build(graph, comps)
    else:
        graph = {"name": "root", **SIMPLE,
                 "children": [dict(SIMPLE, name="a"), dict(SIMPLE, name="b")]}
        j, p = build(graph, fuse=False)
    body = tensor_body((1, 1))
    with pytest.raises(JaxError) as want:
        j.predict_sync(JaxMessage.from_dict(body))
    with pytest.raises(SeldonError) as got:
        p.predict_sync(SeldonMessage.from_dict(body))
    assert (got.value.status_code, got.value.reason, got.value.message) == \
        (want.value.status_code, want.value.reason, want.value.message)
    assert ("branch 5" if case == "out of range" else "COMBINER") in got.value.message


def test_random_abtest_routes_both_ways_as_jax():
    graph = {"name": "ab", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
             "parameters": [{"name": "ratioA", "value": "0.5", "type": "FLOAT"},
                            {"name": "seed", "value": "11", "type": "INT"}],
             "children": [dict(SIMPLE, name="a"), dict(SIMPLE, name="b")]}
    j, p = build(graph)
    routes = []
    for i in range(50):
        got_j, got_p = answers(j, p, tensor_body((1, 1), seed=i, puid=f"r{i}"))
        assert got_p == got_j
        routes.append(got_p["meta"]["routing"]["ab"])
    assert set(routes) == {0, 1}


def recorders(base):
    class Rec(base):
        def __init__(self):
            self.fb = []

        def predict(self, X, names, meta=None):
            return X

        def send_feedback(self, features, names, reward, truth, routing=None):
            self.fb.append(reward)

    class R(base):
        def __init__(self):
            self.fb = []

        def route(self, X, names):
            return 0

        def send_feedback(self, features, names, reward, truth, routing=None):
            self.fb.append((reward, routing))

    return {"r": R(), "a": Rec(), "b": Rec()}


def test_feedback_replays_routed_branch_only_as_jax():
    graph = {"name": "r", "type": "ROUTER",
             "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
    jc, pc = recorders(JaxComponent), recorders(SeldonComponent)
    j = JaxEngine(JaxSpec.from_dict({"name": "p", "graph": graph}), components=jc)
    p = GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": graph}), components=pc,
                    device="cpu")
    fb = {"request": {"data": {"ndarray": [[1.0]]}},
          "response": {"data": {"ndarray": [[1.0]]}, "meta": {"routing": {"r": 1}}},
          "reward": 1.0}
    want = j.send_feedback_sync(JaxFeedback.from_dict(fb)).to_dict()
    assert p.send_feedback_sync(Feedback.from_dict(fb)).to_dict() == want
    assert [c.fb for c in pc.values()] == [c.fb for c in jc.values()] == \
        [[(1.0, 1)], [], [1.0]]


def sneaky(base, calls):
    async def _apredict(X):
        await asyncio.sleep(0)  # a real suspension point
        return X + 1

    class Upstream(base):
        def transform_input(self, X, names, meta=None):
            calls["upstream"] += 1
            return X

    class SneakyAsync(base):
        def predict(self, X, names, meta=None):
            return _apredict(X)  # a sync def returning an awaitable

    return {"t": Upstream(), "m": SneakyAsync()}


def test_degrade_to_async_fires_exactly_once_as_jax():
    results = {}
    for side, (base, engine_cls, spec_cls, msg_cls) in {
            "jax": (JaxComponent, JaxEngine, JaxSpec, JaxMessage),
            "port": (SeldonComponent, GraphEngine, PredictorSpec, SeldonMessage)}.items():
        calls = {"upstream": 0, "degrade": 0}
        kw = {} if side == "jax" else {"device": "cpu"}
        engine = engine_cls(spec_cls.from_dict({"name": "p", "graph": CHAIN}),
                            components=sneaky(base, calls), fuse=False, **kw)
        assert engine.has_async_nodes is False
        original = engine._degrade_to_async

        def counting(op, _orig=original, _calls=calls):
            _calls["degrade"] += 1
            _orig(op)

        engine._degrade_to_async = counting
        outs = [engine.predict_sync(msg_cls.from_dict(tensor_body((1, 1), seed=s, puid="d")))
                .to_dict() for s in (0, 1)]
        results[side] = (outs, dict(calls), engine.has_async_nodes)
    assert results["port"] == results["jax"]
    assert results["port"][1] == {"upstream": 3, "degrade": 1} and results["port"][2]


def test_feedback_sync_degrades_on_missed_async_component():
    delivered = []

    async def _afeedback(reward):
        await asyncio.sleep(0)
        delivered.append(reward)

    class SneakyFeedback(SeldonComponent):
        def predict(self, X, names, meta=None):
            return X

        def send_feedback(self, features, feature_names, reward, truth, routing=None):
            return _afeedback(reward)

    engine = GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": {"name": "m",
                                                                         "type": "MODEL"}}),
                         components={"m": SneakyFeedback()}, fuse=False, device="cpu")
    engine.send_feedback_sync(Feedback(request=SeldonMessage.from_dict(tensor_body((1, 1))),
                                       reward=0.5))
    assert engine.has_async_nodes is True and delivered and set(delivered) == {0.5}
    engine.send_feedback_sync(Feedback(request=SeldonMessage.from_dict(tensor_body((1, 1))),
                                       reward=1.0))
    assert delivered[-1] == 1.0


def test_deadline_spent_before_a_node_is_504():
    """A budget spent before the root node answers 504 on both engines; a
    node that spends it stops its subtree."""
    def comps(base):
        class Slow(base):
            def transform_input(self, X, names, meta=None):
                time.sleep(0.03)
                return X

        class Echo(base):
            def __init__(self):
                self.calls = 0

            def predict(self, X, names, meta=None):
                self.calls += 1
                return X

        return {"t": Slow(), "m": Echo()}

    for engine, deadline, msg, err in (
            (JaxEngine(JaxSpec.from_dict({"name": "p", "graph": CHAIN}), components=comps(
                JaxComponent)), JaxDeadline, JaxMessage, JaxError),
            (GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": CHAIN}),
                         components=comps(SeldonComponent), device="cpu"), Deadline,
             SeldonMessage, SeldonError)):
        with pytest.raises(err) as e:
            asyncio.run(engine.predict(msg.from_dict(tensor_body((1, 1))),
                                       deadline=deadline.from_ms(10)))
        assert (e.value.status_code, e.value.reason) == (504, "DEADLINE_EXCEEDED")
        assert "node m" in e.value.message
        assert engine.state.unit_by_name("m").component.calls == 0


def test_breaker_reroutes_away_from_a_failing_async_branch_as_jax():
    """Async nodes get breakers: after two failures the router's branch is
    open and the router reroutes to the healthy sibling, tagging the
    response, as the JAX engine does."""
    def comps(base):
        class Flaky(base):
            is_async = True

            async def predict(self, X, names, meta=None):
                raise SeldonError("down", status_code=500) if base is SeldonComponent \
                    else JaxError("down", status_code=500)

        class Ok(base):
            is_async = True

            async def predict(self, X, names, meta=None):
                return np.asarray(X) + 1

        class First(base):
            def route(self, X, names):
                return 0

        return {"r": First(), "a": Flaky(), "b": Ok()}

    graph = {"name": "r", "type": "ROUTER",
             "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
    ann = {"seldon.io/circuit-breaker-max-failures": "2"}
    j, p = build(graph, comps, annotations=ann)
    assert [n for n, _ in p.breakers()] == [n for n, _ in j.breakers()] == ["a", "b"]
    for i in range(2):
        body = tensor_body((1, 1), seed=i)
        with pytest.raises(JaxError):
            j.predict_sync(JaxMessage.from_dict(body))
        with pytest.raises(SeldonError) as e:
            p.predict_sync(SeldonMessage.from_dict(body))
        assert e.value.status_code == 500
    got_j, got_p = answers(j, p, tensor_body((1, 1), seed=5))
    assert got_p == got_j
    assert got_p["meta"]["tags"]["seldon.io/rerouted"] == {"r": {"from": 0, "to": 1}}
    assert [b.state_code() for _, b in p.breakers()] == [2, 0]


@pytest.mark.parametrize("case", ["replica list", "remote endpoint", "outlier detector",
                                  "sklearn server"])
def test_later_slices_raise(case, tmp_path):
    """What a later slice serves raises naming it; the remote-node slice's
    cases now build (a list is one cached ReplicaSet, an endpoint a
    RemoteComponent, SKLEARN_SERVER loads its artifact), and the frame wire
    format of a remote hop still raises naming the native-edge slice; all
    four outlier detector units build (the analytics slice), and an
    unfitted VAE raises "needs fit()" at its first score, as JAX's does."""
    from seldon_core_tpu_torch.runtime.engine import ReplicaSet
    from seldon_core_tpu_torch.runtime.remote import RemoteComponent

    graph = {"name": "m", "type": "MODEL"}
    spec = lambda: PredictorSpec.from_dict({"name": "p", "graph": graph})  # noqa: E731
    if case == "replica list":
        eng = GraphEngine(spec(), components={"m": [object(), object()]}, device="cpu")
        assert isinstance(eng._components["m"], ReplicaSet)
        assert eng.state.root.component is eng._components["m"]
        return
    if case == "remote endpoint":
        graph["endpoint"] = {"service_host": "127.0.0.1", "service_port": 9, "type": "REST"}
        eng = GraphEngine(spec(), device="cpu")
        assert isinstance(eng.state.root.component, RemoteComponent) and eng.has_async_nodes
        with pytest.raises(NotImplementedError, match="native-edge slice"):
            GraphEngine(spec(), annotations={"seldon.io/wire-format": "frame"}, device="cpu")
        return
    if case == "outlier detector":
        from seldon_core_tpu_torch.analytics import outliers

        graph["type"] = "TRANSFORMER"
        for impl, cls in (("MAHALANOBIS_OD", outliers.MahalanobisOutlierDetector),
                          ("ISOLATION_FOREST_OD", outliers.IsolationForestOutlierDetector),
                          ("VAE_OD", outliers.VAEOutlierDetector),
                          ("SEQ2SEQ_OD", outliers.Seq2SeqOutlierDetector)):
            graph["implementation"] = impl
            unit = GraphEngine(spec(), device="cpu").state.root.component
            assert isinstance(unit, cls)
            if impl in ("MAHALANOBIS_OD", "VAE_OD", "SEQ2SEQ_OD"):
                assert unit.device == torch.device("cpu")
        graph["implementation"] = "VAE_OD"
        jax_unit = JaxEngine(JaxSpec.from_dict({"name": "p", "graph": graph})).state.root.component
        body = {"data": {"ndarray": [[1.0, 2.0]]}}
        with pytest.raises(Exception, match="needs fit") as port_err:
            GraphEngine(spec(), device="cpu").predict_sync(SeldonMessage.from_dict(body))
        with pytest.raises(Exception, match="needs fit") as jax_err:
            jax_unit.transform_input(np.array([[1.0, 2.0]]), [])
        assert "VAEOutlierDetector needs fit() before scoring" in str(port_err.value)
        assert "VAEOutlierDetector needs fit() before scoring" in str(jax_err.value)
        return
    graph["implementation"] = "SKLEARN_SERVER"
    graph["modelUri"] = str(tmp_path)  # no model.joblib in it
    with pytest.raises(SeldonError, match="sklearn model file not found"):
        GraphEngine(spec(), device="cpu")


def test_default_device_and_env_spec(monkeypatch):
    spec = {"name": "p", "graph": {"name": "m", **SIMPLE}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GraphEngine(PredictorSpec.from_dict(spec))
    import base64

    raw = base64.b64encode(json.dumps(spec).encode()).decode()
    got = load_predictor_spec_from_env({"ENGINE_PREDICTOR": raw})
    assert got.to_dict() == JaxSpec.from_dict(spec).to_dict()
    assert load_predictor_spec_from_env({"ENGINE_PREDICTOR_FILE": "/nonexistent"}) is None


# ------------------------------------------------------ JAX_SERVER leaves
def _live(variables, seed):
    """Redraw every BatchNorm's scale, bias and statistics so that the
    folded residual branches are live (a fresh init zeroes them)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, variables)

    def walk(p, s):
        for k in sorted(p):
            if isinstance(p[k], dict) and "scale" in p[k]:
                n = p[k]["scale"].shape
                p[k] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(tree["params"], tree["batch_stats"])
    return tree


@pytest.fixture(scope="module")
def resnet_graph(tmp_path_factory):
    """An AVERAGE_COMBINER over two JAX_SERVER units, each a live folded
    ResNet-18 checkpoint (64x64, 10 classes) written by the JAX package."""
    raw = jax.jit(jax_get_model("resnet18", num_classes=10).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    children = []
    for name, seed in (("a", 1), ("b", 2)):
        folded = jax.tree.map(np.asarray, jax_fold_batchnorm(_live(raw, seed)))
        assert all(np.abs(folded["params"][f"BottleneckBlock_{i}"]["Conv_2"]["kernel"]).max() > 0
                   for i in range(8))
        path = str(tmp_path_factory.mktemp(f"resnet18-{name}"))
        jax_export(path, "resnet18", folded, kwargs={"num_classes": 10, "fused": True},
                   input_shape=[64, 64, 3], use_orbax=False)
        children.append({"name": name, "type": "MODEL", "implementation": "JAX_SERVER",
                         "modelUri": path})
    return {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
            "children": children}


def logits_of(d):
    t = d["data"]["tensor"]
    return np.asarray(t["values"], np.float64).reshape(t["shape"])


def test_jax_server_leaves_fused_and_unfused(resnet_graph):
    spec = {"name": "p", "graph": resnet_graph}
    fused = GraphEngine(PredictorSpec.from_dict(spec), device="cpu")
    unfused = GraphEngine(PredictorSpec.from_dict(spec), fuse=False, device="cpu")
    jfused = JaxEngine(JaxSpec.from_dict(spec))  # its layout only: never run
    junfused = JaxEngine(JaxSpec.from_dict(spec), fuse=False)
    assert fused_layout(fused) == fused_layout(jfused) == {
        "avg": (True, ["avg", "a", "b"]), "a": (False, []), "b": (False, [])}
    assert fused_layout(unfused) == fused_layout(junfused)
    body = tensor_body((2, 64, 64, 3), seed=3)
    want = junfused.predict_sync(JaxMessage.from_dict(body)).to_dict()
    got = fused.predict_sync(SeldonMessage.from_dict(body)).to_dict()
    plain = unfused.predict_sync(SeldonMessage.from_dict(body)).to_dict()
    assert fused._fused_calls == 1 and unfused._fused_calls == 0
    ref = logits_of(want)
    bound = FWD_TOL * np.abs(ref).max()
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > bound
    for d in (got, plain):
        g = logits_of(d)
        assert g.shape == ref.shape == (2, 10) and np.isfinite(g).all()
        assert np.abs(g - ref).max() <= bound
        assert np.all((g.argmax(-1) == ref.argmax(-1))[clear])
        # meta and names equal but for the server's class name in requestPath
        meta = dict(d["meta"], requestPath={k: v.replace("TorchServer", "JAXServer")
                                            for k, v in d["meta"]["requestPath"].items()})
        assert meta == want["meta"] and d["data"]["names"] == want["data"]["names"]
    assert np.abs(logits_of(got) - logits_of(plain)).max() <= FUSE_TOL * np.abs(ref).max()


def test_allow_partial_drops_an_open_branch_as_jax():
    """With ``seldon.io/allow-partial``, a combiner over async branches
    drops the one whose breaker is open and tags the response partial;
    with every branch open it answers 503 CIRCUIT_OPEN; as the JAX engine."""
    def comps(base):
        err = SeldonError if base is SeldonComponent else JaxError

        class Down(base):
            is_async = True

            async def predict(self, X, names, meta=None):
                raise err("down", status_code=500)

        class Up(base):
            is_async = True

            async def predict(self, X, names, meta=None):
                return np.asarray(X) * 3

        return {"a": Down(), "b": Up()}

    graph = {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
             "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
    ann = {"seldon.io/circuit-breaker-max-failures": "1", "seldon.io/allow-partial": "true"}
    j, p = build(graph, comps, annotations=ann)
    body = tensor_body((1, 2))
    with pytest.raises(JaxError):
        j.predict_sync(JaxMessage.from_dict(body))
    with pytest.raises(SeldonError):
        p.predict_sync(SeldonMessage.from_dict(body))
    got_j, got_p = answers(j, p, body)
    assert got_p == got_j
    assert got_p["meta"]["tags"] == {"seldon.io/partial-response": True,
                                     "seldon.io/dropped-branches": ["a"]}
    for engine in (j, p):
        engine.state.unit_by_name("b").breaker.trip()
    with pytest.raises(JaxError) as want:
        j.predict_sync(JaxMessage.from_dict(body))
    with pytest.raises(SeldonError) as got:
        p.predict_sync(SeldonMessage.from_dict(body))
    assert (got.value.status_code, got.value.reason, got.value.message) == \
        (want.value.status_code, want.value.reason, want.value.message) == \
        (503, "CIRCUIT_OPEN", got.value.message)


def test_router_observes_routed_outcomes_as_jax():
    """A router with ``observe_outcome(branch, latency_s, error)`` sees each
    routed request's branch and error on the engine's clock."""
    def comps(base):
        err = SeldonError if base is SeldonComponent else JaxError

        class Observed(base):
            def __init__(self):
                self.seen, self.n = [], 0

            def route(self, X, names):
                self.n += 1
                return self.n % 2

            def observe_outcome(self, branch, latency_s, error=False):
                self.seen.append((branch, latency_s, error))

        class Fails(base):
            def predict(self, X, names, meta=None):
                raise err("bad input", status_code=400)

        return {"r": Observed(), "b": Fails()}

    graph = {"name": "r", "type": "ROUTER",
             "children": [dict(SIMPLE, name="a"), {"name": "b", "type": "MODEL"}]}
    seen = []
    for engine_cls, spec_cls, msg, err, base, kw in (
            (JaxEngine, JaxSpec, JaxMessage, JaxError, JaxComponent, {}),
            (GraphEngine, PredictorSpec, SeldonMessage, SeldonError, SeldonComponent,
             {"device": "cpu"})):
        clock = iter(range(100)).__next__
        config = (ResilienceConfig if base is SeldonComponent else JaxConfig)(clock=clock)
        engine = engine_cls(spec_cls.from_dict({"name": "p", "graph": graph}),
                            components=comps(base), resilience=config, **kw)
        for i in range(4):
            try:
                engine.predict_sync(msg.from_dict(tensor_body((1, 1), seed=i)))
            except err:
                pass
        seen.append(engine.state.root.component.seen)
    assert seen[1] == seen[0] == [(1, 1, True), (0, 1, False), (1, 1, True), (0, 1, False)]
