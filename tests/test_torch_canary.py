"""The port's canary router, shadow node and Mahalanobis detector
(``seldon_core_tpu_torch/analytics/{canary,outliers}.py``) held against the
JAX package's on the CPU:

- the Mahalanobis scores, ``score_frozen`` and the running state (mean,
  covariance, clipped count) equal the JAX package's within 2e-5 relative
  (float32 on both sides) across the row buckets (1, 16, 256 and past the
  top), with ``n_components`` and ``n_clip``, after ``reset_stats`` and
  across a pickle round trip (the state pickles as numpy); the
  transformer surface (features through, tags, metrics, ``row_slice``)
  gives the same values, and a ``MAHALANOBIS_OD`` unit of a graph spec
  serves through the port's engine with the JAX engine's tags;
- ``canary_split`` and ``evaluate_canary`` equal on scripted windows;
- the engine scenarios of ``tests/test_canary.py`` on a FaultClock run
  through both engines request by request with equal routing, phases,
  rollback reasons and stats, and no request fails;
- the shadow cases: mirrors, divergence, swallowed failures, the latency
  delta on the clock, token lists through ``generate``, in a graph.
"""

import asyncio
import pickle

import numpy as np
import pytest

from seldon_core_tpu.analytics import canary as jax_canary
from seldon_core_tpu.analytics.outliers import MahalanobisOutlierDetector as JaxDetector
from seldon_core_tpu.components.component import SeldonComponent as JaxComponent
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import Feedback as JaxFeedback
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.runtime.resilience import ResilienceConfig as JaxResilience
from seldon_core_tpu.testing import faults as jax_faults
from seldon_core_tpu_torch.analytics import canary
from seldon_core_tpu_torch.analytics.outliers import MahalanobisOutlierDetector
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import PredictorSpec
from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonMessage
from seldon_core_tpu_torch.runtime.engine import GraphEngine
from seldon_core_tpu_torch.runtime.resilience import ResilienceConfig
from seldon_core_tpu_torch.testing import faults

RTOL, ATOL = 2e-5, 1e-6
X = np.array([[1.0]])


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=RTOL, atol=ATOL)


def state_of(det):
    return [np.asarray(s.cpu() if hasattr(s, "cpu") else s, np.float64) for s in det._state]


# --------------------------------------------------------------- detector
@pytest.mark.parametrize("d,n_components,n_clip", [(1, 0, 1000), (4, 0, 50), (6, 3, 1000)])
def test_mahalanobis_equals_jax_across_buckets_reset_and_pickle(d, n_components, n_clip):
    rng = np.random.default_rng(d)
    kw = dict(threshold=3.0, n_components=n_components, n_clip=n_clip)
    j, p = JaxDetector(**kw), MahalanobisOutlierDetector(device="cpu", **kw)
    for rows in (1, 5, 16, 17, 256, 300, 3, 40):
        Xb = rng.normal(size=(rows, d)) * 2.0 + 1.0
        close(p.score(Xb), j.score(Xb))
        for a, b in zip(state_of(p), state_of(j)):
            close(a, b)
    Xf = rng.normal(size=(9, d)) * 4.0
    before = state_of(p)
    close(p.score_frozen(Xf), j.score_frozen(Xf))
    for a, b in zip(state_of(p), before):
        np.testing.assert_array_equal(a, b)          # frozen: nothing folded
    p2, j2 = pickle.loads(pickle.dumps(p)), pickle.loads(pickle.dumps(j))
    assert all(isinstance(s, np.ndarray) for s in p.__getstate__()["_state"])
    assert p2.device == p.device
    close(p2.score(Xf), j2.score(Xf))
    for a, b in zip(state_of(p2), state_of(j2)):
        close(a, b)
    p.reset_stats(), j.reset_stats()
    for a, b in zip(state_of(p), state_of(j)):
        np.testing.assert_array_equal(a, b)
    close(p.score(Xf), j.score(Xf))


def test_transformer_surface_equals_jax():
    rng = np.random.default_rng(7)
    j, p = JaxDetector(threshold=1.5), MahalanobisOutlierDetector(threshold=1.5, device="cpu")
    assert p.tags() == j.tags() == {} and p.metrics() == j.metrics() == []
    for rows in (12, 5):
        Xb = rng.normal(size=(rows, 3))
        assert p.transform_input(Xb, ["a", "b", "c"]) is Xb
        j.transform_input(Xb, ["a", "b", "c"])
        assert p.tags()["is_outlier"] == j.tags()["is_outlier"]
        close(p.tags()["outlier_score"], j.tags()["outlier_score"])
        pt, pm = p.row_slice(1, 4)
        jt, jm = j.row_slice(1, 4)
        assert pt["is_outlier"] == jt["is_outlier"]
        assert [m["key"] for m in pm] == [m["key"] for m in jm]
        close([m["value"] for m in pm], [m["value"] for m in jm])
    assert p.row_slice(0, 99) == j.row_slice(0, 99) == ({}, [])


def test_mahalanobis_unit_serves_through_the_engine():
    spec = {"name": "p", "graph": {
        "name": "od", "type": "TRANSFORMER", "implementation": "MAHALANOBIS_OD",
        "parameters": [{"name": "threshold", "value": "2.5", "type": "FLOAT"}],
        "children": [{"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}}
    p, j = GraphEngine(PredictorSpec.from_dict(spec), device="cpu"), JaxEngine(
        JaxSpec.from_dict(spec))
    det = p.state.root.component
    assert isinstance(det, MahalanobisOutlierDetector) and det.threshold == 2.5
    rng = np.random.default_rng(3)
    for _ in range(3):
        body = {"data": {"ndarray": rng.normal(size=(4, 2)).tolist()}}
        got = p.predict_sync(SeldonMessage.from_dict(body)).to_dict()
        want = asyncio.run(j.predict(JaxMessage.from_dict(body))).to_dict()
        assert got["data"] == want["data"]
        assert got["meta"]["tags"]["is_outlier"] == want["meta"]["tags"]["is_outlier"]
        close(got["meta"]["tags"]["outlier_score"], want["meta"]["tags"]["outlier_score"])


def test_detector_default_device_is_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MahalanobisOutlierDetector()
    with pytest.raises(RuntimeError, match="cuda"):
        canary.CanaryRouter()


# ---------------------------------------------------------- decision math
@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 1 / 3, 0.5, 0.9, 1.0])
def test_canary_split_equals_jax(fraction):
    seq = [canary.canary_split(n, fraction) for n in range(300)]
    assert seq == [jax_canary.canary_split(n, fraction) for n in range(300)]


WINDOWS = {
    "latency degradation": ([0.01] * 16, [0.5] * 8, [], []),
    "parity": ([0.01] * 16, [0.01] * 8, [0] * 16, [0] * 8),
    "error excess": ([0.01] * 16, [0.01] * 8, [0] * 16, [1] * 8),
    "below min samples": ([0.01] * 16, [9.9] * 3, [], []),
    "spread baseline, mild candidate": (list(np.linspace(0.01, 0.05, 16)), [0.04] * 8, [], []),
    "half outliers": ([0.01, 0.02] * 8, [0.015, 0.9] * 4, [0, 1] * 8, [0, 1] * 4),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_evaluate_canary_equals_jax(case):
    base, cand, be, ce = WINDOWS[case]
    j, p = JaxDetector(threshold=3.0), MahalanobisOutlierDetector(threshold=3.0, device="cpu")
    j.score(np.asarray(base)[:, None])
    p.score(np.asarray(base)[:, None])
    kw = dict(min_samples=8, outlier_fraction=0.5, max_error_rate_excess=0.2)
    assert canary.evaluate_canary(base, cand, be, ce, p, **kw) == \
        jax_canary.evaluate_canary(base, cand, be, ce, j, **kw)


# ------------------------------------------------------- engine scenarios
class Echo(SeldonComponent):
    def predict(self, X, names, meta=None):
        return X


class JaxEcho(JaxComponent):
    def predict(self, X, names, meta=None):
        return X


SIDES = {
    "jax": dict(canary=jax_canary, faults=jax_faults, Engine=JaxEngine, Spec=JaxSpec,
                Message=JaxMessage, Feedback=JaxFeedback, Resilience=JaxResilience, Echo=JaxEcho,
                router_kw={}, engine_kw={}),
    "port": dict(canary=canary, faults=faults, Engine=GraphEngine, Spec=PredictorSpec,
                 Message=SeldonMessage, Feedback=Feedback, Resilience=ResilienceConfig,
                 Echo=Echo, router_kw={"device": "cpu"}, engine_kw={"device": "cpu"}),
}
MSG = {"data": {"tensor": {"shape": [1, 1], "values": [1.0]}}}


def canary_engine(S, router, candidate, clock):
    graph = {"name": "cr", "type": "ROUTER", "children": [
        {"name": "base", "type": "MODEL"}, {"name": "cand", "type": "MODEL"}]}
    return S["Engine"](S["Spec"].from_dict({"name": "p", "graph": graph}),
                       components={"cr": router, "base": S["Echo"](), "cand": candidate},
                       resilience=S["Resilience"](clock=clock), **S["engine_kw"])


def drive(S, router_kw, latency_s, n, after=0, stop_at=None):
    """``n`` predicts (stopping once the phase is ``stop_at``), then
    ``after`` more: per request (branch, phase, reason), the candidate's
    calls, the stats."""
    fc = S["faults"]
    clock = fc.FaultClock()
    router = S["canary"].CanaryRouter(**router_kw, **S["router_kw"])
    cand = fc.FaultyComponent(fc.FaultSchedule.always_ok(latency_s=latency_s), clock=clock)
    engine = canary_engine(S, router, cand, clock)
    trace = []
    for i in range(n + after):
        out = asyncio.run(engine.predict(S["Message"].from_dict(MSG)))
        assert out.data is not None        # no request fails
        trace.append((out.meta.routing["cr"], router.phase, router.rollback_reason))
        if i < n and stop_at is not None and router.phase == stop_at:
            n = i + 1
            trace.append("stop")
    return trace, cand.calls, router.canary_stats(), router.evaluations_total


SCENARIOS = {
    "rollback on latency": (dict(fraction=0.25, min_samples=4, eval_every=4,
                                 outlier_fraction=0.5), 0.5, 40, 20, "rolled_back"),
    "holds on a healthy candidate": (dict(fraction=0.25, min_samples=4, eval_every=4), 0.0, 40,
                                     0, None),
    "promotion": (dict(fraction=0.5, min_samples=2, eval_every=2, promote_after=3), 0.0, 30, 5,
                  "promoted"),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_scenarios_equal_jax(scenario):
    kw, latency, n, after, stop_at = SCENARIOS[scenario]
    got = drive(SIDES["port"], kw, latency, n, after, stop_at)
    want = drive(SIDES["jax"], kw, latency, n, after, stop_at)
    assert got == want
    trace, calls, stats, evals = got
    assert evals >= 1
    if stop_at == "rolled_back":
        i = trace.index("stop")
        assert all(t[0] == canary.BASELINE for t in trace[i + 1:])
        assert stats["canary_rollbacks_total"] == 1 and stats["canary_phase_code"] == 2
        assert "outlier" in trace[-1][2]
    elif stop_at == "promoted":
        i = trace.index("stop")
        assert all(t[0] == canary.CANDIDATE for t in trace[i + 1:])
    else:
        assert stats["canary_phase"] == canary.CANARY


def test_feedback_paths_equal_jax():
    def side(S):
        c = S["canary"]
        r = c.CanaryRouter(fraction=0.5, min_samples=4, eval_every=2,
                           max_error_rate_excess=0.2, **S["router_kw"])
        for _ in range(8):
            r.send_feedback(X, [], 1.0, None, routing=c.BASELINE)
        for _ in range(8):
            r.send_feedback(X, [], 0.0, None, routing=c.CANDIDATE)
        # over the engine's feedback replay path
        r2 = c.CanaryRouter(fraction=0.5, min_samples=3, eval_every=1,
                            max_error_rate_excess=0.2, **S["router_kw"])
        engine = canary_engine(S, r2, S["Echo"](), S["faults"].FaultClock())
        phases = []
        for branch, reward in ((0, 1.0), (0, 1.0), (0, 1.0), (1, 0.0), (1, 0.0), (1, 0.0)):
            fb = S["Feedback"].from_dict({"request": {"data": {"ndarray": [[1.0]]}},
                                          "response": {"meta": {"routing": {"cr": branch}}},
                                          "reward": reward})
            asyncio.run(engine.send_feedback(fb))
            phases.append((r2.phase, r2.rollback_reason))
        return (r.phase, r.rollback_reason, r.pulls.tolist(), r.fail_sum.tolist(),
                r.canary_stats(), phases)

    got, want = side(SIDES["port"]), side(SIDES["jax"])
    assert got == want
    assert got[0] == canary.ROLLED_BACK and "error rate" in got[1]
    assert got[-1][-1][0] == canary.ROLLED_BACK


def test_router_surfaces_equal_jax():
    def side(S):
        c = S["canary"]
        r = c.CanaryRouter(fraction=0.5, min_samples=1000, **S["router_kw"])
        routes = [r.route(X, []) for _ in range(20)]
        r.rollback("operator said so")
        routes += [r.route(X, []) for _ in range(5)]
        sustained = c.CanaryRouter(fraction=0.5, min_samples=16, eval_every=2,
                                   outlier_fraction=0.5, **S["router_kw"])
        for _ in range(16):
            sustained.observe_outcome(c.BASELINE, 0.01)
            sustained.observe_outcome(c.CANDIDATE, 0.5)
        live = c.CanaryRouter(fraction=0.5, window=8, min_samples=10_000, **S["router_kw"])
        for _ in range(2000):
            live.observe_outcome(c.BASELINE, 0.01)
        return (routes, r.tags(), r.canary_stats(), sustained.phase,
                sustained.rollback_reason, len(live._baseline_unfolded))

    got, want = side(SIDES["port"]), side(SIDES["jax"])
    assert got == want
    assert got[0][:20].count(canary.CANDIDATE) == 10 and got[3] == canary.ROLLED_BACK


def test_client_cancellation_is_not_a_branch_error():
    fc = faults
    clock = fc.FaultClock()
    router = canary.CanaryRouter(fraction=1.0, min_samples=2, eval_every=1,
                                 max_error_rate_excess=0.1, device="cpu")
    cancel = fc.FaultyComponent(fc.FaultSchedule([fc.FaultSpec(error=asyncio.CancelledError())]),
                                clock=clock)
    engine = canary_engine(SIDES["port"], router, cancel, clock)
    for _ in range(6):
        with pytest.raises(asyncio.CancelledError):
            asyncio.run(engine.predict(SeldonMessage.from_dict(MSG)))
    assert list(router._err[canary.CANDIDATE]) == [] and router.phase == canary.CANARY


# ------------------------------------------------------------------ shadow
class Doubler(SeldonComponent):
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2


class Crasher(SeldonComponent):
    def predict(self, X, names, meta=None):
        raise RuntimeError("shadow boom")

    def generate(self, *a, **kw):
        raise RuntimeError("shadow boom")


class Gen(SeldonComponent):
    def __init__(self, toks):
        super().__init__()
        self.toks = toks

    def generate(self, prompts=None, **kw):
        return [list(self.toks)]


def test_shadow_mirrors_and_records_divergence():
    node = canary.ShadowNode(Echo(), Doubler(), mirror_fraction=0.5, clock=faults.FaultClock())
    for _ in range(10):
        assert np.array_equal(node.predict(X, ["a"]), X)
    stats = node.shadow_stats()
    assert (stats["shadow_mirrors_total"], stats["shadow_divergences_total"],
            stats["shadow_errors_total"]) == (5, 5, 0)
    assert stats["shadow_max_abs_diff"] == pytest.approx(1.0)
    assert node.tags() == {"shadowing": "Doubler", "shadow_mirrors": 5, "shadow_divergences": 5}


@pytest.mark.parametrize("method", ["predict", "generate"])
def test_shadow_failure_never_reaches_the_client(method):
    primary = Echo() if method == "predict" else Gen([1, 2])
    node = canary.ShadowNode(primary, Crasher(), mirror_fraction=1.0, clock=faults.FaultClock())
    for _ in range(5):
        out = node.predict(X, ["a"]) if method == "predict" else node.generate(prompts=[[5]])
        assert out is not None
    stats = node.shadow_stats()
    assert stats["shadow_errors_total"] == 5 and stats["shadow_divergences_total"] == 0


def test_shadow_latency_delta_on_the_clock():
    clock = faults.FaultClock()

    class SlowSync(SeldonComponent):
        def predict(self, X, names, meta=None):
            clock.advance(0.3)
            return X

    node = canary.ShadowNode(Echo(), SlowSync(), mirror_fraction=1.0, clock=clock)
    node.predict(X, ["a"])
    stats = node.shadow_stats()
    assert stats["shadow_latency_delta_s_sum"] == pytest.approx(0.3)
    assert stats["shadow_divergences_total"] == 0


def test_shadow_generate_compares_token_lists():
    node = canary.ShadowNode(Gen([1, 2, 3]), Gen([1, 2, 4]), mirror_fraction=1.0,
                             clock=faults.FaultClock())
    assert node.generate(prompts=[[5]]) == [[1, 2, 3]]
    assert node.shadow_stats()["shadow_divergences_total"] == 1
    same = canary.ShadowNode(Gen([7]), Gen([7]), mirror_fraction=1.0, clock=faults.FaultClock())
    same.generate(prompts=[[5]])
    assert same.shadow_stats()["shadow_divergences_total"] == 0


def test_shadow_in_an_engine_graph_equals_jax():
    graph = {"name": "sh", "type": "MODEL"}
    node = canary.ShadowNode(Echo(), Doubler(), mirror_fraction=1.0, clock=faults.FaultClock())
    engine = GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                         components={"sh": node}, device="cpu")

    # named as the port's shadow class: the tags carry the class name
    jax_doubler = type("Doubler", (JaxComponent,), {"predict": Doubler.predict})
    jnode = jax_canary.ShadowNode(JaxEcho(), jax_doubler(), mirror_fraction=1.0,
                                  clock=jax_faults.FaultClock())
    jengine = JaxEngine(JaxSpec.from_dict({"name": "p", "graph": graph}), components={"sh": jnode})
    got = asyncio.run(engine.predict(SeldonMessage.from_dict(MSG))).to_dict()
    want = asyncio.run(jengine.predict(JaxMessage.from_dict(MSG))).to_dict()
    assert got["data"] == want["data"] and got["data"]["tensor"]["values"] == [1.0]
    assert got["meta"]["tags"] == want["meta"]["tags"]
    assert node.shadow_stats() == jnode.shadow_stats()
