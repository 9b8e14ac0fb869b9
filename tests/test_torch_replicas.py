"""The port's replica fleet (``seldon_core_tpu_torch/runtime/engine.py``
``ReplicaSet``, ``replica_load``) held against the JAX package's on the CPU,
tiny float32 LLMs whose port replicas carry the JAX servers' weights
(``load(params=...)``):

- least-loaded dispatch with the lowest index on ties, and ``llm_stats``
  merged (counters sum, fractions average, lists concatenate), as JAX's
  on the same fakes (JAX ``tests/test_disagg.py:514-590``); a list of
  components under one unit is one cached ReplicaSet in both engines;
- prefix-aware dispatch: the replica whose trie holds the prompt wins, a
  cold prompt goes to the lowest index, ``generate()`` routes and gives the
  replica's tokens (JAX ``tests/test_radix.py:389-425``, slow there; tiny
  and unmarked here); the port's fleet tokens equal the JAX fleet's;
- membership: add, drain (newest first, never the last serving one),
  collect after two consecutive idle sightings, a late submit resetting the
  grace, all-draining fallback: the same outcomes as JAX's ReplicaSet on the
  same stubs (the ReplicaSet parts of JAX ``tests/test_autoscaler.py:172``,
  ``:211``, ``:289``); with real replicas, a drained replica finishes its
  in-flight request, takes no new traffic, and detaches only once idle;
- transports: ``/v1/generate`` (JSON and SSE) and gRPC
  ``Model/GenerateStream`` on a component app serving a fleet reach the
  replicas' batchers (``get_batcher_service`` returns the fleet) with the
  replicas' tokens; the fleet app's scrape reads the merged ``llm_stats``.

Tokens, routes, picks and membership are exact.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax

from seldon_core_tpu.components.component import SeldonComponent as JaxComponent
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.batcher import BatcherService as JaxBatcherService
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.runtime.engine import ReplicaSet as JaxReplicaSet
from seldon_core_tpu.runtime.engine import replica_load as jax_replica_load
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import PredictorSpec
from seldon_core_tpu_torch.contracts.payload import SeldonMessage
from seldon_core_tpu_torch.runtime.batcher import BatcherService, get_batcher_service
from seldon_core_tpu_torch.runtime.engine import GraphEngine, ReplicaSet, replica_load
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=6, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3)
PROMPT = [9, 8, 7, 6, 5, 4, 3, 2, 1]
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def jax_weights():
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    return j, {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}


def port_server(params, **extra):
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


def jax_server(jax_weights, **extra):
    s = JaxLLMServer(init_random=True, **dict(COMMON, **extra))
    s.load()
    s._params = jax_weights[0]._params
    return s


# ---------------------------------------------------------------- fakes
def fake_class(base):
    class Fake(base):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def llm_stats(self):
            return {"tokens_generated": 10, "kv_occupancy": 0.5, "decode_step_times_s": [0.01],
                    "kv_cache_layout": "paged"}

        def predict(self, X, names, meta=None):
            self.calls += 1
            return np.asarray(X)

    return Fake


def test_least_loaded_and_stats_merge_as_jax():
    got = {}
    for side, rs_cls, base, load in (("jax", JaxReplicaSet, JaxComponent, jax_replica_load),
                                     ("port", ReplicaSet, SeldonComponent, replica_load)):
        a, b = fake_class(base)(), fake_class(base)()
        assert load(a) == (0.0, 0.0)  # no batcher: an idle plain component
        rs = rs_cls([a, b])
        rs.predict(np.ones((1, 1)), ["x"])
        merged = rs.llm_stats()
        got[side] = ((a.calls, b.calls), rs.tags()["replicas"],
                     {k: merged[k] for k in ("tokens_generated", "kv_occupancy",
                                             "decode_step_times_s", "kv_cache_layout")})
    assert got["port"] == got["jax"] == ((1, 0), 2, {
        "tokens_generated": 20, "kv_occupancy": 0.5, "decode_step_times_s": [0.01, 0.01],
        "kv_cache_layout": "paged"})


def test_fleet_scrape_sums_tenant_rows():
    """A fleet's merged ``llm_stats`` carries one tenant row per replica for
    a (tenant, class); the scrape's series is their sum."""
    from seldon_core_tpu_torch.metrics.registry import MetricsRegistry

    class Tenanted:
        def __init__(self, admitted, tokens):
            self.row = {"tenant": "acme", "slo_class": "interactive", "admitted": admitted,
                        "shed": 1, "tokens": tokens}

        def llm_stats(self):
            return {"tenant_counters": [dict(self.row)], "kv_pages_total": 10}

    registry = MetricsRegistry()
    registry.sync_llm(ReplicaSet([Tenanted(3, 40), Tenanted(5, 60)]))
    text = registry.expose().decode()
    got = {ln.split("{")[0]: float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
           if ln.startswith("seldon_tenant_") and 'tenant="acme"' in ln}
    assert got == {"seldon_tenant_admitted_total": 8.0, "seldon_tenant_shed_total": 2.0,
                   "seldon_tenant_tokens_total": 100.0}
    pages = [ln for ln in text.splitlines() if ln.startswith("seldon_llm_kv_pages_total")]
    assert [float(ln.rsplit(" ", 1)[1]) for ln in pages] == [20.0]


def test_engine_list_component_becomes_one_replica_set():
    spec = {"name": "p", "graph": {"name": "m", "type": "MODEL"}}
    body = {"data": {"tensor": {"shape": [1, 1], "values": [1.0]}}}
    jreps = [fake_class(JaxComponent)() for _ in range(2)]
    preps = [fake_class(SeldonComponent)() for _ in range(2)]
    j = JaxEngine(JaxSpec.from_dict(spec), components={"m": jreps})
    p = GraphEngine(PredictorSpec.from_dict(spec), components={"m": preps}, device="cpu")
    for _ in range(2):
        got_j = j.predict_sync(JaxMessage.from_dict(body)).to_dict()
        got_p = p.predict_sync(SeldonMessage.from_dict(body)).to_dict()
        got_j["meta"].pop("puid"), got_p["meta"].pop("puid")
        assert got_p == got_j
    assert isinstance(p._components["m"], ReplicaSet)
    assert [r.calls for r in preps] == [r.calls for r in jreps] == [2, 0]


# ----------------------------------------------------------- membership
class StubReplica:
    def __init__(self, name="r"):
        self.name = name
        self.loaded = False
        self.draining = False
        self._idle = True

    def load(self):
        self.loaded = True

    def drain(self):
        self.draining = True

    def is_idle(self):
        return self._idle

    def predict(self, X, names, meta=None):
        return X


def add_drain_collect(rs_cls):
    r1, r2 = StubReplica("r1"), StubReplica("r2")
    rs = rs_cls([r1])
    rs.add_replica(r2)
    out = [r2.loaded, len(rs.members())]
    drained = rs.drain_replica()
    out += [drained.name, r2.draining, [r.name for r in rs.draining_members()],
            [rs.pick().name for _ in range(5)]]
    r2._idle = False  # still holding work: stays attached
    out += [rs.collect_drained(), len(rs.members())]
    r2._idle = True   # quiesced: two consecutive idle sweeps detach
    out += [rs.collect_drained(), [r.name for r in rs.collect_drained()],
            [r.name for r in rs.members()], rs.draining_members()]
    return out


def grace_resets(rs_cls):
    r1, r2 = StubReplica("r1"), StubReplica("r2")
    rs = rs_cls([r1, r2])
    rs.drain_replica(r2)
    out = [rs.collect_drained()]       # idle sighting 1
    r2._idle = False                   # late-dispatched work arrives
    out.append(rs.collect_drained())   # grace reset
    r2._idle = True
    out.append(rs.collect_drained())   # sighting 1 again
    out.append([r.name for r in rs.collect_drained()])
    return out


def last_never_drains(rs_cls):
    r1 = StubReplica("r1")
    rs = rs_cls([r1])
    out = [rs.drain_replica()]
    r2 = StubReplica("r2")
    rs.add_replica(r2)
    out += [rs.drain_replica().name, rs.drain_replica()]
    return out


def all_draining_fallback(rs_cls):
    r1, r2 = StubReplica("r1"), StubReplica("r2")
    rs = rs_cls([r1, r2])
    rs.drain_replica(r1)
    refused = rs.drain_replica(r2)  # r2 is the last serving replica
    return [refused, [r.name for r in rs.draining_members()], rs.pick().name,
            rs.undrain_replica().name, rs.draining_members(), rs.undrain_replica()]


def busy_stays_attached(rs_cls):
    r1, busy = StubReplica("r1"), StubReplica("busy")
    busy._idle = False
    rs = rs_cls([r1])
    rs.add_replica(busy)
    rs.drain_replica(busy)
    out = [rs.collect_drained() for _ in range(3)]
    out.append(busy in rs.members())  # never detached while holding work
    busy._idle = True
    out += [rs.collect_drained(), [r.name for r in rs.collect_drained()],
            busy in rs.members()]
    return out


@pytest.mark.parametrize("scenario", [add_drain_collect, grace_resets, last_never_drains,
                                      all_draining_fallback, busy_stays_attached],
                         ids=lambda f: f.__name__)
def test_membership_as_jax(scenario):
    assert scenario(ReplicaSet) == scenario(JaxReplicaSet)


def test_dispatch_order_prefix_then_load_then_index():
    """``pick_for``: the longest cached prefix, then the least load, then
    the lowest index; a replica without a probe matches 0."""

    class Probe:
        def __init__(self, match, queued):
            self.match = match
            self._batcher_service = None
            self.queued = queued

        def prefix_match_len(self, prompt):
            return self.match

    loads = {}
    rs = ReplicaSet([Probe(0, 0), Probe(4, 2), Probe(4, 1), Probe(2, 0)])
    rs.members()[0].prefix_match_len = None  # no probe: matches 0
    import seldon_core_tpu_torch.runtime.engine as eng

    orig = eng.replica_load
    try:
        eng.replica_load = lambda r: (float(r.queued), 0.0)
        assert rs.pick_for([1, 2, 3]) is rs.members()[2]      # 4 over 4: less load
        rs.members()[2].queued = 2
        assert rs.pick_for([1, 2, 3]) is rs.members()[1]      # equal: lower index
        assert rs.pick() is rs.members()[0]                   # least load, lowest index
        assert rs.prefix_match_len([1]) == 4
        rs.drain_replica(rs.members()[3])
        loads = rs.loads()
    finally:
        eng.replica_load = orig
    assert loads == [(0.0, 0.0), (2.0, 0.0), (2.0, 0.0), (0.0, 0.0)]


# --------------------------------------------------------- LLM replicas
def test_llm_replicas_generate_as_jax(jax_weights):
    """``generate()`` through each package's fleet of two replicas on the
    same weights: the replica's own tokens, the JAX fleet's tokens."""
    params = jax_weights[1]
    r1, r2 = port_server(params), port_server(params)
    rs = ReplicaSet([r1, r2])
    jrs = JaxReplicaSet([jax_server(jax_weights), jax_server(jax_weights)])
    for prompt in ([5, 9, 17], PROMPT):
        expected = r1.generate([prompt], max_new_tokens=6)["tokens"][0]
        assert rs.generate([prompt], max_new_tokens=6)["tokens"][0] == expected
        assert jrs.generate([prompt], max_new_tokens=6)["tokens"][0] == expected
    # the replicas' keys, and the fleet's own fault-tolerance tallies, as
    # the JAX fleet adds them
    fleet_keys = {"fleet_ejections_total", "fleet_reinstatements_total", "fleet_resumes_total",
                  "fleet_resumed_tokens_total", "fleet_resume_journal_depth",
                  "fleet_retry_budget_exhausted_total"}
    assert set(rs.llm_stats()) == set(r1.llm_stats()) | fleet_keys
    assert set(jrs.llm_stats()) - set(jrs.replicas[0].llm_stats()) == fleet_keys


def test_prefix_owner_routing_as_jax(jax_weights):
    """The replica whose trie holds the prompt wins over the lowest index; a
    cold prompt goes to the least loaded, lowest index; ``generate()``
    itself routes; the port's picks and tokens equal the JAX fleet's."""
    params = jax_weights[1]
    knobs = dict(continuous_batching=2, continuous_batching_max_len=32, kv_page_size=4,
                 prefix_cache_size=8)
    port = [port_server(params, **knobs) for _ in range(2)]
    jaxs = [jax_server(jax_weights, **knobs) for _ in range(2)]
    for r in port:
        r._batcher_service = BatcherService(r, max_slots=2)
    for r in jaxs:
        r._batcher_service = JaxBatcherService(r, max_slots=2)
    try:
        got = {}
        for side, reps, rs_cls in (("port", port, ReplicaSet), ("jax", jaxs, JaxReplicaSet)):
            rs = rs_cls(reps)
            # warm replica 2 only, through its own service
            expected = reps[1]._batcher_service.submit_sync(PROMPT, 6)
            got[side] = [expected, reps[1].prefix_match_len(PROMPT),
                         reps[0].prefix_match_len(PROMPT), rs.prefix_match_len(PROMPT),
                         reps.index(rs.pick_for(PROMPT)), reps.index(rs.pick_for([50, 51, 52])),
                         rs.generate([PROMPT], max_new_tokens=6)["tokens"][0]]
        assert got["port"] == got["jax"]
        expected, warm, cold, fleet, pick, pick_cold, gen = got["port"]
        assert warm > 0 and cold == 0 and fleet == warm
        assert (pick, pick_cold) == (1, 0) and gen == expected
    finally:
        for r in port + jaxs:
            r._batcher_service.close()


def test_drained_replica_finishes_then_detaches(jax_weights):
    """A drain while the replica decodes (its loop held inside the request's
    first ``on_token``): it stays attached while busy, new traffic goes to
    the other replica, its request completes with its solo tokens,
    ``collect_drained`` detaches it on the second idle sighting and closes
    and forgets its batcher, and ``add_replica`` brings it back (a new
    batcher on its first request)."""
    from seldon_core_tpu_torch.runtime.resilience import ShedError

    params = jax_weights[1]
    reps = [port_server(params, continuous_batching=2, max_new_tokens=24) for _ in range(2)]
    rs = ReplicaSet(reps)
    solo = reps[0].generate([PROMPT], max_new_tokens=24)["tokens"][0]
    started, gate = threading.Event(), threading.Event()

    def hold(tok):
        started.set()
        gate.wait(TIMEOUT)

    fut = rs.submit(PROMPT, 24, on_token=hold)  # equal loads: replica 0
    # the fleet dispatches on a thread of its own: read once a token is out
    assert started.wait(TIMEOUT)
    assert [getattr(r, "_batcher_service", None) is not None for r in reps] == [True, False]
    assert rs.drain_replica(reps[0]) is reps[0]
    assert rs.collect_drained() == [] and rs.collect_drained() == []  # busy
    assert rs.submit_sync([4, 5, 6], 6, timeout_s=TIMEOUT) == \
        reps[1].generate([[4, 5, 6]], max_new_tokens=6)["tokens"][0]
    gate.set()
    assert fut.result(TIMEOUT) == solo
    assert reps[0]._batcher_service.is_idle() and reps[1]._batcher_service.is_idle()
    svc0 = reps[0]._batcher_service
    assert rs.collect_drained() == []           # the first idle sighting: grace
    assert rs.collect_drained() == [reps[0]]
    assert rs.members() == [reps[1]] and rs.draining_members() == []
    assert reps[0]._batcher_service is None     # closed and forgotten
    with pytest.raises(ShedError, match="closed"):
        svc0.submit_sync(PROMPT, 2, timeout_s=TIMEOUT)
    # added back, it builds a new service on its first request (the other
    # replica drains, so the request is its)
    rs.add_replica(reps[0])
    assert rs.members() == [reps[1], reps[0]]
    assert rs.drain_replica(reps[1]) is reps[1]
    assert rs.submit_sync(PROMPT, 24, timeout_s=TIMEOUT) == solo
    assert reps[0]._batcher_service is not None and reps[0]._batcher_service is not svc0
    for r in reps:
        r._batcher_service.close()


# ------------------------------------------------------------ transports
def _post(port, body, path="/v1/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.read()


def _sse(port, body):
    raw = _post(port, dict(body, stream=True)).decode()
    return [json.loads(line[6:]) for line in raw.splitlines() if line.startswith("data: ")]


def test_fleet_behind_rest_and_grpc(jax_weights):
    from seldon_core_tpu_torch.transport import grpc_client
    from seldon_core_tpu_torch.transport.grpc_server import make_component_server

    params = jax_weights[1]
    reps = [port_server(params, continuous_batching=2, prefix_cache_size=8, kv_page_size=4)
            for _ in range(2)]
    rs = ReplicaSet(reps)
    assert get_batcher_service(rs) is rs and rs.batcher is rs
    want = {tuple(p): reps[0].generate([p], max_new_tokens=6)["tokens"][0]
            for p in (PROMPT, [50, 51, 52, 53])}
    httpd, _ = start(make_component_app(rs, device="cpu"))
    server = make_component_server(rs, host="127.0.0.1", port=None)
    gport = server.add_insecure_port("127.0.0.1:0")
    server.start()
    port = httpd.server_address[1]
    try:
        got = json.loads(_post(port, {"prompt": PROMPT, "max_new_tokens": 6}))
        assert got["tokens"] == want[tuple(PROMPT)]   # equal loads: replica 0
        assert reps[0].prefix_match_len(PROMPT) > 0
        assert getattr(reps[1], "_batcher_service", None) is None
        # the follow-up lands on the replica holding its prompt
        events = _sse(port, {"prompt": PROMPT, "max_new_tokens": 6})
        assert [e["token"] for e in events[:-1]] == events[-1]["tokens"] == want[tuple(PROMPT)]
        assert getattr(reps[1], "_batcher_service", None) is None
        # a cold prompt: no match anywhere, and replica 0's trie holds pages,
        # so the idle replica 1 is the least loaded
        stream = [m.json_data for m in grpc_client.call_stream(
            f"127.0.0.1:{gport}", "GenerateStream",
            SeldonMessage.from_dict({"jsonData": {"prompt": [50, 51, 52, 53],
                                                  "max_new_tokens": 6}}), timeout_s=TIMEOUT)]
        assert [e["token"] for e in stream[:-1]] == stream[-1]["tokens"] == \
            want[(50, 51, 52, 53)]
        assert reps[1].prefix_match_len([50, 51, 52, 53]) > 0
        assert reps[0].prefix_match_len([50, 51, 52, 53]) == 0
        merged = rs.llm_stats()
        scrape = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=TIMEOUT).read().decode()
        for key in ("kv_pages_total", "kv_pages_in_use"):
            line = [ln for ln in scrape.splitlines() if ln.startswith(f"seldon_llm_{key}")][0]
            assert float(line.rsplit(" ", 1)[1]) == merged[key] == sum(
                r.llm_stats()[key] for r in reps)
    finally:
        server.stop(None)
        httpd.shutdown()
        for r in reps:
            r._batcher_service.close()
