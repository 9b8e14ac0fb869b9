"""The port's autoscaler and its device actuator
(``seldon_core_tpu_torch/controlplane/autoscaler.py``,
``ContinuousBatcher.rebalance_disagg``) held against the JAX package's on
the CPU:

- ``decide_scale`` and ``decide_rebalance`` give the JAX package's
  decision (action, target, reason string) and next state on
  hypothesis-drawn configurations and signal sequences;
- the ReplicaSet cycles of ``tests/test_autoscaler.py`` (stub replicas:
  scripted load up then down with drain and two-sighting collect, a busy
  drained replica kept, ``run_forever`` on a FaultClock, a warm replica
  resumed mid-drain, applied-action tallies, the rebalance actuator) run
  through JAX's loop over JAX's fleet and the port's over the port's with
  the same decisions, memberships and stats; a spike on two tiny float32
  port replicas scales up, drains the newest with a straggler in flight
  and collects it, every request answered with local ``generate()``'s
  tokens;
- ``rebalance_disagg`` on a tiny float32 disaggregated paged batcher moves
  2 -> 3 -> 1 workers while requests are in flight, a job held on the
  outgoing pool at each swap; every token equals the local batcher's and
  the JAX batcher's on the same weights; the handoff count equals the
  requests and the queue ends empty; the refusals (off, < 1, the current
  count, past the slot count, past an explicit mesh) change nothing; a
  failed build raises and the old pool serves on;
- ``sync_controlplane`` exposes the autoscaler, canary and shadow
  families with the JAX registry's names, types, help texts and samples.
"""

import asyncio
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from seldon_core_tpu.controlplane import autoscaler as jax_auto
from seldon_core_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.runtime.engine import ReplicaSet as JaxReplicaSet
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.testing.faults import FaultClock as JaxFaultClock
from seldon_core_tpu_torch.controlplane import autoscaler as auto
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.observability.timeline import scaling_snapshot
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, get_batcher_service
from seldon_core_tpu_torch.parallel.mesh import DisaggregatedMesh
from seldon_core_tpu_torch.runtime.disagg import PrefillWorker
from seldon_core_tpu_torch.runtime.engine import ReplicaSet
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.testing.faults import FaultClock

TIMEOUT = 120


# ------------------------------------------------------ decision functions
SIGNAL = st.fixed_dictionaries({}, optional={
    "queue_depth": st.integers(0, 12), "active_slots": st.integers(0, 4),
    "total_slots": st.integers(0, 4), "page_pressure": st.floats(0, 1),
    "handoff_queue_depth": st.integers(0, 6), "draining": st.booleans(),
    "ejected": st.booleans(), "prefill_devices": st.integers(0, 4),
    "decode_devices": st.integers(0, 3),
    "requests": st.fixed_dictionaries({}, optional={
        "ttft_s": st.fixed_dictionaries({"p95": st.floats(0, 2)}),
        "queue_wait_s": st.fixed_dictionaries({"p95": st.floats(0, 2)})}),
})
CONFIG = st.fixed_dictionaries({}, optional={
    "min_replicas": st.integers(1, 2), "max_replicas": st.integers(1, 4),
    "up_queue_per_slot": st.sampled_from([0.5, 1.0, 2.0]),
    "up_page_pressure": st.sampled_from([0.5, 0.85]),
    "up_ttft_p95_s": st.sampled_from([None, 0.2, 1.0]),
    "up_queue_wait_p95_s": st.sampled_from([None, 0.5]),
    "up_stable_ticks": st.integers(1, 3), "down_queue_per_slot": st.sampled_from([0.0, 0.25]),
    "down_page_pressure": st.sampled_from([0.2, 0.5]), "down_stable_ticks": st.integers(1, 4),
    "cooldown_s": st.sampled_from([0.0, 2.0, 30.0]), "rebalance": st.booleans(),
    "rebalance_backlog_high": st.sampled_from([0.5, 1.0, 2.0]),
    "rebalance_backlog_low": st.sampled_from([0.0, 1.0]),
    "rebalance_stable_ticks": st.integers(1, 3),
    "rebalance_cooldown_s": st.sampled_from([0.0, 5.0]),
    "min_prefill_devices": st.integers(1, 2), "min_decode_devices": st.integers(0, 2),
})
TICK = st.tuples(st.lists(SIGNAL, min_size=0, max_size=3), st.sampled_from([0.0, 1.0, 3.0, 40.0]),
                 st.integers(1, 4), st.integers(0, 2), st.integers(0, 2))


@settings(max_examples=150, deadline=None)
@given(cfg=CONFIG, ticks=st.lists(TICK, min_size=1, max_size=8))
def test_decisions_equal_jax(cfg, ticks):
    pc, jc = auto.AutoscalerConfig(**cfg), jax_auto.AutoscalerConfig(**cfg)
    ps, js = auto.ControllerState(), jax_auto.ControllerState()
    now = 0.0
    for snaps, dt, n, n_drain, n_ej in ticks:
        now += dt
        psig = [auto.ReplicaSignals.from_scaling(s) for s in snaps]
        jsig = [jax_auto.ReplicaSignals.from_scaling(s) for s in snaps]
        assert [vars(s) for s in psig] == [vars(s) for s in jsig]
        pd, ps = auto.decide_scale(psig, pc, ps, now, n, n_drain, n_ej)
        jd, js = jax_auto.decide_scale(jsig, jc, js, now, n, n_drain, n_ej)
        assert (pd.action, pd.target, pd.reason) == (jd.action, jd.target, jd.reason)
        pr, ps = auto.decide_rebalance(psig, pc, ps, now)
        jr, js = jax_auto.decide_rebalance(jsig, jc, js, now)
        assert (pr.action, pr.target, pr.reason) == (jr.action, jr.target, jr.reason)
        assert vars(ps) == vars(js)


def test_one_card_snapshot_needs_min_decode_devices_zero():
    """The one-card split as the port's snapshot reports it (decode_devices
    1): the default ``min_decode_devices`` holds the long mix, 0 moves it;
    the JAX package decides the same on the same signals."""
    snap = {"handoff_queue_depth": 6, "prefill_devices": 2, "decode_devices": 1}
    for mod in (auto, jax_auto):
        sig = [mod.ReplicaSignals.from_scaling(snap)]
        kw = dict(rebalance=True, rebalance_stable_ticks=1, rebalance_cooldown_s=0.0)
        d, _ = mod.decide_rebalance(sig, mod.AutoscalerConfig(**kw), mod.ControllerState(), 0.0)
        assert d.action == mod.HOLD and d.reason == "split within band"
        d, _ = mod.decide_rebalance(sig, mod.AutoscalerConfig(min_decode_devices=0, **kw),
                                    mod.ControllerState(), 0.0)
        assert (d.action, d.target) == (mod.REBALANCE, 3)


# ------------------------------------------------------ fleet cycles (stubs)
class StubReplica:
    def __init__(self, name="r"):
        self.name = name
        self.loaded = self.draining = self.resumed = False
        self._idle = True

    def load(self):
        self.loaded = True

    def drain(self):
        self.draining = True

    def resume(self):
        self.resumed = True

    def is_idle(self):
        return self._idle

    def predict(self, X, names, meta=None):
        return X


SIDES = {"jax": (jax_auto, JaxReplicaSet, JaxFaultClock), "port": (auto, ReplicaSet, FaultClock)}


def make_loop(side, snapshots, cfg=None, factory=True, extra=()):
    mod, RS, FC = SIDES[side]
    clock = FC()
    rs = RS([StubReplica("r1"), *extra])
    made = []

    def build():
        made.append(StubReplica(f"r{len(made) + 2}"))
        return made[-1]

    a = mod.Autoscaler(rs, config=mod.AutoscalerConfig(**(cfg or dict(
        min_replicas=1, max_replicas=3, up_queue_per_slot=1.0, up_stable_ticks=2,
        down_queue_per_slot=0.25, down_stable_ticks=2, cooldown_s=5.0))),
        replica_factory=build if factory else None, clock=clock,
        snapshot_fn=lambda r: dict(snapshots.get(r.name, snapshots.get("*", {}))))
    return a, rs, made, clock


def names(rs):
    return [r.name for r in rs.members()], [r.name for r in rs.draining_members()]


def cycle_scripted_load(side):
    snaps = {"r1": {"queue_depth": 8, "total_slots": 2}}
    a, rs, made, clock = make_loop(side, snaps)
    out = []
    for i in range(8):
        if i == 2:
            snaps["r1"] = {"queue_depth": 0, "total_slots": 2}
            clock.advance(6.0)
        d = a.tick()
        out.append((d.action, d.target, d.reason, names(rs),
                    [r.draining for r in made]))
        clock.advance(1.0)
    return out, a.autoscaler_stats()


def cycle_busy_drained(side):
    busy = StubReplica("busy")
    busy._idle = False
    a, rs, made, clock = make_loop(side, {"*": {"queue_depth": 0, "total_slots": 2}},
                                   extra=[busy])
    rs.drain_replica(busy)
    out = []
    for i in range(5):
        if i == 3:
            busy._idle = True
        a.tick()
        clock.advance(1.0)
        out.append(names(rs))
    return out, a.autoscaler_stats()


def cycle_run_forever(side):
    a, rs, made, clock = make_loop(side, {"r1": {"queue_depth": 8, "total_slots": 2}}, cfg=dict(
        min_replicas=1, max_replicas=2, up_queue_per_slot=1.0, up_stable_ticks=2, cooldown_s=5.0))
    passes = []

    def sleep(s):
        clock.advance(s)
        passes.append(clock.now())
        if len(passes) >= 4:
            a.stop()

    a.run_forever(sleep=sleep)
    return passes, names(rs), a.autoscaler_stats()


def cycle_resume_warm(side):
    mod, RS, FC = SIDES[side]
    r1, r2 = StubReplica("r1"), StubReplica("r2")
    rs = RS([r1, r2])
    rs.drain_replica(r2)
    built = []
    a = mod.Autoscaler(rs, config=mod.AutoscalerConfig(
        min_replicas=1, max_replicas=3, up_queue_per_slot=1.0, up_stable_ticks=1,
        cooldown_s=0.0), replica_factory=lambda: built.append(StubReplica("cold")) or built[-1],
        clock=FC(), snapshot_fn=lambda r: {"queue_depth": 8, "total_slots": 2})
    out = []
    for _ in range(2):
        d = a.tick()
        out.append((d.action, d.reason, names(rs), r2.resumed, len(built)))
    return out, a.autoscaler_stats()


def cycle_unactuatable(side):
    a, rs, made, clock = make_loop(side, {"*": {"queue_depth": 8, "total_slots": 2}}, cfg=dict(
        min_replicas=1, max_replicas=3, up_queue_per_slot=1.0, up_stable_ticks=1,
        cooldown_s=0.0), factory=False)
    return [a.tick().action for _ in range(3)], a.autoscaler_stats()


def cycle_rebalance_actuator(side):
    mod, RS, FC = SIDES[side]

    class FakeBatcher:
        def __init__(self):
            self._remote = object()
            self.calls = []

        def rebalance_disagg(self, n):
            self.calls.append(n)
            return len(self.calls) == 1   # the second is refused

    class FakeSvc:
        def __init__(self):
            self.batcher = FakeBatcher()

    r1 = StubReplica("r1")
    r1._batcher_service = FakeSvc()
    a = mod.Autoscaler(RS([r1]), config=mod.AutoscalerConfig(
        rebalance=True, rebalance_backlog_high=1.0, rebalance_stable_ticks=1,
        rebalance_cooldown_s=0.0, up_queue_per_slot=1e9), clock=FC(),
        snapshot_fn=lambda r: {"handoff_queue_depth": 4, "prefill_devices": 2,
                               "decode_devices": 6})
    a.tick()
    a.tick()
    return r1._batcher_service.batcher.calls, a.autoscaler_stats()


CYCLES = [cycle_scripted_load, cycle_busy_drained, cycle_run_forever, cycle_resume_warm,
          cycle_unactuatable, cycle_rebalance_actuator]


@pytest.mark.parametrize("cycle", CYCLES, ids=lambda f: f.__name__)
def test_fleet_cycles_equal_jax(cycle):
    got, want = cycle("port"), cycle("jax")
    assert got == want
    stats = got[-1]
    if cycle is cycle_scripted_load:
        assert (stats["autoscaler_scale_ups_total"], stats["autoscaler_scale_downs_total"],
                stats["autoscaler_collected_total"], stats["autoscaler_replicas"]) == (1, 1, 1, 1)
    if cycle is cycle_unactuatable:
        assert got[0] == ["scale_up"] * 3 and stats["autoscaler_scale_ups_total"] == 0
    if cycle is cycle_rebalance_actuator:
        assert got[0] == [3, 3] and stats["autoscaler_rebalances_total"] == 1


# --------------------------------------------- a spike on tiny port replicas
KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
TINY = dict(model="transformer", model_kwargs=KW, init_random=True, max_new_tokens=8,
            len_buckets=(16,), batch_buckets=(1,), temperature=0.0, eos_id=-1, seed=3,
            continuous_batching=2, kv_page_size=8)


def test_spike_scales_up_then_drains_the_newest_on_port_replicas():
    def tiny():
        s = LLMServer(device="cpu", **TINY)
        s.load()
        return s

    clock = FaultClock()
    s1 = tiny()
    rs = ReplicaSet([s1])
    a = auto.Autoscaler(rs, config=auto.AutoscalerConfig(
        min_replicas=1, max_replicas=2, up_queue_per_slot=1.0, up_stable_ticks=2,
        down_queue_per_slot=0.6, down_stable_ticks=2, cooldown_s=5.0),
        replica_factory=tiny, clock=clock)
    svc1 = get_batcher_service(s1)
    gate = threading.Event()
    real_chaos = svc1.batcher._chaos
    svc1.batcher._chaos = lambda b: gate.wait(TIMEOUT)   # hold the spike queued
    prompts = [[5, 9, 17], [40, 3, 22], [7, 7], [60, 61, 62], [1, 2, 3], [9]]
    futs = [svc1.submit(p, 16) for p in prompts]
    try:
        decisions = []
        for _ in range(4):
            decisions.append(a.tick().action)
            clock.advance(1.0)
        assert decisions[:2] == [auto.HOLD, auto.SCALE_UP] and len(rs.members()) == 2
    finally:
        svc1.batcher._chaos = real_chaos
        gate.set()
    want = [s1.generate([p], max_new_tokens=16)["tokens"][0] for p in prompts]
    assert [f.result(TIMEOUT) for f in futs] == want
    s2 = rs.members()[1]
    svc2 = get_batcher_service(s2)
    straggler = svc2.submit([11, 12, 13], 16)
    clock.advance(6.0)
    for _ in range(6):
        if a.tick().action == auto.SCALE_DOWN:
            break
        clock.advance(1.0)
    assert rs.draining_members() == [s2] and svc2.batcher.draining
    assert straggler.result(TIMEOUT) == s1.generate([[11, 12, 13]], max_new_tokens=16)["tokens"][0]
    for _ in range(6):
        a.tick()
        clock.advance(1.0)
        if len(rs.members()) == 1:
            break
    assert rs.members() == [s1] and s2._batcher_service is None
    stats = a.autoscaler_stats()
    assert (stats["autoscaler_scale_ups_total"], stats["autoscaler_scale_downs_total"],
            stats["autoscaler_collected_total"]) == (1, 1, 1)
    svc1.close()


# ------------------------------------------------------- rebalance_disagg
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3,
              disaggregation="remote_prefill", prefill_devices=2)
BKW = dict(max_slots=3, max_len=40, len_buckets=(8,), page_size=8)
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13], [7],
           [60, 61, 62, 63, 64, 65]]


@pytest.fixture(scope="module")
def pair():
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    p = LLMServer(device="cpu", **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    return j, p


def hold_pool(b):
    """Hold every worker of the batcher's current pool before its next job
    until the returned event is set."""
    gate = threading.Event()
    for w in b._remote.workers:
        real = w._prefill_one
        w._prefill_one = lambda req, _real=real: (gate.wait(TIMEOUT), _real(req))[1]
    return gate


def test_rebalance_moves_workers_mid_stream_tokens_equal_local_and_jax(pair):
    j, p = pair

    async def jax_run():
        b = JaxBatcher(j, layout="paged", **BKW)
        outs = await asyncio.gather(*[b.submit(q, max_new_tokens=8) for q in PROMPTS * 3])
        await b.close()
        return outs

    want = asyncio.run(jax_run())
    local = ContinuousBatcher(p, device="cpu", disaggregation="off", **BKW)
    try:
        assert [f.result(TIMEOUT) for f in [local.submit(q, 8) for q in PROMPTS * 3]] == want
    finally:
        local.close()
    b = ContinuousBatcher(p, device="cpu", **BKW)
    try:
        assert len(b._remote.workers) == 2 and scaling_snapshot(p, b)["prefill_devices"] == 2
        outs = []
        for n in (3, 1):
            old = b._remote
            gate = hold_pool(b)
            futs = [b.submit(q, 8) for q in PROMPTS]
            while b.handoff_stats()["handoff_queue_depth"] == 0:
                pass     # a job is staged on the outgoing pool
            threading.Timer(0.2, gate.set).start()
            assert b.rebalance_disagg(n)
            assert b._remote is not old and len(b._remote.workers) == n
            assert all(w._staging is None and w.graphs() == {} for w in old.workers)
            assert scaling_snapshot(p, b)["prefill_devices"] == n
            outs += [f.result(TIMEOUT) for f in futs]
        outs += [f.result(TIMEOUT) for f in [b.submit(q, 8) for q in PROMPTS]]
        stats = b.handoff_stats()
        assert sum(w.eager_runs for w in b._remote.workers) > 0
    finally:
        b.close()
    assert outs == want
    assert stats["handoffs_total"] == 3 * len(PROMPTS) and stats["handoff_queue_depth"] == 0


def test_rebalance_over_a_dense_batcher_tokens_equal_local_and_jax(pair):
    """``rebalance_disagg`` on a dense batcher (JAX ``tests/test_autoscaler.
    py``'s dense case): jobs staged on the outgoing pool still deliver
    through the shared queue, the new workers hold a staging row each, and
    every token equals the local dense batcher's and JAX's."""
    j, p = pair
    kw = dict(BKW, layout="dense")
    kw.pop("page_size")

    async def jax_run():
        b = JaxBatcher(j, **kw)
        outs = await asyncio.gather(*[b.submit(q, max_new_tokens=8) for q in PROMPTS * 2])
        await b.close()
        return outs

    local = ContinuousBatcher(p, device="cpu", disaggregation="off", **kw)
    try:
        want = [f.result(TIMEOUT) for f in [local.submit(q, 8) for q in PROMPTS * 2]]
    finally:
        local.close()
    assert want == asyncio.run(jax_run())
    b = ContinuousBatcher(p, device="cpu", **kw)
    try:
        old = b._remote
        gate = hold_pool(b)
        futs = [b.submit(q, 8) for q in PROMPTS]
        while b.handoff_stats()["handoff_queue_depth"] == 0:
            pass     # a job is staged on the outgoing pool
        threading.Timer(0.2, gate.set).start()
        assert b.rebalance_disagg(1) and len(b._remote.workers) == 1
        assert all(w._staging is None for w in old.workers)
        assert tuple(b._remote.workers[0]._staging[0][-1].shape) == (1, kw["max_len"] + 1)
        outs = [f.result(TIMEOUT) for f in futs]
        outs += [f.result(TIMEOUT) for f in [b.submit(q, 8) for q in PROMPTS]]
        assert b.handoff_stats()["handoffs_total"] == 2 * len(PROMPTS)
        assert not any(s.active or s.prefilling for s in b._slots)
    finally:
        b.close()
    assert outs == want


def test_rebalance_refusals_change_nothing(pair):
    _, p = pair
    b = ContinuousBatcher(p, device="cpu", **dict(BKW, max_slots=2))
    try:
        pool = b._remote
        assert b.max_prefill_workers() == 2          # one card: the slot count
        for n in (0, -1, 2, 3, 8):
            assert not b.rebalance_disagg(n)
        assert b._remote is pool and len(b.disagg_mesh.prefill_devices) == 2
        assert b.rebalance_disagg(1) and len(b._remote.workers) == 1
    finally:
        b.close()
    off = ContinuousBatcher(p, device="cpu", disaggregation="off", **BKW)
    try:
        assert not off.rebalance_disagg(2)
    finally:
        off.close()
    mesh = ContinuousBatcher(p, device="cpu", disagg_mesh=DisaggregatedMesh(["cpu", "cpu"], ["cpu"]),
                             **BKW)
    try:
        assert mesh.max_prefill_workers() == 2       # an explicit mesh: its entries
        assert not mesh.rebalance_disagg(3)
        assert mesh.rebalance_disagg(1) and mesh.rebalance_disagg(2)
        assert mesh.submit(PROMPTS[0], 8).result(TIMEOUT) == p.generate(
            [PROMPTS[0]], max_new_tokens=8)["tokens"][0]
    finally:
        mesh.close()


def test_failed_build_raises_and_the_old_pool_serves(pair, monkeypatch):
    _, p = pair
    b = ContinuousBatcher(p, device="cpu", **BKW)
    try:
        pool = b._remote
        real = PrefillWorker._build_state
        built = []

        def fail_third(self):
            built.append(self.name)
            if len(built) == 3:
                raise RuntimeError("injected capture failure")
            return real(self)

        monkeypatch.setattr(PrefillWorker, "_build_state", fail_third)
        with pytest.raises(RuntimeError, match="injected capture failure"):
            b.rebalance_disagg(3)
        monkeypatch.setattr(PrefillWorker, "_build_state", real)
        assert b._remote is pool and len(pool.workers) == 2
        assert all(w._staging is not None for w in pool.workers)
        assert [f.result(TIMEOUT) for f in [b.submit(q, 8) for q in PROMPTS]] == \
            [p.generate([q], max_new_tokens=8)["tokens"][0] for q in PROMPTS]
    finally:
        b.close()


# ------------------------------------------------------------------ metrics
def families(text):
    from prometheus_client.parser import text_string_to_metric_families

    return {f.name: f for f in text_string_to_metric_families(text)}


def test_sync_controlplane_families_equal_jax():
    from seldon_core_tpu.analytics import canary as jax_canary
    from seldon_core_tpu_torch.analytics import canary

    from tests.test_canary import Doubler as JaxDoubler
    from tests.test_canary import Echo as JaxEcho
    from tests.test_torch_canary import Doubler, Echo

    def side(name):
        mod = jax_canary if name == "jax" else canary
        kw = {} if name == "jax" else {"device": "cpu"}
        a, rs, made, clock = make_loop(name, {"r1": {"queue_depth": 8, "total_slots": 2}})
        a.tick()
        clock.advance(1.0)
        a.tick()
        reg = (JaxRegistry if name == "jax" else MetricsRegistry)(deployment="d", predictor="p")
        reg.sync_controlplane(a)
        router = mod.CanaryRouter(fraction=0.5, min_samples=1000, **kw)
        router.name = "cr"
        for _ in range(3):
            router.observe_outcome(1, 0.1, error=True)
        router.rollback("test")
        reg.sync_controlplane(router)
        shadow = mod.ShadowNode(*((JaxEcho(), JaxDoubler()) if name == "jax"
                                  else (Echo(), Doubler())), mirror_fraction=1.0)
        shadow.name = "sh"
        shadow.predict(np.array([[1.0]]), ["a"])
        reg.sync_controlplane(shadow)
        reg.sync_controlplane(None)
        reg.sync_controlplane(a)      # counter catch-up is idempotent
        return families(reg.expose().decode())

    got, want = side("port"), side("jax")
    # prometheus_client's creation-time series have no counterpart in the port
    names = {n for n in want if n.startswith(("seldon_autoscaler", "seldon_canary",
                                              "seldon_shadow")) and not n.endswith("_created")}
    assert len(names) == 10 and names <= set(got)

    def samples(fam):
        return sorted((s.name, sorted(s.labels.items()), s.value) for s in fam.samples
                      if not s.name.endswith("_created"))

    for n in names:
        assert (got[n].type, got[n].documentation, samples(got[n])) == \
            (want[n].type, want[n].documentation, samples(want[n])), n
    ups = [s for s in got["seldon_autoscaler_scale_events"].samples
           if s.labels["action"] == "scale_up" and s.name.endswith("_total")]
    assert ups[0].value == 1


def test_fleet_app_scrape_carries_the_autoscaler():
    """The component app of a fleet with an ``autoscaler`` attribute shows
    the loop's series on its scrape (the REST handler calls
    sync_controlplane)."""
    import urllib.request

    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    a, rs, made, clock = make_loop("port", {"r1": {"queue_depth": 8, "total_slots": 2}})
    rs.autoscaler = a
    a.tick()
    clock.advance(1.0)
    a.tick()
    httpd, _ = start(make_component_app(rs, device="cpu"))
    try:
        text = urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/metrics",
                                      timeout=30).read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert 'seldon_autoscaler_replicas{deployment_name="",predictor_name=""} 2.0' in text
    assert 'action="scale_up"' in text
