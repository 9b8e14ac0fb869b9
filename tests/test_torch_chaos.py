"""The port's fleet fault tolerance (``seldon_core_tpu_torch/runtime/engine.py``
``ReplicaSet``: health checks, ejection, half-open reinstatement, the resume
journal, the retry budget) held against the JAX package's on the CPU.

- The protocol: the same scripted stub replicas go through JAX's
  ``ReplicaSet`` and the port's, and give the same tokens, the same stream
  with the same ``ResumeMarker`` placement, the same calls to each replica
  (prompt, budget, seed, ``resume_tokens``), the same errors with their
  status and ``Retry-After``, and the same fleet tallies: a mid-stream
  resume, a non-streaming caller, an unseeded request getting a pinned
  seed, a spent budget, ejection by consecutive failures and by a stale
  heartbeat, a half-open probe's reinstatement, errors that are not
  recoverable, a mid-stream failure without a token journal, and
  ``generate()`` failing over once from the budget (JAX
  ``tests/test_chaos.py:400-568``).
- The kill: a 3-replica float32 port fleet (paged KV), greedy and seeded,
  loses its busiest replica mid-decode (``testing/faults.BatcherKiller``);
  every stream equals the port's unfaulted ``generate(seed=)`` exactly, with
  one marker a resumed stream and no token twice, and greedy also equals
  the JAX package's ``generate()`` on the same weights (JAX
  ``tests/test_chaos.py:110``). The victim's crash path released every
  page (``LeakSweep``), which the JAX package's does not. The port's
  autoscaler reads the ejection on its next tick and replaces the replica
  (``SCALE_UP``, "ejected" in its reason; JAX ``tests/test_chaos.py:206``).
- Reinstatement on a ``FaultClock``; a broken device staying ejected; a
  poisoned handoff failing one request, not the batch.

Everything is event-driven: kills fire on delivered-token predicates, and
breaker windows pass on a FaultClock. Tokens, stream shapes and tallies
are exact.
"""

import threading
import types

import numpy as np
import pytest

import jax

from seldon_core_tpu.contracts.payload import SeldonError as JaxSeldonError
from seldon_core_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from seldon_core_tpu.runtime.engine import ReplicaSet as JaxReplicaSet
from seldon_core_tpu.runtime.resilience import ResumeMarker as JaxResumeMarker
from seldon_core_tpu.runtime.resilience import RetryBudget as JaxRetryBudget
from seldon_core_tpu.runtime.resilience import ShedError as JaxShedError
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.testing.faults import DispatchFailer as JaxDispatchFailer
from seldon_core_tpu.testing.faults import FaultClock as JaxFaultClock
from seldon_core_tpu.testing.faults import FaultSchedule as JaxFaultSchedule
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, ensure_stream_service
from seldon_core_tpu_torch.runtime.engine import ReplicaSet
from seldon_core_tpu_torch.runtime.resilience import ResumeMarker, RetryBudget, ShedError
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.testing.faults import (BatcherKiller, DispatchFailer, FaultClock,
                                                  FaultSchedule, HandoffPoisoner, LeakSweep)

TIMEOUT = 120.0

SIDES = {
    "jax": types.SimpleNamespace(ReplicaSet=JaxReplicaSet, SeldonError=JaxSeldonError,
                                 ShedError=JaxShedError, ResumeMarker=JaxResumeMarker,
                                 RetryBudget=JaxRetryBudget, DispatchFailer=JaxDispatchFailer,
                                 FaultSchedule=JaxFaultSchedule, FaultClock=JaxFaultClock),
    "port": types.SimpleNamespace(ReplicaSet=ReplicaSet, SeldonError=SeldonError,
                                  ShedError=ShedError, ResumeMarker=ResumeMarker,
                                  RetryBudget=RetryBudget, DispatchFailer=DispatchFailer,
                                  FaultSchedule=FaultSchedule, FaultClock=FaultClock),
}


# ------------------------------------------------------------------ stubs
class _Alive:
    """A loop that claims to run: a JAX task not done, a port thread alive."""

    def done(self):
        return False

    def is_alive(self):
        return True


class _StubAllocator:
    def stats(self):
        return (10, 0, 0)


class StubBatcher:
    """What both fleets read of a replica's batcher: load signals, the
    crash flag, the loop's liveness and heartbeat."""

    def __init__(self):
        self._pending = []
        self._slots = []
        self.paged = False
        self._allocator = _StubAllocator()
        self.crashed = None
        self._task = None
        self._thread = None
        self.heartbeat = 0.0

    def accommodates(self, prompt, max_new_tokens=None):
        return True


class ScriptedService:
    """A batcher service whose ``submit_sync`` runs ``script(i, prompt,
    max_new, on_token, seed, resume_tokens)`` and records every call."""

    def __init__(self, script):
        self.script = script
        self.batcher = StubBatcher()
        self.calls = []

    def submit_sync(self, prompt, max_new_tokens=None, timeout_s=600.0, info=None, seed=None,
                    trace=None, tenant=None, slo_class=None, adapter=None, deadline_s=None,
                    on_token=None, resume_tokens=0):
        i = len(self.calls)
        self.calls.append(dict(prompt=list(prompt), max_new=max_new_tokens, seed=seed,
                               resume_tokens=resume_tokens))
        return self.script(i, list(prompt), max_new_tokens, on_token, seed, resume_tokens)


class StubReplica:
    def __init__(self, script):
        self._batcher_service = ScriptedService(script)

    @property
    def svc(self):
        return self._batcher_service


FULL = [10, 11, 12, 13, 14, 15, 16, 17]
PROMPT = [1, 2, 3]


def dying(S, n_tokens):
    """Streams ``n_tokens`` of FULL, then dies as a crashed batcher does:
    the crash flag up, the end sentinel to its stream, the dispatch
    raising."""
    holder = {}

    def script(i, prompt, max_new, on_token, seed, resume_tokens):
        for t in FULL[:n_tokens]:
            on_token(t)
        holder["r"].svc.batcher.crashed = RuntimeError("loop died")
        if on_token is not None:
            on_token(None)
        raise S.SeldonError("batcher loop died", status_code=503, reason="INJECTED_FAULT")

    holder["r"] = StubReplica(script)
    return holder["r"]


def resuming(expect_resume):
    def script(i, prompt, max_new, on_token, seed, resume_tokens):
        assert resume_tokens == expect_resume
        assert prompt == PROMPT + FULL[:expect_resume]
        assert max_new == len(FULL) - expect_resume
        out = FULL[expect_resume:]
        for t in out:
            on_token(t)
        return out

    return StubReplica(script)


def enc(stream):
    """A stream with its markers as ("resumed", n): comparable across the
    two packages' marker classes."""
    return [("resumed", t.tokens_delivered) if hasattr(t, "tokens_delivered") else t
            for t in stream]


def tallies(fleet, reps):
    return dict(resumes=fleet._resumes_total, resumed_tokens=fleet._resumed_tokens_total,
                ejections=fleet._ejections_total, reinstatements=fleet._reinstatements_total,
                ejected=[reps.index(r) for r in fleet.ejected_members()],
                budget=fleet.retry_budget.snapshot(), journal=fleet._journal.depth())


def error_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return (type(e).__name__, getattr(e, "status_code", None),
                getattr(e, "retry_after_s", None), str(e))
    return None


# ------------------------------------------------------------ protocol
def mid_stream_resume(S):
    a, b = dying(S, 3), resuming(3)
    fleet = S.ReplicaSet([a, b])
    stream = []
    out = fleet.submit_sync(PROMPT, len(FULL), seed=77, on_token=stream.append)
    return dict(out=out, stream=enc(stream), calls=(a.svc.calls, b.svc.calls),
                **tallies(fleet, [a, b]))


def nonstreaming_caller(S):
    a, b = dying(S, 2), resuming(2)
    fleet = S.ReplicaSet([a, b])
    return dict(out=fleet.submit_sync(PROMPT, len(FULL), seed=5),
                calls=(a.svc.calls, b.svc.calls), **tallies(fleet, [a, b]))


def unseeded_gets_pinned_seed(S):
    a, b = dying(S, 4), StubReplica(None)

    def script(i, prompt, max_new, on_token, seed, resume_tokens):
        assert resume_tokens == 4 and seed is not None
        for t in FULL[4:]:
            on_token(t)
        return FULL[4:]

    b.svc.script = script
    fleet = S.ReplicaSet([a, b])
    out = fleet.submit_sync(PROMPT, len(FULL))
    seeds = (a.svc.calls[0]["seed"], b.svc.calls[0]["seed"])
    return dict(out=out, same_seed=seeds[0] == seeds[1] is not None,
                resume=[c["resume_tokens"] for c in a.svc.calls + b.svc.calls])


def budget_exhausted(S):
    a, b = dying(S, 2), resuming(2)
    fleet = S.ReplicaSet([a, b])
    fleet.retry_budget = S.RetryBudget(ratio=0.0, min_retries=0)
    err = error_of(lambda: fleet.submit_sync(PROMPT, len(FULL), seed=9))
    return dict(err=err, b_calls=b.svc.calls, stats=fleet.llm_stats(), **tallies(fleet, [a, b]))


def consecutive_failures_eject(S):
    def serve(i, prompt, max_new, on_token, seed, resume_tokens):
        return [5, 6]

    a, b = StubReplica(serve), StubReplica(serve)
    failer = S.DispatchFailer(a.svc, S.FaultSchedule.always_fail())
    fleet = S.ReplicaSet([a, b])
    out = fleet.submit_sync(PROMPT, 2, seed=1)
    return dict(out=out, failer=failer.calls, b_calls=b.svc.calls, **tallies(fleet, [a, b]))


def stale_heartbeat_ejects(S):
    """A loop alive but silent past ``heartbeat_timeout_s`` on the fleet's
    clock is wedged: ejected before dispatch, never picked."""
    def serve(i, prompt, max_new, on_token, seed, resume_tokens):
        return [7, 8]

    a, b = StubReplica(serve), StubReplica(serve)
    a.svc.batcher._task = a.svc.batcher._thread = _Alive()
    a.svc.batcher.heartbeat = 50.0
    fleet = S.ReplicaSet([a, b])
    fleet.clock = S.FaultClock(start=60.0)
    fresh = fleet.check_health()  # 10 s old: alive
    fleet.clock.advance(25.0)     # 35 s old: wedged
    out = fleet.submit_sync(PROMPT, 2, seed=1)
    return dict(fresh=fresh, out=out, a_calls=a.svc.calls, b_calls=len(b.svc.calls),
                **tallies(fleet, [a, b]))


def probe_reinstates(S):
    """Ejected by its crash, left alone inside the quarantine, probed after
    it on the fleet's clock: the restarted replica answers and is back."""
    clock = S.FaultClock()
    state = {"dead": True}

    def script(i, prompt, max_new, on_token, seed, resume_tokens):
        if state["dead"]:
            a.svc.batcher.crashed = RuntimeError("loop died")
            raise S.SeldonError("batcher loop died", status_code=503)
        a.svc.batcher.crashed = None  # a restarted loop
        return [1, 1]

    a = StubReplica(script)
    b = StubReplica(lambda *args: [2, 2])
    fleet = S.ReplicaSet([a, b])
    fleet.clock = clock
    fleet.retry_budget = S.RetryBudget(clock=clock)
    outs = [fleet.submit_sync(PROMPT, 2, seed=1)]   # fails over to b
    state["dead"] = False
    outs.append(fleet.submit_sync(PROMPT, 2, seed=1))  # quarantined: b
    clock.advance(fleet.reinstate_after_s + 0.1)
    outs.append(fleet.submit_sync(PROMPT, 2, seed=1))  # the probe: a
    outs.append(fleet.submit_sync(PROMPT, 2, seed=1))  # back in the pool: a
    return dict(outs=outs, a_calls=len(a.svc.calls), b_calls=len(b.svc.calls),
                **tallies(fleet, [a, b]))


def nonrecoverable_passes(S):
    def shedding(i, prompt, max_new, on_token, seed, resume_tokens):
        raise S.ShedError("queue full", retry_after_s=2.0)

    def bad_request(i, prompt, max_new, on_token, seed, resume_tokens):
        raise S.SeldonError("bad prompt", status_code=400)

    def never(i, prompt, max_new, on_token, seed, resume_tokens):
        raise AssertionError("a sibling must not be tried")

    out = {}
    for name, script in (("shed", shedding), ("400", bad_request)):
        a, b = StubReplica(script), StubReplica(never)
        fleet = S.ReplicaSet([a, b])
        out[name] = (error_of(lambda: fleet.submit_sync(PROMPT, 4, seed=1)), b.svc.calls,
                     tallies(fleet, [a, b]))
    return out


def mid_stream_without_journal(S):
    def die_mid(i, prompt, max_new, on_token, seed, resume_tokens):
        on_token(99)
        raise S.SeldonError("died", status_code=503)

    a, b = StubReplica(die_mid), StubReplica(die_mid)
    fleet = S.ReplicaSet([a, b])
    stream = []
    err = error_of(lambda: fleet.submit_sync("untokenizable prompt", 4, seed=1,
                                             on_token=stream.append))
    return dict(err=err, stream=stream, n_calls=len(a.svc.calls) + len(b.svc.calls))


class GenReplica:
    def __init__(self, fail_with=None):
        self.fail_with = fail_with
        self.calls = 0

    def load(self):
        pass

    def generate(self, prompts, *a, **kw):
        self.calls += 1
        if self.fail_with is not None:
            raise self.fail_with
        return {"tokens": [[1, 2, 3]]}


def generate_failover(S):
    out = {}
    for case in ("once", "budget", "client"):
        err = ValueError("bad prompt") if case == "client" else RuntimeError("device wedged")
        bad, good = GenReplica(err), GenReplica()
        fleet = S.ReplicaSet([bad, good])
        if case == "budget":
            fleet.retry_budget = S.RetryBudget(ratio=0.0, min_retries=0)
        e = error_of(lambda: fleet.generate([[7, 8]], max_new_tokens=3))
        out[case] = (e, bad.calls, good.calls, tallies(fleet, [bad, good]))
    return out


SCENARIOS = [mid_stream_resume, nonstreaming_caller, unseeded_gets_pinned_seed,
             budget_exhausted, consecutive_failures_eject, stale_heartbeat_ejects,
             probe_reinstates, nonrecoverable_passes, mid_stream_without_journal,
             generate_failover]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_protocol_as_jax(scenario):
    got = {name: scenario(side) for name, side in SIDES.items()}
    assert got["port"] == got["jax"]


def test_protocol_outcomes():
    """What the shared outcomes are (the parity above pins them to the JAX
    package's; these pin them to the contract)."""
    S = SIDES["port"]
    r = mid_stream_resume(S)
    assert r["out"] == FULL
    # 3 tokens, the seam's marker, 5 tokens, one end (the dead replica's
    # end was swallowed)
    assert r["stream"] == FULL[:3] + [("resumed", 3)] + FULL[3:] + [None]
    assert [c["resume_tokens"] for c in r["calls"][0] + r["calls"][1]] == [0, 3]
    assert r["calls"][1][0]["seed"] == 77
    assert (r["resumes"], r["resumed_tokens"], r["ejected"]) == (1, 3, [0])
    assert r["budget"]["retries_in_window"] == 1 and r["journal"] == 0
    assert nonstreaming_caller(S)["out"] == FULL
    u = unseeded_gets_pinned_seed(S)
    assert u["same_seed"] and u["resume"] == [0, 4]
    b = budget_exhausted(S)
    assert b["err"][:3] == ("ShedError", 503, 5.0) and "retry budget" in b["err"][3]
    assert b["b_calls"] == [] and b["resumes"] == 0 and b["budget"]["exhausted_total"] == 1
    assert b["stats"] == {}  # stubs carry no llm_stats
    c = consecutive_failures_eject(S)
    assert c["out"] == [5, 6] and c["failer"] == 3 and c["ejected"] == [0]
    assert c["b_calls"][0]["resume_tokens"] == 0
    h = stale_heartbeat_ejects(S)
    assert h["fresh"] == [] and h["ejected"] == [0] and h["a_calls"] == [] and h["b_calls"] == 1
    p = probe_reinstates(S)
    assert p["outs"] == [[2, 2], [2, 2], [1, 1], [1, 1]]
    assert (p["ejections"], p["reinstatements"], p["ejected"]) == (1, 1, [])
    n = nonrecoverable_passes(S)
    assert n["shed"][0][:3] == ("ShedError", 503, 2.0) and n["shed"][1] == []
    assert n["400"][0][:2] == ("SeldonError", 400) and n["shed"][2]["ejected"] == []
    m = mid_stream_without_journal(S)
    assert m["err"][:2] == ("SeldonError", 503) and m["n_calls"] == 1
    g = generate_failover(S)
    assert g["once"][:3] == (None, 1, 1) and g["once"][3]["budget"]["retries_in_window"] == 1
    assert g["budget"][0][:2] == ("ShedError", 503) and g["budget"][2] == 0
    assert g["client"][0][0] == "ValueError" and g["client"][2] == 0


# ------------------------------------------------------------- the kill
KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
# len bucket 48 holds a resumed prompt (the prompt and the delivered tokens)
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=24, len_buckets=(16, 48),
              batch_buckets=(1, 4), eos_id=-1, seed=3, continuous_batching=3,
              continuous_batching_max_len=64, kv_page_size=8)
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13], [7], [60, 61, 62, 63, 64, 65],
           [1, 2, 3, 4, 5]]
SEEDS = [101, 102, 103, 104, 105]
N_NEW = 24


@pytest.fixture(scope="module")
def jax_ref():
    j = JaxLLMServer(init_random=True, temperature=0.0, **COMMON)
    j.load()
    return j, {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}


def port_server(params, **extra):
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


def close_fleet(fleet):
    for r in fleet.members():
        svc = getattr(r, "_batcher_service", None)
        if svc is not None:
            svc.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "seeded"])
def test_kill_busiest_replica_mid_decode_streams_equal_unfaulted(jax_ref, temperature):
    extra = dict(temperature=temperature, top_k=20)
    reps = [port_server(jax_ref[1], **extra) for _ in range(3)]
    expected = [reps[0].generate([p], max_new_tokens=N_NEW, seed=SEEDS[i])["tokens"][0]
                for i, p in enumerate(PROMPTS)]
    if temperature == 0.0:
        assert expected == [jax_ref[0].generate([p], max_new_tokens=N_NEW)["tokens"][0]
                            for p in PROMPTS]
    fleet = ReplicaSet(reps)
    fleet.reinstate_after_s = 3600.0   # the victim stays out (no probe)
    fleet.retry_budget = RetryBudget(ratio=1.0, min_retries=16)
    streams = [[] for _ in PROMPTS]
    events = [[] for _ in PROMPTS]

    def on_token(i):
        def cb(tok):
            if tok is None:
                return
            events[i].append(tok)
            if not isinstance(tok, ResumeMarker):
                streams[i].append(int(tok))
        return cb

    batchers = [ensure_stream_service(r).batcher for r in reps]
    free_before = [b._allocator.free_count() for b in batchers]
    # armed once every client is mid-stream: the busiest loop still owes
    # tokens, so it takes the kill on its next turn
    killer = BatcherKiller(trigger=lambda b: all(len(s) >= 2 for s in streams),
                           busiest=True).install(*batchers)
    try:
        futs = [fleet.submit_stream(p, N_NEW, seed=SEEDS[i], on_token=on_token(i))
                for i, p in enumerate(PROMPTS)]
        outs = [f.result(TIMEOUT) for f in futs]
        assert killer.kills == 1
        victim_b = killer.killed
        victim = reps[batchers.index(victim_b)]
        assert outs == expected and streams == expected
        markers = [[e for e in ev if isinstance(e, ResumeMarker)] for ev in events]
        resumed = [i for i, m in enumerate(markers) if m]
        assert resumed, "the kill resumed no stream"
        for i in resumed:
            assert len(markers[i]) == 1
            at = events[i].index(markers[i][0])
            assert markers[i][0].tokens_delivered == at >= 2
        assert victim in fleet.ejected_members() and victim not in fleet._dispatchable()
        stats = fleet.llm_stats()
        assert stats["fleet_ejections_total"] == 1
        assert stats["fleet_resumes_total"] == len(resumed)
        assert stats["fleet_resumed_tokens_total"] == sum(markers[i][0].tokens_delivered
                                                          for i in resumed)
        assert stats["fleet_resume_journal_depth"] == 0
        assert stats["fleet_retry_budget_exhausted_total"] == 0
        # the crash path released the dead slots: every page back
        assert victim_b.crashed is not None
        LeakSweep(victim_b).assert_clean("the kill")
        assert [b._allocator.free_count() for b in batchers] == free_before
        # the tallies reach the scrape as the JAX registry names them
        reg, ref = MetricsRegistry(), JaxRegistry()
        reg.sync_llm(fleet)
        text, want = reg.expose().decode(), ref.expose().decode()
        for name in ("seldon_fleet_ejections_total", "seldon_fleet_resumes_total",
                     "seldon_fleet_resumed_tokens_total", "seldon_fleet_reinstatements_total",
                     "seldon_fleet_retry_budget_exhausted_total",
                     "seldon_fleet_resume_journal_depth"):
            assert f"# TYPE {name}" in text and f"# TYPE {name}" in want, name
        line = [ln for ln in text.splitlines() if ln.startswith("seldon_fleet_resumes_total")]
        assert float(line[0].rsplit(" ", 1)[1]) == len(resumed)
        # the autoscaler reads the ejection as a replace signal on its very
        # next tick (no stability window), as the JAX package's does
        from seldon_core_tpu_torch.controlplane.autoscaler import (SCALE_UP, Autoscaler,
                                                                   AutoscalerConfig)

        built = []

        class Spare:
            def load(self):
                pass

        auto = Autoscaler(fleet, config=AutoscalerConfig(min_replicas=1, max_replicas=4,
                                                         up_stable_ticks=99, cooldown_s=0.0),
                          replica_factory=lambda: built.append(Spare()) or built[-1])
        assert sum(1 for s in auto.signals() if s.ejected) == 1
        decision = auto.tick()
        assert decision.action == SCALE_UP and "ejected" in decision.reason
        assert decision.reason == "1 replica(s) ejected — replacing" and decision.target == 3
        assert len(built) == 1 and len(fleet.members()) == 4  # corpse + 2 survivors + spare
    finally:
        close_fleet(fleet)


def test_reinstatement_probe_restarts_the_loop(jax_ref):
    """One of two replicas dies on its first loop turn: the request fails
    over before its first token, the victim is ejected and stays out inside
    the quarantine; past it on the FaultClock, the next request probes the
    victim, whose loop restarts on a new thread, answers the unfaulted
    tokens and is reinstated with every page back."""
    r1, r2 = port_server(jax_ref[1], max_new_tokens=6), port_server(jax_ref[1], max_new_tokens=6)
    clk = FaultClock()
    fleet = ReplicaSet([r1, r2])
    fleet.clock = clk
    fleet.heartbeat_timeout_s = 0  # the loops' heartbeats are on wall time
    fleet.retry_budget = RetryBudget(clock=clk)
    expected = r1.generate([[5, 9, 17]], max_new_tokens=6)["tokens"][0]
    b1 = ensure_stream_service(r1).batcher
    free = b1._allocator.free_count()
    killer = BatcherKiller().install(b1)  # fires on r1's first turn
    try:
        assert fleet.submit_sync([5, 9, 17], 6) == expected
        killer.killed_thread.join(TIMEOUT)  # the crash path's end
        assert not killer.killed_thread.is_alive() and b1._thread is None
        assert killer.kills == 1 and b1.crashed is not None
        assert fleet.ejected_members() == [r1]
        assert fleet.submit_sync([5, 9, 17], 6) == expected
        assert fleet.ejected_members() == [r1] and b1._thread is None
        clk.advance(fleet.reinstate_after_s + 0.1)
        assert fleet.submit_sync([5, 9, 17], 6) == expected
        assert fleet.ejected_members() == [] and b1.crashed is None
        assert b1._thread.is_alive() and b1._thread is not killer.killed_thread
        stats = fleet.llm_stats()
        assert (stats["fleet_ejections_total"], stats["fleet_reinstatements_total"]) == (1, 1)
        LeakSweep(b1).assert_clean("the reinstatement")
        assert b1._allocator.free_count() == free
    finally:
        close_fleet(fleet)


def test_broken_device_stays_ejected(jax_ref):
    """A crash whose wait on the stream fails (a sticky device error) marks
    the batcher broken: its probe's restarted loop dies at once, the probe
    fails, and the replica stays ejected while the survivor serves."""
    r1, r2 = port_server(jax_ref[1], max_new_tokens=6), port_server(jax_ref[1], max_new_tokens=6)
    clk = FaultClock()
    fleet = ReplicaSet([r1, r2])
    fleet.clock = clk
    fleet.heartbeat_timeout_s = 0
    fleet.retry_budget = RetryBudget(clock=clk)
    expected = r2.generate([[5, 9, 17]], max_new_tokens=6)["tokens"][0]
    b1 = ensure_stream_service(r1).batcher

    def sticky():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    b1._quiesce = sticky
    BatcherKiller().install(b1)
    try:
        assert fleet.submit_sync([5, 9, 17], 6) == expected
        assert b1._broken is not None and fleet.ejected_members() == [r1]
        clk.advance(fleet.reinstate_after_s + 0.1)
        assert fleet.submit_sync([5, 9, 17], 6) == expected  # the probe failed over
        assert fleet.ejected_members() == [r1]
        assert "cannot be trusted" in str(b1.crashed)
        assert fleet.llm_stats()["fleet_reinstatements_total"] == 0
    finally:
        close_fleet(fleet)


@pytest.mark.parametrize("transport", ["device", "network"])
def test_poisoned_handoff_fails_one_request_not_the_batch(jax_ref, transport):
    s = port_server(jax_ref[1], max_new_tokens=4, continuous_batching=0)
    expected = s.generate([[5, 9, 17]], max_new_tokens=4)["tokens"][0]
    b = ContinuousBatcher(s, device="cpu", max_slots=2, max_len=32, len_buckets=(8,),
                          page_size=8, disaggregation="remote_prefill", prefill_workers=1,
                          handoff_transport=transport)
    try:
        poisoner = HandoffPoisoner(b, first_n=1)
        with pytest.raises(Exception):
            b.submit([40, 3, 22, 8], 4).result(TIMEOUT)
        assert poisoner.poisoned == 1 and b.crashed is None
        assert b.submit([5, 9, 17], 4).result(TIMEOUT) == expected
        assert b.page_stats()["kv_pages_in_use"] == 0
        LeakSweep(b).assert_clean("a poisoned handoff")
    finally:
        b.close()


def test_killer_waits_for_its_trigger_and_fires_once():
    """``BatcherKiller``: an event trigger, a predicate, the busiest rule
    (a sibling with more active slots takes it), one shot."""
    class B:
        def __init__(self, active):
            self._slots = [types.SimpleNamespace(active=a) for a in active]

    gate = threading.Event()
    quiet, busy = B([True, False]), B([True, True])
    killer = BatcherKiller(trigger=gate, busiest=True).install(quiet, busy)
    killer(busy)                         # not triggered
    gate.set()
    killer(quiet)                        # a busier sibling takes it
    with pytest.raises(SeldonError, match="chaos"):
        killer(busy)
    killer(busy)                         # disarmed
    assert (killer.kills, killer.killed) == (1, busy)
    assert quiet._chaos is killer and busy._chaos is killer


def test_concurrent_generations_stress():
    """More fleet generations than cores, through the dispatch pool, with
    a fast thread switch: replica 0 dies after 3 tokens of every
    generation it serves until it is ejected, replica 1 serves the rest
    (whole or resumed). Every client gets FULL once, with its one marker
    where it resumed; the journal, the in-flight dispatch counts and the
    budget's tallies agree afterwards."""
    import os
    import sys

    S = SIDES["port"]

    def die(i, prompt, max_new, on_token, seed, resume_tokens):
        for t in FULL[:3]:
            on_token(t)
        a.svc.batcher.crashed = RuntimeError("loop died")
        on_token(None)
        raise S.SeldonError("batcher loop died", status_code=503)

    def serve(i, prompt, max_new, on_token, seed, resume_tokens):
        assert prompt == PROMPT + FULL[:resume_tokens]
        for t in FULL[resume_tokens:]:
            on_token(t)
        return FULL[resume_tokens:]

    a, b = StubReplica(die), StubReplica(serve)
    fleet = ReplicaSet([a, b])
    fleet.retry_budget = RetryBudget(ratio=1.0, min_retries=64)
    n = 4 * (os.cpu_count() or 4)
    streams = [[] for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        futs = [fleet.submit(PROMPT, len(FULL), seed=i, on_token=streams[i].append)
                for i in range(n)]
        outs = [f.result(TIMEOUT) for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert outs == [FULL] * n
    n_markers = 0
    for st in streams:
        marks = [x for x in st if isinstance(x, ResumeMarker)]
        assert len(marks) <= 1 and st[-1] is None and st.count(None) == 1
        if marks:
            assert st.index(marks[0]) == marks[0].tokens_delivered == 3
            n_markers += 1
        assert [x for x in st if isinstance(x, int)] == FULL
    assert n_markers >= 1 and fleet._resumes_total == n_markers
    assert fleet._resumed_tokens_total == 3 * n_markers
    assert fleet.retry_budget.snapshot()["retries_in_window"] == n_markers
    assert fleet._journal.depth() == 0 and fleet._dispatched == {}
    assert fleet.ejected_members() == [a] and fleet._ejections_total == 1
    assert fleet._dispatch_pool._threads[0] <= 32


def test_dropped_fleet_is_collected_and_its_dispatch_threads_end():
    """The dispatch pool's idle threads hold nothing of the fleet: once the
    caller drops it, the fleet (with its replicas and whatever device
    memory they hold) is collected, and the threads end."""
    import gc
    import weakref

    def serve(i, prompt, max_new, on_token, seed, resume_tokens):
        for t in FULL:
            on_token(t)
        return list(FULL)

    before = set(threading.enumerate())
    reps = [StubReplica(serve), StubReplica(serve)]
    fleet = ReplicaSet(reps)
    futs = [fleet.submit(PROMPT, len(FULL), seed=i, on_token=lambda t: None) for i in range(4)]
    assert [f.result(TIMEOUT) for f in futs] == [FULL] * 4
    threads = [t for t in set(threading.enumerate()) - before
               if t.name.startswith("fleet-dispatch")]
    assert threads
    ref, rep_ref = weakref.ref(fleet), weakref.ref(reps[0])
    del fleet, futs, reps
    gc.collect()
    assert ref() is None and rep_ref() is None
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
