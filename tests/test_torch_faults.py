"""The port's fault harness and the pieces of fleet recovery
(``seldon_core_tpu_torch/testing/faults.py``,
``runtime/resilience.RetryBudget`` / ``ResumeJournal``,
``servers/llmserver.fast_forward_key``, the batcher's ``resume_tokens``)
held against the JAX package's on the CPU, and the resume marker on the
port's transports:

- ``FaultClock``, ``FaultSchedule`` (flaps, seeded, the last entry
  repeating) and ``FaultyComponent`` behave as JAX's, alone and behind each
  engine's breaker (JAX ``tests/test_faults.py:41-80``);
- ``RetryBudget`` grants and refuses as JAX's on one clock; the journal
  drops a straggler after ``discard``;
- ``fast_forward_key(seed, n)`` is the key an unfaulted slot holds after n
  tokens, and a batcher admission with ``resume_tokens=n`` continues an
  unfaulted seeded generation exactly (greedy needs no fast-forward);
- over REST and gRPC a fleet's resume is one in-band event, the events
  equal the JAX apps' on the same stub replicas, and a spent retry budget
  answers 503 with the JAX app's ``Retry-After`` and RESOURCE_EXHAUSTED.
"""

import asyncio
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp import web

import grpc
import jax

from seldon_core_tpu.components.component import SeldonComponent as JaxComponent
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import SeldonError as JaxSeldonError
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.runtime.engine import ReplicaSet as JaxReplicaSet
from seldon_core_tpu.runtime.resilience import ResilienceConfig as JaxResilienceConfig
from seldon_core_tpu.runtime.resilience import ResumeJournal as JaxResumeJournal
from seldon_core_tpu.runtime.resilience import RetryBudget as JaxRetryBudget
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.testing import faults as jax_faults
from seldon_core_tpu.transport import grpc_client
from seldon_core_tpu.transport.grpc_server import make_component_server as jax_grpc_server
from seldon_core_tpu.transport.rest import make_component_app as jax_app
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import PredictorSpec
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.runtime.engine import GraphEngine, ReplicaSet
from seldon_core_tpu_torch.runtime.resilience import (ResilienceConfig, ResumeJournal,
                                                      RetryBudget)
from seldon_core_tpu_torch.servers.llmserver import LLMServer, fast_forward_key, seed_key
from seldon_core_tpu_torch.testing import faults
from seldon_core_tpu_torch.transport.grpc_server import make_component_server
from seldon_core_tpu_torch.transport.rest import make_component_app, start

TIMEOUT = 60.0


# ----------------------------------------------------------- the harness
def test_fault_clock_is_manual():
    for mod in (faults, jax_faults):
        clock = mod.FaultClock(start=100.0)
        assert clock() == clock.now() == 100.0
        assert clock.advance(2.5) == 102.5 and clock() == 102.5
        with pytest.raises(ValueError):
            clock.advance(-1)


def pattern(schedule):
    return [(sp.error is None, sp.latency_s,
             None if sp.error is None else (sp.error.status_code, sp.error.reason))
            for sp in schedule.specs]


@pytest.mark.parametrize("build", [
    lambda m: m.FaultSchedule.seeded(seed=42, n=50, error_rate=0.3, latency_s=0.01,
                                     latency_jitter_s=0.02),
    lambda m: m.FaultSchedule.seeded(seed=43, n=50, error_rate=0.3),
    lambda m: m.FaultSchedule.flaps("EEoO.sFf", latency_s=0.5, status_code=500),
    lambda m: m.FaultSchedule.always_ok(0.25),
    lambda m: m.FaultSchedule.always_fail(status_code=502),
], ids=["seeded-42", "seeded-43", "flaps", "always-ok", "always-fail"])
def test_schedules_equal_jax(build):
    got, want = build(faults), build(jax_faults)
    assert pattern(got) == pattern(want)
    assert len(got) == len(want)
    assert pattern(faults.FaultSchedule([got[len(got) + 5]])) == pattern(
        jax_faults.FaultSchedule([want[len(want) + 5]]))  # the last entry repeats


def test_schedule_rules():
    a = faults.FaultSchedule.seeded(seed=42, n=50, error_rate=0.3)
    assert pattern(a) == pattern(faults.FaultSchedule.seeded(seed=42, n=50, error_rate=0.3))
    assert pattern(a) != pattern(faults.FaultSchedule.seeded(seed=43, n=50, error_rate=0.3))
    s = faults.FaultSchedule.flaps("EO")
    assert s[0].error is not None and s[1].error is None and s[100].error is None
    with pytest.raises(ValueError):
        faults.FaultSchedule([])
    with pytest.raises(ValueError, match="unknown flap char"):
        faults.FaultSchedule.flaps("EX")


def drive_component(mod, sched):
    """Each call's outcome and the clock after it, for a FaultyComponent of
    ``sched`` over an inner doubler; ``inject_faults`` builds the same."""
    class Doubler:
        def predict(self, X, names, meta=None):
            return np.asarray(X) * 2

    clock = mod.FaultClock(start=0.0)
    comp = mod.inject_faults(Doubler(), sched(mod), clock=clock)
    seen = []
    comp.on_call = lambda i, spec: seen.append((i, spec.error is None))
    out = []
    for _ in range(5):
        try:
            out.append(np.asarray(asyncio.run(comp.predict(np.ones((1, 1)), []))).tolist())
        except Exception as e:  # noqa: BLE001 — the scheduled error
            out.append((type(e).__name__, e.status_code, e.reason))
        out.append(clock())
    bare = mod.FaultyComponent(mod.FaultSchedule.always_ok())
    extra = [asyncio.run(bare.route(np.ones((1, 1)), [])),
             np.asarray(asyncio.run(bare.aggregate([np.ones((1, 2)), np.zeros((1, 2))],
                                                   []))).tolist(),
             np.asarray(asyncio.run(bare.transform_input(np.ones((1, 1)), []))).tolist()]
    return out, comp.calls, seen, extra, comp.is_async


def test_faulty_component_equals_jax():
    def sched(mod):
        return mod.FaultSchedule.flaps("EOE", latency_s=0.25)

    got, want = drive_component(faults, sched), drive_component(jax_faults, sched)
    assert got == want
    assert got[0][:4] == [("SeldonError", 503, "INJECTED_FAULT"), 0.25, [[2.0]], 0.5]
    assert got[1] == 5 and got[4] is True


class _Echo:
    def predict(self, X, names, meta=None):
        return np.asarray(X)


def breaker_run(engine_cls, spec_cls, mod, config_cls, message_cls, **engine_kw):
    """Five errors then success behind each engine's breaker (threshold 3,
    reset 1 s on the FaultClock): the status of each of 8 predictions, the
    component's calls, after the clock passes the reset window."""
    clock = mod.FaultClock()
    comp = mod.FaultyComponent(mod.FaultSchedule.flaps("EEEEEO"), clock=clock)
    spec = spec_cls.from_dict({"name": "p", "graph": {"name": "m", "type": "MODEL"}})
    engine = engine_cls(spec, components={"m": comp},
                        resilience=config_cls(breaker_failures=3, breaker_reset_s=1.0,
                                              clock=clock), **engine_kw)
    codes = []
    for i in range(8):
        if i == 5:
            clock.advance(1.5)
        try:
            engine.predict_sync(message_cls.from_dict({"data": {"ndarray": [[1.0]]}}))
            codes.append(200)
        except Exception as e:  # noqa: BLE001 — the status under test
            codes.append((e.status_code, getattr(e, "reason", None)))
    return codes, comp.calls


def test_faulty_component_behind_the_breaker_equals_jax():
    got = breaker_run(GraphEngine, PredictorSpec, faults, ResilienceConfig, SeldonMessage,
                      device="cpu")
    want = breaker_run(JaxEngine, JaxSpec, jax_faults, JaxResilienceConfig, JaxMessage)
    assert got == want
    assert got[0][3] == (503, "CIRCUIT_OPEN") and got[1] < 8


def test_retry_budget_equals_jax():
    def run(budget_cls, clock_cls):
        clock = clock_cls()
        budget = budget_cls(ratio=0.5, min_retries=1, window_s=10.0, clock=clock)
        out = []
        for step in range(12):
            budget.note_request()
            out.append(budget.take() if step % 2 else budget.try_spend())
            clock.advance(3.0 if step % 3 == 2 else 0.5)
        return out, budget.snapshot()

    got, want = run(RetryBudget, faults.FaultClock), run(JaxRetryBudget, jax_faults.FaultClock)
    assert got == want
    assert True in got[0] and False in got[0] and got[1]["exhausted_total"] > 0


def test_journal_equals_jax_and_drops_stragglers():
    class Entry:
        def __init__(self):
            self.tokens = []

    def run(journal_cls):
        j = journal_cls()
        a, b = j.record(Entry()), j.record(Entry())
        j.append(a, 5)
        j.append(a, 6)
        j.append(b, 9)
        snap = (j.delivered(a), j.delivered(b), j.depth())
        j.discard(a)
        j.discard(a)
        j.append(a, 7)  # a dead replica's straggler
        return snap, j.delivered(a), j.get(a), j.depth(), j.get(b).tokens

    assert run(ResumeJournal) == run(JaxResumeJournal) == (
        ([5, 6], [9], 2), [], None, 1, [9])


# ------------------------------------------------------- the resume chain
KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=12, len_buckets=(16,),
              batch_buckets=(1, 4), eos_id=-1, seed=3, kv_page_size=8)
IDS = [40, 3, 22, 8, 11, 60, 2, 33]


@pytest.fixture(scope="module")
def params():
    j = JaxLLMServer(init_random=True, temperature=0.0, **COMMON)
    j.load()
    return {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}


def port_server(params, **extra):
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


def test_fast_forward_key_is_the_unfaulted_slots_key(params):
    """A seeded sampled slot's key, read as each token surfaces (one
    dispatch in flight at most, so the device has run exactly the steps
    whose tokens are out), is ``fast_forward_key(seed, n)`` after n
    tokens."""
    s = port_server(params, temperature=0.8, top_k=20)
    b = ContinuousBatcher(s, device="cpu", max_slots=2, max_len=40, pipeline_depth=1)
    seen = []

    def on_token(tok):
        if tok is not None:
            slot = next(i for i, sl in enumerate(b._slots) if sl.active)
            seen.append(int(b._keys[slot]))

    try:
        toks = b.submit(IDS, 12, seed=7, on_token=on_token).result(TIMEOUT)
    finally:
        b.close()
    assert len(toks) == len(seen) == 12
    assert seen == [fast_forward_key(7, n) for n in range(1, 13)]
    assert fast_forward_key(7, 0) == seed_key(7)


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "seeded"])
@pytest.mark.parametrize("split", [1, 5, 11])
def test_resume_tokens_continue_the_unfaulted_chain(params, temperature, split):
    """An admission of the prompt plus the first ``split`` tokens of an
    unfaulted seeded run, with ``resume_tokens=split``, gives that run's
    remaining tokens exactly; without the fast-forward a sampled resume
    leaves the chain."""
    s = port_server(params, temperature=temperature, top_k=20)
    b = ContinuousBatcher(s, device="cpu", max_slots=2, max_len=40)
    try:
        full = b.submit(IDS, 12, seed=11).result(TIMEOUT)
        rest = b.submit(IDS + full[:split], 12 - split, seed=11,
                        resume_tokens=split).result(TIMEOUT)
        plain = b.submit(IDS + full[:split], 12 - split, seed=11).result(TIMEOUT)
    finally:
        b.close()
    assert full == s.generate([IDS], max_new_tokens=12, seed=11)["tokens"][0]
    assert rest == full[split:]
    if temperature > 0:
        assert plain != full[split:]


# ---------------------------------------------------------- transports
FULL = [104, 105, 33, 32, 116, 104, 101, 114]
PROMPT = [1, 2, 3]


class _StubAllocator:
    def stats(self):
        return (10, 0, 0)


class _StubBatcher:
    def __init__(self):
        self._pending, self._slots, self.paged = [], [], False
        self._allocator = _StubAllocator()
        self.crashed, self._task, self._thread, self.heartbeat = None, None, None, 0.0

    def accommodates(self, prompt, max_new_tokens=None):
        return True


class _Service:
    def __init__(self, script):
        self.script = script
        self.batcher = _StubBatcher()

    def submit_sync(self, prompt, max_new_tokens=None, on_token=None, resume_tokens=0, **kw):
        return self.script(self, list(prompt), max_new_tokens, on_token, resume_tokens)


def stub_fleet(fleet_cls, component_cls, error_cls, budget_cls, die_after=3, budget=True):
    """A two-replica fleet of each package: the first replica streams
    ``die_after`` tokens and dies as a crashed loop does, the second
    resumes (or, with the budget spent, is never reached)."""
    class Replica(component_cls):
        def __init__(self, script):
            super().__init__()
            self._batcher_service = _Service(script)

        def generate(self, prompts, *a, **kw):
            raise AssertionError("the fleet's transports serve through its batchers")

    def die(svc, prompt, max_new, on_token, resume_tokens):
        for t in FULL[:die_after]:
            on_token(t)
        svc.batcher.crashed = RuntimeError("loop died")
        on_token(None)
        raise error_cls("batcher loop died", status_code=503)

    def resume(svc, prompt, max_new, on_token, resume_tokens):
        assert prompt == PROMPT + FULL[:resume_tokens] and resume_tokens == die_after
        for t in FULL[resume_tokens:]:
            on_token(t)
        return FULL[resume_tokens:]

    fleet = fleet_cls([Replica(die), Replica(resume)])
    if not budget:
        fleet.retry_budget = budget_cls(ratio=0.0, min_retries=0)
    return fleet


def port_fleet(**kw):
    return stub_fleet(ReplicaSet, SeldonComponent, SeldonError, RetryBudget, **kw)


def jax_fleet(**kw):
    return stub_fleet(JaxReplicaSet, JaxComponent, JaxSeldonError, JaxRetryBudget, **kw)


def jax_threaded_app(comp):
    """(port, stop) of the JAX package's aiohttp app for ``comp``."""
    app = jax_app(comp)
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        run.port = sock.getsockname()[1]
        loop.run_until_complete(web.SockSite(runner, sock).start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(10)
    return run.port, lambda: loop.call_soon_threadsafe(loop.stop)


def post(port, body):
    """(status, Retry-After, body) of POST /v1/generate; SSE bodies as their
    events."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            raw = r.read().decode()
            status, retry = r.status, r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())
    if body.get("stream"):
        return status, retry, [json.loads(ln[6:]) for ln in raw.splitlines()
                               if ln.startswith("data: ")]
    return status, retry, json.loads(raw)


def rest_answers(body, **fleet_kw):
    jport, jstop = jax_threaded_app(jax_fleet(**fleet_kw))
    httpd, _ = start(make_component_app(port_fleet(**fleet_kw), device="cpu"))
    try:
        return post(httpd.server_address[1], body), post(jport, body)
    finally:
        jstop()
        httpd.shutdown()
        httpd.server_close()


def test_sse_resume_event_equals_jax():
    got, want = rest_answers({"prompt": PROMPT, "max_new_tokens": len(FULL), "stream": True})
    assert got == want
    events = got[2]
    assert events[:3] == [{"token": t, "text": None} for t in FULL[:3]]
    assert events[3] == {"resumed": True, "tokens_delivered": 3}
    assert [e["token"] for e in events[4:-1]] == FULL[3:]
    assert events[-1]["done"] is True and events[-1]["tokens"] == FULL


def test_json_resume_equals_jax():
    got, want = rest_answers({"prompt": PROMPT, "max_new_tokens": len(FULL)})
    assert got == want
    assert got[:2] == (200, None) and got[2]["tokens"] == FULL


def test_spent_budget_answers_503_with_retry_after_as_jax():
    got, want = rest_answers({"prompt": PROMPT, "max_new_tokens": len(FULL)}, budget=False)
    assert (got[0], got[1], got[2]["status"]["reason"]) == \
        (want[0], want[1], want[2]["status"]["reason"])
    assert got[0] == 503 and got[1] == "5"  # the fleet's reinstate_after_s
    assert "retry budget" in got[2]["status"]["info"]


def served(server_fn, component):
    server = server_fn(component, host="127.0.0.1", port=None)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return f"127.0.0.1:{port}", server


def grpc_answer(target, body):
    try:
        return [m.json_data for m in grpc_client.call_stream(
            target, "GenerateStream", JaxMessage.from_dict({"jsonData": body}),
            timeout_s=TIMEOUT)]
    except grpc.RpcError as e:
        return (e.code(), e.details())


@pytest.mark.parametrize("budget", [True, False], ids=["resumed", "budget-spent"])
def test_grpc_resume_chunk_and_status_equal_jax(budget):
    body = {"prompt": PROMPT, "max_new_tokens": len(FULL)}
    ptarget, psrv = served(make_component_server, port_fleet(budget=budget))
    jtarget, jsrv = served(jax_grpc_server, jax_fleet(budget=budget))
    try:
        got, want = grpc_answer(ptarget, body), grpc_answer(jtarget, body)
    finally:
        psrv.stop(None)
        jsrv.stop(None)
    assert got == want
    if budget:
        assert got[3] == {"resumed": True, "tokens_delivered": 3}
        assert [e["token"] for e in got[:3] + got[4:-1]] == FULL == got[-1]["tokens"]
    else:
        # the shed comes after three tokens went out: the stream's status
        assert got[0] == grpc.StatusCode.RESOURCE_EXHAUSTED and "retry budget" in got[1]
