"""The port's flight recorder (``seldon_core_tpu_torch/runtime/flight.py``),
its hooks in the graph-replayed batcher and its prefill workers, and its
surfaces (``/debug/timeline``, gRPC ``DebugTimeline``, the trace ids on
REST, SSE and gRPC), held against the JAX package on the CPU:

- the same script of ``begin`` / ``record`` / ``extend`` / ``complete`` on
  a fake clock, fed to JAX's ``FlightRecorder`` and the port's: the
  timelines and the snapshot are equal key by key (ids aside), the span
  trees equal in names, parent links, tags and offsets (1e-9 s), the
  retention tallies equal; ring overflow, worst gap and TTFT,
  complete-without-begin and the ``n`` clamp likewise;
- a tiny float32 paged batcher in the port and in JAX, tracing on, same
  weights (``params_from_jax``) and prompts, greedy: per request the
  event kinds and their token counts are equal; the port's tokens with
  tracing on equal tracing off and JAX's;
- disaggregated, on the device and the network transport (127.0.0.1):
  each remote request's timeline has ``handoff_staged``,
  ``handoff_compute``, ``handoff_transfer`` and ``handoff_import`` in that
  order, and its tokens equal local admission's;
- a ``BatcherKiller`` crash under a fleet leaves no open segment, the
  victim's requests complete "error", each survivor's resumed timeline
  has one ``resume`` event with the delivered tokens, and ``llm.resume``
  carries the request's trace id;
- ``trace_id`` on REST JSON, SSE (``X-Trace-Id`` == the done event's) and
  gRPC (``x-trace-id`` initial metadata == the done event's); a predict
  joins the transport span's trace; ``DebugTimeline`` equals REST's
  ``/debug/timeline``; the scaling snapshot's keys equal JAX's."""

import asyncio
import json
import threading
import urllib.request

import numpy as np
import pytest

import jax

import seldon_core_tpu.tracing as jtracing
import seldon_core_tpu_torch.tracing as tracing
from seldon_core_tpu.observability.timeline import scaling_snapshot as jax_scaling
from seldon_core_tpu.runtime import flight as jflight
from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.observability.timeline import scaling_snapshot
from seldon_core_tpu_torch.runtime import flight
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, ensure_stream_service
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.tracing import TraceContext, Tracer, get_tracer, set_tracer

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3)
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13], [7], [60, 61, 62, 63, 64, 65]]
BKW = dict(max_slots=3, max_len=40, len_buckets=(8,), page_size=8, prefill_chunk=4)
TIMEOUT = 120
TRACE_ID, SPAN_ID = "ab" * 16, "cd" * 8


@pytest.fixture()
def enabled_tracer():
    old = get_tracer()
    t = Tracer(enabled=True)
    set_tracer(t)
    yield t
    set_tracer(old)


@pytest.fixture(scope="module")
def pair():
    """(the JAX server, the port server on its weights)."""
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    p = LLMServer(device="cpu", **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    return j, p


# ------------------------------------------------------ the recorder alone
class _Clock:
    """A fake perf-counter: each read advances 1 ms; ``tick`` jumps."""

    def __init__(self, start=50.0):
        self.t = start

    def __call__(self):
        self.t += 0.001
        return self.t

    def tick(self, dt):
        self.t += dt


# one script a case: the operations fed to both recorders, and the tail
# thresholds; traces are (trace_id, parent_span_id, sampled, ingress) or
# None (a fresh internal trace)
T_HEAD = (TRACE_ID, SPAN_ID, True, "rest:/v1/generate")
T_UNSAMPLED = ("ef" * 16, "12" * 8, False, "grpc:GenerateStream")
SCRIPTS = {
    "head": ((None, None), [
        ("begin", 0, T_HEAD, 49.9, 12, {"tenant": "acme", "slo_class": "batch",
                                        "adapter_id": 2}),
        ("record", 0, "prefix_hit", {"tokens": 8, "blocks": 1}),
        ("record", 0, "prefill_chunk", {"start": 8, "tokens": 4, "dur_s": 0.0004}),
        ("record", 0, "resume", {"tokens": 3}),
        ("record", 0, "first_token", {"tokens": 1}),
        ("tick", 0.02),
        ("record", 0, "page_grow", {"pages": 1, "dur_s": 0.0002}),
        ("record", 0, "step", {"tokens": 1, "t_dispatch": 50.01}),
        ("record", 0, "step", {"tokens": 4, "offered": 4, "accepted": 4, "t_dispatch": 50.03}),
        ("complete", 0, "done", 6)]),
    "handoff": ((None, None), [
        ("begin", 1, None, None, 5, None),
        ("record", 1, "handoff_staged", {"job_id": 7, "pages": 1}),
        ("extend", 1, [(50.004, "handoff_compute", {"worker": "prefill-worker-0",
                                                      "dur_s": 0.002}),
                       (50.0045, "handoff_transfer", {"bytes": 4096, "dur_s": 0.0005})]),
        ("record", 1, "handoff_import", {"bytes": 4096, "dur_s": 0.0003}),
        ("record", 1, "first_token", {"tokens": 1}),
        ("record", 1, "step", {"tokens": 1, "t_dispatch": 50.0}),
        ("complete", 1, "done", 2)]),
    "tail_ttft": ((0.01, None), [
        ("begin", 0, T_UNSAMPLED, None, 3, None),
        ("tick", 0.05),
        ("record", 0, "first_token", {"tokens": 1}),
        ("complete", 0, "done", 1)]),
    "tail_gap": ((None, 0.1), [
        ("begin", 0, T_UNSAMPLED, None, 3, None),
        ("record", 0, "first_token", {"tokens": 1}),
        ("tick", 0.2),
        ("record", 0, "step", {"tokens": 1, "t_dispatch": 50.0}),
        ("complete", 0, "done", 2)]),
    "drop_and_shed": ((1.0, 1.0), [
        ("begin", 0, T_UNSAMPLED, None, 3, None),
        ("begin", 1, T_HEAD, None, 4, None),
        ("record", 0, "first_token", {"tokens": 1}),
        ("record", 1, "shed", {"why": "preempted: local prefill"}),
        ("complete", 1, "preempted", 0),
        ("record", 0, "shed", {"why": "page pool exhausted"}),
        ("complete", 0, "shed", 1),
        ("complete", 0, "shed", 1)]),   # a second complete: nothing
}


def _ctx(mod, t):
    return None if t is None else mod.TraceContext(trace_id=t[0], parent_span_id=t[1],
                                                   sampled=t[2], ingress=t[3])


def _run_script(mod, fmod, ops, thresholds, ring_size=512, keep=64):
    """Feed ``ops`` to ``fmod``'s recorder on a fake clock, ``mod``'s span
    clock anchored to a fixed wall; returns (recorder, tracer, the
    complete() results)."""
    mod.anchor(wall=lambda: 1_700_000_000.0, mono=lambda: 0.0)
    clock = _Clock()
    rec = fmod.FlightRecorder(2, ring_size=ring_size, keep=keep, tail_ttft_s=thresholds[0],
                              tail_gap_s=thresholds[1], clock=clock)
    tr = mod.Tracer(enabled=True)
    done = []
    for op in ops:
        if op[0] == "begin":
            rec.begin(op[1], _ctx(mod, op[2]), op[3], op[4], tags=op[5])
        elif op[0] == "record":
            rec.record(op[1], op[2], **op[3])
        elif op[0] == "extend":
            rec.extend(op[1], op[2])
        elif op[0] == "tick":
            clock.tick(op[1])
        else:
            done.append(rec.complete(op[1], op[2], op[3], tr))
    return rec, tr, done


def _strip_ids(timeline, traced):
    out = dict(timeline)
    if not traced:
        out.pop("trace_id")
    return out


def _tree(spans):
    """Spans as comparable rows: name, the index of its parent, tags,
    start and end relative to the first span's start, trace id."""
    index = {s.span_id: i for i, s in enumerate(spans)}
    t0 = spans[0].start
    return [(s.name, index.get(s.parent_id, s.parent_id), s.tags, s.start - t0, s.end - t0,
             s.trace_id, s.sampled) for s in spans]


@pytest.fixture()
def anchored():
    yield
    tracing.anchor()
    jtracing.anchor()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_recorder_script_equals_jax(anchored, name):
    thresholds, ops = SCRIPTS[name]
    got_rec, got_tr, got_done = _run_script(tracing, flight, ops, thresholds)
    want_rec, want_tr, want_done = _run_script(jtracing, jflight, ops, thresholds)
    traced = {op[1]: op[2] is not None for op in ops if op[0] == "begin"}
    assert [d is None for d in got_done] == [d is None for d in want_done]
    got_tl, want_tl = got_rec.timelines(), want_rec.timelines()
    assert [_strip_ids(t, traced[t["slot"]]) for t in got_tl] == \
        [_strip_ids(t, traced[t["slot"]]) for t in want_tl]
    assert got_rec.snapshot() == want_rec.snapshot()
    assert got_rec.retained == want_rec.retained
    assert got_tr.retained_total == want_tr.retained_total
    got_spans, want_spans = got_tr.drain(), want_tr.drain()
    assert len(got_spans) == len(want_spans)
    for g, w in zip(_tree(got_spans), _tree(want_spans)):
        assert g[:3] == w[:3] and g[6] == w[6]
        assert g[3] == pytest.approx(w[3], abs=1e-9) and g[4] == pytest.approx(w[4], abs=1e-9)
        if all(traced.values()):
            assert g[5] == w[5]
    assert got_rec.live_slots() == []
    if name == "head":
        tl = got_tl[0]
        assert tl["request_tags"] == {"tenant": "acme", "slo_class": "batch", "adapter_id": 2}
        assert tl["token_events_sum"] == tl["tokens"] == 6 and tl["sampling"] == "head"
        assert got_spans[0].parent_id == SPAN_ID and got_spans[0].name == \
            "llm.request rest:/v1/generate"
    if name.startswith("tail"):
        assert got_tl[0]["sampling"] == "tail" and got_spans[0].parent_id is None
        assert got_spans[0].tags["caller_span_id"] == "12" * 8
    if name == "drop_and_shed":
        assert [t["sampling"] for t in got_tl] == ["head", "drop"]
        assert got_done[-1] is None


def test_ring_overflow_worst_gap_ttft_equal_jax(anchored):
    ops = [("begin", 0, None, 49.0, 3, None), ("record", 0, "first_token", {"tokens": 1})]
    ops += [("record", 0, "step", {"tokens": 1})] * 4
    ops += [("tick", 0.2), ("record", 0, "step", {"tokens": 1})]
    ops += [("record", 0, "step", {"tokens": 1})] * 4
    ops += [("complete", 0, "done", 10)]
    out = []
    for mod, fmod in ((tracing, flight), (jtracing, jflight)):
        rec, _, done = _run_script(mod, fmod, ops, (None, None), ring_size=4)
        out.append((_strip_ids(done[0], False), rec.snapshot()))
    assert out[0] == out[1]
    tl = out[0][0]
    assert len(tl["events"]) == 4 and tl["events_dropped"] == 6
    assert out[0][1]["events_dropped_total"] == 6
    # the signals come from the segment, not the evicted ring
    assert tl["token_events_sum"] == 10
    assert tl["ttft_s"] == pytest.approx(1.003, abs=1e-9)
    assert tl["worst_gap_s"] == pytest.approx(0.201, abs=1e-9)


def test_complete_without_begin_and_n_clamp_equal_jax():
    for fmod in (flight, jflight):
        rec = fmod.FlightRecorder(2)
        assert rec.complete(1, "done", 5) is None
        rec.record(1, fmod.EV_STEP, tokens=1)
        rec.extend(1, [(1.0, "handoff_compute", {})])
        assert rec.timelines() == []
        for _ in range(3):
            rec.begin(0, None, None, prompt_tokens=1)
            rec.complete(0, "done", 1)
        assert [len(rec.timelines(n)) for n in (0, -5, 2, 99)] == [0, 0, 2, 3]
        assert rec.snapshot()["completed_total"] == 3


def test_event_kinds_equal_jax():
    names = [n for n in dir(flight) if n.startswith("EV_")]
    assert names == [n for n in dir(jflight) if n.startswith("EV_")]
    assert [getattr(flight, n) for n in names] == [getattr(jflight, n) for n in names]
    assert (flight.DEFAULT_RING, flight.DEFAULT_KEEP) == (jflight.DEFAULT_RING,
                                                          jflight.DEFAULT_KEEP)


# --------------------------------------------------------- the batcher
def _kinds(timeline):
    """A request's events as (kind, tokens), page growth apart: where a
    growth lands between steps follows the loop's timing, its count does
    not."""
    evs = timeline["events"]
    return ([(e["kind"], e.get("tokens")) for e in evs if e["kind"] != "page_grow"],
            sum(e["pages"] for e in evs if e["kind"] == "page_grow"))


def port_traced(server, prompts, tracing_on=True, **kw):
    b = ContinuousBatcher(server, device="cpu", tracing=tracing_on, **dict(BKW, **kw))
    try:
        ctxs = [TraceContext.from_traceparent(None, ingress="rest:/v1/generate")
                for _ in prompts]
        futs = [b.submit(p, 8, trace=ctxs[i]) for i, p in enumerate(prompts)]
        outs = [f.result(TIMEOUT) for f in futs]
    finally:
        b.close()
    return outs, b, ctxs


def test_batcher_timelines_equal_jax(pair):
    j, p = pair

    async def jax_run():
        b = JaxBatcher(j, layout="paged", tracing=True, **BKW)
        ctxs = [jtracing.TraceContext.from_traceparent(None, ingress="rest:/v1/generate")
                for _ in PROMPTS]
        outs = await asyncio.gather(*[b.submit(q, max_new_tokens=8, trace=ctxs[i])
                                      for i, q in enumerate(PROMPTS)])
        rec = b._flight
        await b.close()
        return outs, rec, ctxs

    jouts, jrec, jctxs = asyncio.run(jax_run())
    outs, b, ctxs = port_traced(p, PROMPTS)
    untraced, ub, _ = port_traced(p, PROMPTS, tracing_on=False)
    assert outs == untraced == jouts
    assert ub._flight is None
    got = {t["trace_id"]: t for t in b._flight.timelines()}
    want = {t["trace_id"]: t for t in jrec.timelines()}
    for i, prompt in enumerate(PROMPTS):
        g, w = got[ctxs[i].trace_id], want[jctxs[i].trace_id]
        assert _kinds(g) == _kinds(w), i
        assert (g["status"], g["tokens"], g["token_events_sum"], g["prompt_tokens"]) == \
            (w["status"], w["tokens"], w["token_events_sum"], w["prompt_tokens"]) == \
            ("done", 8, 8, len(prompt))
        chunks = [e for e in g["events"] if e["kind"] == "prefill_chunk"]
        assert [e["start"] for e in chunks] == list(range(0, len(prompt), 4))
        assert all(e["dur_s"] >= 0 for e in chunks)
        assert g["ttft_s"] > 0 and g["queue_wait_s"] >= 0
    assert b._flight.live_slots() == []
    snap, jsnap = b._flight.snapshot(), jrec.snapshot()
    assert (snap["completed_total"], snap["retained"], snap["events_dropped_total"]) == \
        (jsnap["completed_total"], jsnap["retained"], jsnap["events_dropped_total"]) == \
        (4, {"head": 4, "tail": 0, "drop": 0}, 0)
    # the scaling snapshot of the idle batcher: JAX's keys, and its values
    # where both read the same state
    mine, ref = scaling_snapshot(None, b, b._flight), jax_scaling(None, b, jrec)
    assert mine.keys() == ref.keys() and mine["requests"].keys() == ref["requests"].keys()
    for key in ("active_slots", "total_slots", "queue_depth", "steps_in_flight",
                "queue_by_class", "handoff_queue_depth", "ejected"):
        assert mine[key] == ref[key], key


def test_batcher_spans_root_at_the_ingress(pair, enabled_tracer):
    _, p = pair
    ctx = TraceContext.from_traceparent(f"00-{TRACE_ID}-{SPAN_ID}-01", ingress="rest:/v1/generate")
    b = ContinuousBatcher(p, device="cpu", **BKW)
    try:
        assert b._flight is not None  # the tracer's switch
        out = b.submit(PROMPTS[1], 8, trace=ctx).result(TIMEOUT)
    finally:
        b.close()
    spans = enabled_tracer.drain()
    assert {s.trace_id for s in spans} == {TRACE_ID}
    root = spans[0]
    assert (root.name, root.parent_id) == ("llm.request rest:/v1/generate", SPAN_ID)
    names = [s.name for s in spans[1:]]
    assert all(s.parent_id == root.span_id for s in spans[1:])
    assert names.count("llm.prefill_chunk") == 3 and names.count("llm.first_token") == 1
    assert names[0] == "queue.wait" and names[-1] == "llm.decode"
    assert sum(s.tags["tokens"] for s in spans if s.name == "llm.step") + 1 == len(out)
    assert enabled_tracer.retained_total["head"] == 1


@pytest.mark.parametrize("transport", ["device", "network"])
def test_disaggregated_handoff_events(pair, transport):
    _, p = pair
    local, _, _ = port_traced(p, PROMPTS)
    outs, b, ctxs = port_traced(p, PROMPTS, disaggregation="remote_prefill",
                                handoff_transport=transport)
    assert outs == local
    stages = ["handoff_staged", "handoff_compute", "handoff_transfer", "handoff_import"]
    for t in b._flight.timelines():
        kinds = [e["kind"] for e in t["events"]]
        assert [k for k in kinds if k.startswith("handoff")] == stages, kinds
        assert kinds.index("handoff_import") < kinds.index("first_token")
        assert "prefill_chunk" not in kinds
        ev = {e["kind"]: e for e in t["events"]}
        assert ev["handoff_compute"]["worker"] == "prefill-worker-0"
        assert ev["handoff_transfer"]["bytes"] == ev["handoff_import"]["bytes"] > 0
        assert all(ev[k]["dur_s"] >= 0 for k in stages[1:])
        assert t["token_events_sum"] == t["tokens"] == 8
    assert {t["trace_id"] for t in b._flight.timelines()} == {c.trace_id for c in ctxs}


def test_crash_leaves_no_segment_and_resume_is_recorded(pair, enabled_tracer):
    """A fleet of two replicas; the busiest loop is killed mid-decode. Its
    open timelines complete "error" in the crash path (none is left), and
    each resumed request's survivor timeline carries one ``resume`` event
    with the tokens its client already had; ``llm.resume`` is in that
    request's trace."""
    from seldon_core_tpu_torch.runtime.engine import ReplicaSet
    from seldon_core_tpu_torch.runtime.resilience import ResumeMarker, RetryBudget
    from seldon_core_tpu_torch.testing.faults import BatcherKiller

    j, p = pair
    params = {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}
    reps = []
    for _ in range(2):
        r = LLMServer(device="cpu", **dict(COMMON, max_new_tokens=16, len_buckets=(16, 48),
                                           continuous_batching=3,
                                           continuous_batching_max_len=64, kv_page_size=8))
        r.load(params=params)
        reps.append(r)
    expected = [reps[0].generate([q], max_new_tokens=16)["tokens"][0] for q in PROMPTS]
    fleet = ReplicaSet(reps)
    fleet.reinstate_after_s = 3600.0
    fleet.retry_budget = RetryBudget(ratio=1.0, min_retries=16)
    batchers = [ensure_stream_service(r).batcher for r in reps]
    assert all(x._flight is not None for x in batchers)
    streams = [[] for _ in PROMPTS]
    markers = [[] for _ in PROMPTS]

    def on_token(i):
        def cb(tok):
            if isinstance(tok, ResumeMarker):
                markers[i].append(tok.tokens_delivered)
            elif tok is not None:
                streams[i].append(tok)
        return cb

    killer = BatcherKiller(trigger=lambda _b: all(len(s) >= 2 for s in streams),
                           busiest=True).install(*batchers)
    ctxs = [TraceContext.from_traceparent(None, ingress="rest:/v1/generate") for _ in PROMPTS]
    try:
        futs = [fleet.submit(q, 16, on_token=on_token(i), trace=ctxs[i])
                for i, q in enumerate(PROMPTS)]
        outs = [f.result(TIMEOUT) for f in futs]
        killer.killed_thread.join(TIMEOUT)
        assert not killer.killed_thread.is_alive()
    finally:
        for r in reps:
            r._batcher_service.close()
    assert killer.kills == 1 and outs == expected and streams == expected
    victim = killer.killed
    survivor = batchers[1 - batchers.index(victim)]
    assert victim._flight.live_slots() == [] and survivor._flight.live_slots() == []
    dead = [t for t in victim._flight.timelines() if t["status"] == "error"]
    resumed = [i for i, m in enumerate(markers) if m]
    assert resumed and len(dead) == len(resumed)
    assert {t["trace_id"] for t in dead} == {ctxs[i].trace_id for i in resumed}
    by_trace = {}
    for t in survivor._flight.timelines():
        by_trace.setdefault(t["trace_id"], []).append(t)
    # the fleet's llm.resume span (the recorder's resume event materializes
    # under the same name, with a "tokens" tag)
    resume_spans = {s.trace_id: s for s in enabled_tracer.drain()
                    if s.name == "llm.resume" and "tokens_delivered" in s.tags}
    for i in resumed:
        (tl,) = [t for t in by_trace[ctxs[i].trace_id]
                 if any(e["kind"] == "resume" for e in t["events"])]
        assert [e["tokens"] for e in tl["events"] if e["kind"] == "resume"] == markers[i]
        kinds = [e["kind"] for e in tl["events"]]
        assert kinds.index("resume") == kinds.index("first_token") - 1
        assert tl["token_events_sum"] == tl["tokens"] == 16 - markers[i][0]
        span = resume_spans[ctxs[i].trace_id]
        assert span.parent_id is None and span.tags["tokens_delivered"] == markers[i][0]


# ------------------------------------------------------------ transports
@pytest.fixture(scope="module")
def served(pair):
    """The port's component app and gRPC component server over one LLM
    with continuous batching, under an enabled tracer while its batcher is
    built (at the first request)."""
    from seldon_core_tpu_torch.transport.grpc_server import make_component_server
    from seldon_core_tpu_torch.transport.rest import make_component_app, start

    j, _ = pair
    old = get_tracer()
    set_tracer(Tracer(enabled=True))
    comp = LLMServer(device="cpu", **dict(COMMON, continuous_batching=2))
    comp.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    httpd, _ = start(make_component_app(comp, device="cpu"))
    grpc_server = make_component_server(comp, port=None)
    gport = grpc_server.add_insecure_port("127.0.0.1:0")
    grpc_server.start()
    try:
        yield httpd.server_address[1], f"127.0.0.1:{gport}", comp
    finally:
        grpc_server.stop(None)
        httpd.shutdown()
        httpd.server_close()
        if comp._batcher_service is not None:
            comp._batcher_service.close()
        set_tracer(old)


def _post(port, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_trace_ids_on_rest_sse_and_grpc(served):
    import grpc

    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.transport import proto_convert as pc
    from seldon_core_tpu_torch.transport.grpc_client import call_sync
    from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb

    port, gtarget, comp = served
    # REST JSON: the inbound trace id, its timeline exact
    with _post(port, {"prompt": [5, 9, 17]},
               {"traceparent": f"00-{'aa' * 16}-{'bb' * 8}-01"}) as r:
        out = json.loads(r.read())
    assert out["trace_id"] == "aa" * 16
    rep = _get(port, "/debug/timeline?n=8")
    assert rep["tracing"] is True and rep["tracer_enabled"] is True
    tl = rep["timelines"][-1]
    assert (tl["trace_id"], tl["ingress"]) == ("aa" * 16, "rest:/v1/generate")
    assert tl["token_events_sum"] == tl["tokens"] == len(out["tokens"])
    # SSE: the header before the first event == the done event's
    with _post(port, {"prompt": [7, 8, 9], "stream": True}) as r:
        header = r.headers["X-Trace-Id"]
        events = [json.loads(line[6:]) for line in r.read().decode().splitlines()
                  if line.startswith("data: ")]
    assert events[-1]["done"] is True and events[-1]["trace_id"] == header
    assert len(header) == 32
    # gRPC GenerateStream: initial metadata == the done event's
    channel = grpc.insecure_channel(gtarget)
    try:
        rpc = channel.unary_stream("/seldon.protos.Model/GenerateStream",
                                   request_serializer=lambda m: m.SerializeToString(),
                                   response_deserializer=pb.SeldonMessage.FromString)
        call = rpc(pc.message_to_proto(SeldonMessage.from_json_data(
            {"prompt": [5, 6, 7], "max_new_tokens": 4})), timeout=TIMEOUT,
            metadata=(("traceparent", f"00-{'cc' * 16}-{'dd' * 8}-01"),))
        md = dict(call.initial_metadata())
        events = [pc.message_from_proto(m).json_data for m in call]
    finally:
        channel.close()
    assert md["x-trace-id"] == events[-1]["trace_id"] == "cc" * 16
    # a jsonData predict joins the gRPC server span's trace
    out = call_sync(gtarget, "Predict", SeldonMessage.from_json_data(
        {"prompt": [9, 9, 3], "max_new_tokens": 4}), timeout_s=TIMEOUT,
        metadata=[("traceparent", f"00-{'fe' * 16}-{'21' * 8}-01")])
    mine = [t for t in comp.flight_recorder().timelines() if t["trace_id"] == "fe" * 16]
    assert mine[-1]["ingress"] == "grpc:predict"
    assert mine[-1]["token_events_sum"] == len(out.json_data["tokens"][0])
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=TIMEOUT) as r:
        text = r.read().decode()
    assert 'seldon_llm_traces_retained_total{deployment_name="",mode="head"' in text
    assert "seldon_trace_spans_dropped_total" in text
    assert "seldon_trace_export_seconds_count" in text


def test_debug_timeline_grpc_equals_rest(served):
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.transport.grpc_client import call_sync

    port, gtarget, comp = served
    comp._batcher_service.submit_sync([5, 9, 17], 6)
    for n in (64, 2):
        out = call_sync(gtarget, "DebugTimeline", SeldonMessage.from_json_data({"n": n}),
                        timeout_s=TIMEOUT)
        rest = _get(port, f"/debug/timeline?n={n}")
        assert out.json_data == rest
        assert len(rest["timelines"]) == min(n, comp.flight_recorder().completed_total)
    bare = call_sync(gtarget, "DebugTimeline", SeldonMessage(), timeout_s=TIMEOUT)
    assert bare.json_data == _get(port, "/debug/timeline")  # n defaults to 32 on both
    assert set(_get(port, "/debug/timeline?n=zz")["scaling"]) == set(rest["scaling"])


def test_scaling_snapshot_keys_equal_jax():
    class Bare:
        pass

    assert scaling_snapshot(Bare()) == jax_scaling(Bare())
