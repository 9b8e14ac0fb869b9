"""Weighted-fair SLO admission in the port (``seldon_core_tpu_torch/runtime/
scheduler.py`` and its use in ``runtime/batcher.py``) against the JAX
package, on the CPU:

- the port's ``WeightedFairScheduler`` and the JAX one run the same seeded
  sequences of push / next / commit / remove / requeue (hypothesis,
  derandomised, so the test is steady) and give the same pick order,
  push results (quota sheds), depths, lengths, counters and drain order,
  under default, weighted and quota'd configurations, and the same
  overflow bucket past ``MAX_TENANT_SERIES`` tenants;
- the port batcher's preemption: an interactive request preempts a staged
  batch-class prefill job (once), never an active slot, and the preempted
  request's tokens equal its tokens without preemption;
- a tenant over its quota is 503 + Retry-After over REST, counted as the
  tenant's shed;
- the tenant and class of the headers and of the body (body wins) reach the
  scheduler's tallies exactly as the JAX app's do;
- the new metric series (adapters, tenant tallies, TTFT by class) render
  the JAX registry's text for the same snapshot."""

import asyncio
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from prometheus_client.parser import text_string_to_metric_families

import jax

import seldon_core_tpu.runtime.scheduler as jax_sched
import seldon_core_tpu_torch.runtime.scheduler as port_sched
from seldon_core_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.transport.rest import make_component_app as jax_app
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1,), temperature=0.0, eos_id=-1, seed=3)

TENANTS = ("", "acme", "bulk", "chat")
CLASSES = (port_sched.INTERACTIVE, port_sched.BATCH)
CONFIGS = {
    "default": {},
    "weighted": dict(class_weights={"interactive": 2.0, "batch": 3.0},
                     tenant_weights={"acme": 3.0, "bulk": 0.5}),
    "quotas": dict(tenant_quota=2, tenant_quotas={"bulk": 1, "chat": 3}),
}
OPS = st.lists(st.tuples(st.sampled_from(("push", "push", "push", "next", "commit",
                                          "remove", "requeue")),
                         st.integers(0, len(TENANTS) - 1), st.integers(0, 1),
                         st.one_of(st.none(), st.integers(0, 6))),
               min_size=1, max_size=40)


def run_ops(mod, cfg, ops):
    """Apply ``ops`` to a fresh scheduler of module ``mod``; the log of
    everything observable (requests named by their index)."""
    s = mod.WeightedFairScheduler(**cfg)
    queued, log, n = [], [], 0
    for op, t, c, dl in ops:
        if op == "push":
            r = mod.PendingRequest(ids=[n], max_new=1, fut=None, tenant=TENANTS[t],
                                   slo_class=CLASSES[c],
                                   deadline_t=None if dl is None else float(dl))
            n += 1
            ok = s.push(r)
            if ok:
                queued.append(r)
            log.append(("push", ok, r.seq))
        elif op == "next":
            r = s.next_request()
            log.append(("next", None if r is None else r.ids[0]))
        elif op in ("commit", "requeue"):
            r = s.next_request()
            if r is not None:
                s.commit(r)
                queued.remove(r)
                if op == "requeue" and not r.preempted:
                    log.append(("requeue", s.push(r, requeue=True), r.seq))
                    queued.append(r)
            log.append((op, None if r is None else r.ids[0]))
        elif op == "remove" and queued:
            r = queued.pop(t % len(queued))
            log.append(("remove", r.ids[0], s.remove(r)))
        log.append(("state", s.depths(), len(s)))
    log.append(("counters", s.counters()))
    order = []
    while len(s) > 2:
        r = s.next_request()
        s.commit(r)
        order.append(r.ids[0])
    log.append(("drain", order, [r.ids[0] for r in s.drain_all()], s.counters()))
    return log


@pytest.mark.parametrize("cfg", list(CONFIGS), ids=list(CONFIGS))
@settings(derandomize=True, max_examples=60, deadline=None)
@given(ops=OPS)
def test_scheduler_equals_jax(cfg, ops):
    assert run_ops(port_sched, CONFIGS[cfg], ops) == run_ops(jax_sched, CONFIGS[cfg], ops)


def test_overflow_bucket_and_normalize_equal_jax():
    logs = []
    for mod in (port_sched, jax_sched):
        s = mod.WeightedFairScheduler(tenant_quota=3)
        pushed = [s.push(mod.PendingRequest(ids=[i], max_new=1, fut=None,
                                            tenant=f"t{i}", slo_class=CLASSES[i % 2]))
                  for i in range(mod.MAX_TENANT_SERIES + 8)]
        logs.append((pushed, s.counters()[-3:], len(s.counters()), s.depths()))
        for value in ("Latency", "bulk", "throughput", None, ""):
            logs.append(mod.normalize_slo_class(value))
        with pytest.raises(ValueError, match="unknown SLO class"):
            mod.normalize_slo_class("gold")
    half = len(logs) // 2
    assert logs[:half] == logs[half:]
    assert logs[0][2] == port_sched.MAX_TENANT_SERIES + 2   # the overflow bucket, by class


# ---------------------------------------------------------------------------
# the port batcher: preemption and quota
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    s = LLMServer(device="cpu", init_random=True, **COMMON)
    s.load()
    return s


LONG = [int(t) for t in np.random.default_rng(0).integers(1, 90, size=14)]


def _batcher(server):
    return ContinuousBatcher(server, max_slots=1, max_len=48, len_buckets=(16,),
                             page_size=4, prefill_chunk=2, device="cpu")


def _run(b):
    """Start the loop of a batcher driven by hand so far."""
    b._ensure_running()
    b._wakeup.set()


def test_interactive_preempts_staged_batch_never_active(server):
    """Driven by hand, no loop thread, so the interleaving is fixed: a
    staged batch job is put back (its slot and pages released, its seq
    kept, preempted once) for an interactive head; a second interactive
    head cannot preempt it again; an ACTIVE batch slot is never
    preempted."""
    b = _batcher(server)
    batch = port_sched.PendingRequest(ids=LONG, max_new=4, fut=None, tenant="bulk",
                                      slo_class="batch")
    assert b._pending.push(batch)
    b._admit_pending()
    assert b._prefill is not None and b._prefill.req is batch
    assert b.page_stats()["kv_pages_in_use"] == 4
    seq = batch.seq
    inter = port_sched.PendingRequest(ids=[3, 5], max_new=3, fut=None, tenant="chat")
    b._pending.push(inter)
    b._admit_pending()
    assert b._prefill.req is inter and batch.preempted and batch.seq == seq
    assert b.page_stats()["kv_pages_in_use"] == 1
    assert b._pending.depths() == {"interactive": 0, "batch": 1}
    ctrs = {(r["tenant"], r["slo_class"]): r for r in b._pending.counters()}
    assert ctrs[("bulk", "batch")]["preempted"] == 1
    # the batch request, re-staged, cannot be preempted a second time
    b._prefill = None
    b._release_slot(0)
    b._admit_pending()
    assert b._prefill.req is batch
    again = port_sched.PendingRequest(ids=[7], max_new=2, fut=None, tenant="chat")
    b._pending.push(again)
    b._admit_pending()
    assert b._prefill.req is batch and b._pending.depths()["interactive"] == 1
    b.close()


def test_active_slot_never_preempted_and_outputs_unchanged(server):
    """Served: the preempted batch request's tokens equal its unpreempted
    tokens; a batch request already decoding (an active slot) keeps its
    slot while an interactive one waits, and both finish."""
    def once(preempt):
        b = _batcher(server)
        batch = port_sched.PendingRequest(ids=LONG, max_new=5, fut=Future(), slo_class="batch")
        b._pending.push(batch)
        b._admit_pending()
        inter_fut = None
        if preempt:
            inter = port_sched.PendingRequest(ids=[2, 4], max_new=2, fut=Future())
            b._pending.push(inter)
            b._admit_pending()
            inter_fut = inter.fut
        _run(b)
        out = batch.fut.result(60)
        if inter_fut is not None:
            assert len(inter_fut.result(60)) == 2
        preempted = {(r["tenant"], r["slo_class"]): r["preempted"]
                     for r in b._pending.counters()}
        b.close()
        return out, preempted

    plain, p0 = once(False)
    preempted, p1 = once(True)
    assert plain == preempted and len(plain) == 5
    assert p0[("", "batch")] == 0 and p1[("", "batch")] == 1
    # an active batch slot: the interactive request waits for it
    b = _batcher(server)
    fb = b.submit(LONG, max_new_tokens=30, slo_class="batch")
    for _ in range(2000):
        if b._slots[0].active:
            break
        threading.Event().wait(0.001)
    assert b._slots[0].active
    fi = b.submit([2, 4], max_new_tokens=2, slo_class="interactive")
    assert len(fb.result(60)) == 30 and len(fi.result(60)) == 2
    ctrs = {(r["tenant"], r["slo_class"]): r for r in b._pending.counters()}
    assert ctrs[("", "batch")]["preempted"] == 0
    b.close()


def _gate(b):
    """Hold the batcher's admission until the returned event is set: the
    loop blocks at the top of its turn, so submitted requests stay queued."""
    gate = threading.Event()
    admit = b._admit_pending

    def gated():
        gate.wait()
        admit()

    b._admit_pending = gated
    return gate


def _post(url, body, headers=None):
    req = urllib.request.Request(url + "/v1/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_quota_shed_is_503_with_retry_after_over_rest():
    s = LLMServer(device="cpu", init_random=True, continuous_batching=1,
                  tenant_quotas={"bulk": 1}, **COMMON)
    s.load()
    from seldon_core_tpu_torch.runtime.batcher import get_batcher_service

    b = get_batcher_service(s).batcher
    gate = _gate(b)
    httpd, _ = start(make_component_app(s, device="cpu"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        queued = []
        t = threading.Thread(target=lambda: queued.append(
            _post(url, {"prompt": [5, 9, 2], "max_new_tokens": 3}, {"Seldon-Tenant": "bulk"})))
        t.start()
        for _ in range(2000):
            if len(b._pending):
                break
            threading.Event().wait(0.001)
        code, headers, body = _post(url, {"prompt": [5, 9], "tenant": "bulk"})
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert body["status"]["reason"] == "RESOURCE_EXHAUSTED"
        assert "over its admission quota" in body["status"]["info"]
        # another tenant is not bound by bulk's quota
        other = threading.Thread(target=lambda: queued.append(
            _post(url, {"prompt": [5, 9, 2], "max_new_tokens": 3, "tenant": "acme"})))
        other.start()
        gate.set()
        t.join(60)
        other.join(60)
        assert [q[0] for q in queued] == [200, 200]
        assert queued[0][2]["tokens"] == queued[1][2]["tokens"] == s.generate(
            [[5, 9, 2]], max_new_tokens=3)["tokens"][0]
        rows = {(r["tenant"], r["slo_class"]): r for r in b._pending.counters()}
        assert rows[("bulk", "interactive")]["shed"] == 1
        assert rows[("bulk", "interactive")]["admitted"] == 1
        assert rows[("acme", "interactive")]["admitted"] == 1
    finally:
        gate.set()
        httpd.shutdown()
        httpd.server_close()
        s._batcher_service.close()


# ---------------------------------------------------------------------------
# transport threading (headers / body -> the scheduler), port vs JAX app
# ---------------------------------------------------------------------------

THREADING = [
    ({"prompt": [5, 9, 2], "max_new_tokens": 3}, {"Seldon-Tenant": "acme",
                                                   "Seldon-SLO-Class": "batch"}),
    ({"prompt": [5, 9, 2], "max_new_tokens": 3, "tenant": "body", "slo_class": "bulk"},
     {"Seldon-Tenant": "acme", "Seldon-SLO-Class": "interactive"}),
    ({"prompt": [7, 1], "max_new_tokens": 2}, {"Seldon-SLO-Class": "latency"}),
    ({"prompt": [7, 1], "max_new_tokens": 2, "stream": True}, {"Seldon-Tenant": "sse"}),
    ({"prompt": [5], "max_new_tokens": 2, "adapter": "ghost"}, {}),
]


def _jax_counters(jserver):
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        codes = []
        async with TestClient(TestServer(jax_app(jserver))) as client:
            for body, headers in THREADING:
                resp = await client.post("/v1/generate", json=body, headers=headers)
                await resp.read()
                codes.append(resp.status)
        svc = jserver._batcher_service
        rows = svc.batcher._pending.counters()
        svc.close()
        return codes, rows

    return asyncio.run(go())


def test_headers_and_body_thread_into_scheduler():
    j = JaxLLMServer(init_random=True, continuous_batching=2, **COMMON)
    j.load()
    want_codes, want_rows = _jax_counters(j)
    p = LLMServer(device="cpu", continuous_batching=2, **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    httpd, _ = start(make_component_app(p, device="cpu"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        codes = []
        for body, headers in THREADING:
            req = urllib.request.Request(url + "/v1/generate", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json",
                                                  **headers})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    r.read()
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        rows = p._batcher_service.batcher._pending.counters()
    finally:
        httpd.shutdown()
        httpd.server_close()
        p._batcher_service.close()
    assert codes == want_codes == [200, 200, 200, 200, 400]
    assert rows == want_rows
    assert {(r["tenant"], r["slo_class"]) for r in rows} == {
        ("acme", "batch"), ("body", "batch"), ("", "interactive"), ("sse", "interactive")}


# ---------------------------------------------------------------------------
# the metric series
# ---------------------------------------------------------------------------

NEW_FAMILIES = ("seldon_llm_adapter_loaded", "seldon_llm_adapter_evictions",
                "seldon_llm_adapter_pool_bytes", "seldon_tenant_admitted",
                "seldon_tenant_shed", "seldon_tenant_tokens", "seldon_llm_tenant_ttft_seconds")


class _Stub:
    def __init__(self, snaps):
        self.snaps = list(snaps)

    def llm_stats(self):
        return self.snaps.pop(0)


def _snap(seed, k):
    rng = np.random.default_rng(seed)
    return {"adapter_loaded": int(rng.integers(0, 7)), "adapter_evictions_total": 2 * k,
            "adapter_pool_bytes": 252_706_848,
            "tenant_counters": [
                {"tenant": t, "slo_class": c, "admitted": k * (i + 1), "shed": k * i,
                 "tokens": 31 * k * (i + 2), "queued": i, "preempted": k}
                for i, (t, c) in enumerate((("", "interactive"), ("acme", "batch"),
                                            ('we"ird', "interactive")))],
            "ttft_by_class": [(c, float(v)) for c, v in zip(
                ("interactive", "batch", "batch", "interactive"), rng.uniform(0, 3, 4))]}


def test_metric_text_equals_jax_for_the_new_series():
    port, ref = MetricsRegistry(), JaxRegistry()
    for reg in (port, ref):
        stub = _Stub([_snap(0, 1), _snap(1, 3), _snap(2, 2)])
        for _ in range(3):
            reg.sync_llm(stub)
    got = {f.name: f for f in text_string_to_metric_families(port.expose().decode())}
    want = {f.name: f for f in text_string_to_metric_families(ref.expose().decode())}
    for name in NEW_FAMILIES:
        assert (got[name].type, got[name].documentation, got[name].samples) == \
            (want[name].type, want[name].documentation, want[name].samples), name
    shed = {s.labels["tenant"]: s.value for s in got["seldon_tenant_shed"].samples}
    assert shed == {"": 0.0, "acme": 3.0, 'we"ird': 6.0}   # never counts down


def test_live_tenant_series_equal_llm_stats():
    """A served batch and interactive request: ``llm_stats``' tallies and
    TTFT by class, and one scrape's tenant series, equal the run."""
    s = LLMServer(device="cpu", continuous_batching=2, init_random=True, **COMMON)
    s.load()
    httpd, _ = start(make_component_app(s, device="cpu"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for body, headers in THREADING[:2]:
            assert _post(url, body, headers)[0] == 200
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            fams = {f.name: f for f in text_string_to_metric_families(r.read().decode())}
        stats = s.llm_stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        s._batcher_service.close()
    tokens = {(x.labels["tenant"], x.labels["slo_class"]): x.value
              for x in fams["seldon_tenant_tokens"].samples}
    assert tokens == {("acme", "batch"): 3.0, ("body", "batch"): 3.0}
    ttft = {x.labels["slo_class"]: x.value for x in fams["seldon_llm_tenant_ttft_seconds"].samples
            if x.name.endswith("_count")}
    assert ttft == {"batch": 2.0}
    assert stats["ttft_by_class"] == []          # drained by the scrape
    assert stats["queue_by_class"] == {"interactive": 0, "batch": 0}
    assert [(r["tenant"], r["admitted"], r["tokens"]) for r in stats["tenant_counters"]] == [
        ("acme", 1, 3), ("body", 1, 3)]
