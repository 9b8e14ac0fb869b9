"""Disaggregated prefill/decode in the port (``seldon_core_tpu_torch/runtime/
disagg.py``, the batcher's ``remote_prefill`` admission, the server's
handoff programs and validation, the four handoff series) held against the
JAX package on the CPU, at ``tests/test_disagg.py``'s sizes (vocab 96, dim
32, 2 layers, pages of 8), float32 weights, float and int8 KV; port servers
on the JAX server's weights:

- greedy tokens: port ``remote_prefill`` == JAX ``remote_prefill`` (JAX
  ``prefill_devices=2`` on the virtual CPU devices) == port local, with 1
  and 2 workers, with an admission landing while decode steps are in
  flight, and with the radix trie on (suffix-only chunks: the chunk count
  equals JAX's, and so do the trie's counters); the handoff counters and
  bytes equal JAX's;
- seeded tokens: remote == local inside the port (the port's own chain);
- the staged bucket a worker hands over equals JAX's within 1e-5 (int8
  codes within one step), positions exactly;
- the TransferQueue sequences of ``tests/test_disagg.py`` and
  ``tests/test_network_handoff.py`` run through both queues with the same
  outcomes; a worker exception fails one request and the batch serves on;
  page exhaustion sheds a staged remote job with 503; ``close()`` fails a
  staged job instead of hanging; an interactive admission preempts a staged
  batch-class remote job;
- load validation raises JAX's messages; the four handoff series reach
  ``/metrics`` with JAX's names, help texts and values after the same run;
- the dense layout's handoff: tokens == local dense == JAX's dense
  ``remote_prefill``, one staging row a worker; a mesh keeps JAX's
  refusal word for word;
- the one-card pins: one device is accepted (the JAX package needs two)
  and a worker on the server's device holds the server's own weight
  tensors (``data_ptr`` equal); a decode slice of several devices is
  refused."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.runtime.disagg import Handoff as JaxHandoff
from seldon_core_tpu.runtime.disagg import PrefillRequest as JaxRequest
from seldon_core_tpu.runtime.disagg import PrefillWorker as JaxWorker
from seldon_core_tpu.runtime.disagg import TransferQueue as JaxQueue
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import PAD_POS
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.runtime.disagg import (Handoff, PrefillRequest, PrefillWorker,
                                                  TransferQueue, normalize_disaggregation)
from seldon_core_tpu_torch.runtime.resilience import ShedError
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3,
              disaggregation="remote_prefill", prefill_devices=2)
KNOBS = {"float": {}, "int8": dict(kv_cache_dtype="int8"),
         "sampled": dict(temperature=0.8, top_k=20, seed=5)}
BKW = dict(max_slots=3, max_len=40, len_buckets=(8,), page_size=8)
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13], [7], [60, 61, 62, 63, 64, 65]]
TIMEOUT = 120


def _pair(**extra):
    j = JaxLLMServer(init_random=True, **dict(COMMON, **extra))
    j.load()
    p = LLMServer(device="cpu", **dict(COMMON, **extra))
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    return j, p


@pytest.fixture(scope="module")
def pairs():
    """knob name -> (the JAX server, the port server on its weights), each
    loaded at first use."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _pair(**KNOBS[name])
        return made[name]

    return get


def port_batch(server, prompts, n=8, seeds=None, **kw):
    """One batch through a fresh port batcher: (tokens, handoff stats, page
    stats, the closed batcher)."""
    b = ContinuousBatcher(server, device="cpu", **dict(BKW, **kw))
    try:
        futs = [b.submit(p, n, seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        outs = [f.result(TIMEOUT) for f in futs]
        stats = (b.handoff_stats(), b.page_stats())
    finally:
        b.close()
    return outs, stats[0], stats[1], b


def jax_batch(server, prompts, n=8, layout="paged", **kw):
    async def go():
        b = JaxBatcher(server, layout=layout, **dict(BKW, **kw))
        outs = await asyncio.gather(*[b.submit(p, max_new_tokens=n) for p in prompts])
        stats = b.handoff_stats(), b.page_stats()
        await b.close()
        return outs, stats[0], stats[1]

    return asyncio.run(go())


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("workers", [1, 2])
def test_greedy_remote_equals_jax_and_local(pairs, kv, workers):
    j, p = pairs(kv)
    local, lstats, _, _ = port_batch(p, PROMPTS, disaggregation="off")
    outs, stats, pages, b = port_batch(p, PROMPTS, prefill_workers=workers)
    jouts, jstats, jpages = jax_batch(j, PROMPTS, prefill_workers=workers)
    assert outs == jouts == local
    assert len(b._remote.workers) == workers
    assert sum(w.eager_runs for w in b._remote.workers) == len(PROMPTS)  # one chunk each
    assert stats == jstats
    assert stats["handoffs_total"] == len(PROMPTS) and stats["handoff_queue_depth"] == 0
    assert stats["handoff_transfer_bytes_total"] > 0
    assert lstats["handoffs_total"] == 0 and lstats["disaggregation"] == "off"
    assert pages["kv_pages_in_use"] == jpages["kv_pages_in_use"] == 0


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_dense_remote_equals_jax_and_local(pairs, kv):
    """The dense layout's handoff (``PrefillWorker._prefill_dense``, the
    batcher's ``insert_slot_row``): tokens equal the local dense batcher's
    and JAX's dense ``remote_prefill``, with 2 workers and more requests
    than slots (rows reused); each worker prefilled into its one staging
    row, of the slot pool's geometry; every slot back. The handoff carries
    the prompt's columns, where JAX's carries the whole row, so the bytes
    differ."""
    j, p = pairs(kv)
    local, _, _, _ = port_batch(p, PROMPTS, disaggregation="off", layout="dense")
    b = ContinuousBatcher(p, device="cpu", prefill_workers=2, layout="dense", **BKW)
    try:
        rows = [w._staging for w in b._remote.workers]
        assert all(tuple(r[0][-1].shape) == (1, BKW["max_len"] + 1) for r in rows)
        outs = [f.result(TIMEOUT) for f in [b.submit(q, 8) for q in PROMPTS]]
        stats, pages = b.handoff_stats(), b.page_stats()
        assert all(w._staging is r for w, r in zip(b._remote.workers, rows))   # reused
        assert sum(w.eager_runs for w in b._remote.workers) == len(PROMPTS)
    finally:
        b.close()
    jouts, jstats, _ = jax_batch(j, PROMPTS, prefill_workers=2, layout="dense")
    assert outs == jouts == local
    assert stats["handoffs_total"] == jstats["handoffs_total"] == len(PROMPTS)
    assert stats["handoff_queue_depth"] == 0 and stats["handoff_transfer_bytes_total"] > 0
    assert pages["kv_pages_total"] == 0
    assert not any(s.active or s.prefilling for s in b._slots) and not b._remote_jobs


def test_dense_disagg_over_a_mesh_keeps_jax_error():
    """Disaggregation with a mesh refuses with the JAX package's message,
    word for word, under the dense layout too."""
    from seldon_core_tpu_torch.parallel.topology import Topology

    kw = dict(COMMON, kv_cache_layout="dense", tensor_parallel=2)
    with pytest.raises(ValueError) as jerr:
        JaxLLMServer(init_random=True, **kw).load()
    with pytest.raises(ValueError) as perr:
        LLMServer(device="cpu", init_random=True, topology=Topology(devices=["cpu"] * 2),
                  **kw).load()
    assert str(perr.value) == str(jerr.value)


def test_admission_mid_decode_steps_in_flight(pairs):
    """A long admission handed off while >= 2 decode steps of another are in
    flight: both requests give JAX's solo tokens (and the port's local
    ones), through two handoffs."""
    j, p = pairs("float")
    p1, p2 = [5, 9, 17, 33], list(range(2, 31))
    e1 = j.generate([p1], max_new_tokens=24)["tokens"][0]
    e2 = j.generate([p2], max_new_tokens=6)["tokens"][0]
    kw = dict(max_slots=2, max_len=64, len_buckets=(32,), pipeline_depth=3, page_size=8,
              prefill_chunk=8)
    got = {}
    for mode in ("remote_prefill", "off"):
        b = ContinuousBatcher(p, device="cpu", disaggregation=mode, **kw)
        try:
            f1 = b.submit(p1, 24)
            deadline = time.monotonic() + TIMEOUT
            while not (b._inflight_hwm >= 2 and any(s.active for s in b._slots)):
                assert time.monotonic() < deadline
                time.sleep(0.002)
            f2 = b.submit(p2, 6)
            got[mode] = (f1.result(TIMEOUT), f2.result(TIMEOUT), b._inflight_hwm,
                         b.handoff_stats()["handoffs_total"])
        finally:
            b.close()
    assert got["remote_prefill"][:2] == (e1, e2) == got["off"][:2]
    assert got["remote_prefill"][2] >= 2 and got["remote_prefill"][3] == 2


def _count_chunks(jserver):
    """Wrap the JAX server's chunk programs to count their calls."""
    calls = []
    real = jserver._get_prefill_chunk

    def counted(*a, **k):
        fn = real(*a, **k)

        def run(*args, **kwargs):
            calls.append(a[0])
            return fn(*args, **kwargs)

        return run

    jserver._get_prefill_chunk = counted
    return calls


TURNS = ([9, 8, 7, 6, 5, 4, 3, 2, 1, 11, 12, 13, 14, 15, 16, 17, 18, 19], [30, 31, 32],
         [44, 45, 46, 47, 48, 49, 50, 51, 52])
TRIE_KW = dict(max_slots=2, max_len=64, len_buckets=(16, 32), page_size=4, prefill_chunk=8)


def _chat(submit):
    outs, prompt = [], list(TURNS[0])
    for user in TURNS[1:] + ((),):
        outs.append(submit(prompt))
        prompt = prompt + outs[-1] + list(user)
    return outs


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_trie_suffix_chunks_equal_jax(pairs, kv):
    """A chat with the trie on: each later turn matches whole blocks, the
    worker imports the exported bucket and chunks the suffix only. Tokens
    == JAX's remote chat == the port's local chat with the trie; the
    chunks a turn runs and the trie's counters equal JAX's."""
    knobs = dict(KNOBS[kv], prefix_cache_size=8)
    j, p = _pair(**knobs)
    b = ContinuousBatcher(p, device="cpu", **TRIE_KW)
    chunks, full = [], []
    try:
        def port_submit(prompt):
            before = sum(w.eager_runs for w in b._remote.workers)
            out = b.submit(prompt, 6).result(TIMEOUT)
            chunks.append(sum(w.eager_runs for w in b._remote.workers) - before)
            full.append(-(-len(prompt) // TRIE_KW["prefill_chunk"]))   # a cold prefill's
            return out

        outs = _chat(port_submit)
        stats = dict(b._radix.stats())
    finally:
        b.close()
    calls = _count_chunks(j)
    jchunks = []

    async def go():
        jb = JaxBatcher(j, layout="paged", **TRIE_KW)

        async def one(prompt):
            before = len(calls)
            out = await jb.submit(prompt, max_new_tokens=6)
            jchunks.append(len(calls) - before)
            return out

        res = []
        prompt = list(TURNS[0])
        for user in TURNS[1:] + ((),):
            res.append(await one(prompt))
            prompt = prompt + res[-1] + list(user)
        st = dict(jb._radix.stats())
        await jb.close()
        return res, st

    jouts, jstats = asyncio.run(go())
    local = ContinuousBatcher(p, device="cpu", disaggregation="off", **TRIE_KW)
    try:
        plain = _chat(lambda prompt: local.submit(prompt, 6).result(TIMEOUT))
    finally:
        local.close()
    assert outs == jouts == plain
    assert chunks == jchunks
    assert chunks[0] == full[0] and all(c < f for c, f in zip(chunks[1:], full[1:]))
    assert stats["prefix_hit_tokens"] > 0
    assert stats == jstats


def test_seeded_remote_equals_local(pairs):
    _, p = pairs("sampled")
    prompts = [[5, 9, 17, 2], [40, 3, 22], [7, 7, 7, 7, 7]]
    seeds = [42, 1234, 7]
    local, *_ = port_batch(p, prompts, seeds=seeds, disaggregation="off")
    remote, *_ = port_batch(p, prompts, seeds=seeds)
    remote2, *_ = port_batch(p, prompts, seeds=seeds, prefill_workers=1)
    assert remote == local == remote2
    cold = [p.generate([pr], max_new_tokens=8, seed=sd)["tokens"][0]
            for pr, sd in zip(prompts, seeds)]
    assert remote == cold


# ------------------------------------------------------------ staged KV
def _wait_pop(q, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        h = q.pop()
        if h is not None:
            return h
        time.sleep(0.005)
    raise AssertionError("no handoff delivered within timeout")


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_staged_bucket_equals_jax(pairs, kv):
    """One prompt through a port worker and a JAX worker: the bucket's
    shapes equal, positions exactly, values within 1e-5 where a position is
    held (int8 codes within one step), the first-token logits within
    1e-5."""
    j, p = pairs(kv)
    ids = [40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13, 1, 2, 3, 4, 5, 6, 7, 8]
    q, jq = TransferQueue(), JaxQueue()
    w = PrefillWorker(p, q, "cpu", "cpu", layout="paged", max_len=40, page_size=8, n_pages=5,
                      prefill_chunk=8, chunks=(8,))
    jw = JaxWorker(j, jq, jax.devices()[1], jax.devices()[0], layout="paged", max_len=40,
                   page_size=8, n_pages=5, prefill_chunk=8)
    try:
        q.register(1)
        jq.register(1)
        w.submit(PrefillRequest(1, ids, 24, first_key=7))
        jw.submit(JaxRequest(1, ids, 24))
        h, jh = _wait_pop(q), _wait_pop(jq)
    finally:
        w.close()
        jw.close()
    assert h.error is None and jh.error is None
    assert len(h.staged) == len(jh.staged) == KW["n_layers"]
    for layer, jlayer in zip(h.staged, jh.staged):
        assert len(layer) == len(jlayer)
        held = layer[-1].numpy() != PAD_POS
        assert np.array_equal(layer[-1].numpy(), np.asarray(jlayer[-1]))
        assert held.sum() == len(ids)
        for t, jt in zip(layer[:-1], jlayer[:-1]):
            assert tuple(t.shape) == tuple(jt.shape)
            got, want = t.numpy()[held], np.asarray(jt)[held]
            if t.dtype == torch.int8:
                assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.first_logits, jh.first_logits, rtol=1e-5, atol=1e-5)
    assert h.transfer_bytes == jh.transfer_bytes
    assert h.first_token == int(np.argmax(h.first_logits))


# ------------------------------------------------- transfer-queue protocol
def seq_lifecycle(TQ, H):
    q = TQ()
    q.register(1)
    q.register(2)
    log = [q.depth(), q.ready_depth(), q.put(H(1, staged="kv1", transfer_bytes=10)),
           q.put(H(2, staged="kv2", transfer_bytes=20)), q.ready_depth()]
    h = q.pop()
    log += [h.job_id, h.staged, q.pop().job_id, q.pop(), q.depth(), q.stats()]
    return log


def seq_cancel_staged(TQ, H):
    q = TQ()
    q.register(7)
    return [q.cancel(7), q.put(H(7, staged="kv")), q.pop(), q.depth(), q.stats()]


def seq_cancel_ready(TQ, H):
    q = TQ()
    q.register(3)
    q.put(H(3, staged="kv"))
    h = q.cancel(3)
    return [h.job_id, h.staged, q.cancel(3), q.pop(), q.stats()]


def seq_cancel_after_pop(TQ, H):
    q = TQ()
    q.register(4)
    q.put(H(4, staged="kv"))
    return [q.pop().job_id, q.cancel(4), q.depth()]


def seq_on_ready(TQ, H):
    q = TQ()
    fired = []
    q.on_ready = lambda: fired.append(q.ready_depth())  # re-enters: outside the lock
    q.register(1)
    q.put(H(1, staged="kv"))
    return fired


def seq_replayed_put(TQ, H):
    q = TQ()
    q.register(1)
    log = [q.put(H(1, staged="kv", transfer_bytes=5)),
           q.put(H(1, staged="kv-replay", transfer_bytes=5)),
           q.put(H(99, staged="never-registered"))]
    h = q.pop()
    return log + [h.job_id, h.staged, q.put(H(1, staged="kv-after-pop")), q.pop(), q.stats()]


@pytest.mark.parametrize("seq", [seq_lifecycle, seq_cancel_staged, seq_cancel_ready,
                                 seq_cancel_after_pop, seq_on_ready, seq_replayed_put])
def test_transfer_queue_sequences_equal_jax(seq):
    assert seq(TransferQueue, Handoff) == seq(JaxQueue, JaxHandoff)


def test_normalize_disaggregation_equals_jax():
    from seldon_core_tpu.runtime.disagg import normalize_disaggregation as jax_norm

    for v in ("", None, "off", "remote_prefill", "Remote-Prefill", "disagg", "prefill"):
        assert normalize_disaggregation(v) == jax_norm(v)
    for fn in (normalize_disaggregation, jax_norm):
        with pytest.raises(ValueError, match="unknown disaggregation"):
            fn("banana")


# --------------------------------------------------- shed / failure paths
def _stall(worker, first_id):
    """Hold the worker's jobs whose prompt starts with ``first_id`` until
    the returned event is set."""
    gate = threading.Event()
    real = worker._prefill_one

    def held(req):
        if req.ids[0] == first_id:
            gate.wait(TIMEOUT)
        return real(req)

    worker._prefill_one = held
    return gate


def test_worker_exception_fails_one_request(pairs):
    _, p = pairs("float")
    b = ContinuousBatcher(p, device="cpu", prefill_workers=1, max_slots=2, max_len=32,
                          len_buckets=(8,), page_size=8)
    try:
        worker = b._remote.workers[0]
        real = worker._prefill_one

        def boom(req):
            if req.ids[0] == 95:
                raise RuntimeError("injected prefill failure")
            return real(req)

        worker._prefill_one = boom
        with pytest.raises(RuntimeError, match="injected prefill failure"):
            b.submit([95, 1, 2], 4).result(TIMEOUT)
        ok = b.submit([5, 9, 17], 4).result(TIMEOUT)
        assert b.crashed is None
        stats, pages = b.handoff_stats(), b.page_stats()
    finally:
        b.close()
    assert ok == p.generate([[5, 9, 17]], max_new_tokens=4)["tokens"][0]
    assert stats["handoff_queue_depth"] == 0 and pages["kv_pages_in_use"] == 0


def test_import_failure_fails_one_request(pairs):
    """A handoff whose import raises (a malformed bucket) fails its own
    request; the batch serves on."""
    _, p = pairs("float")
    b = ContinuousBatcher(p, device="cpu", prefill_workers=1, max_slots=2, max_len=32,
                          len_buckets=(8,), page_size=8)
    try:
        worker = b._remote.workers[0]
        real = worker._prefill_one

        def poison(req):
            h = real(req)
            if req.ids[0] == 95:
                h.staged = [tuple(t[:, :1] for t in layer) for layer in h.staged]
            return h

        worker._prefill_one = poison
        with pytest.raises(RuntimeError):
            b.submit([95, 1, 2], 4).result(TIMEOUT)
        ok = b.submit([5, 9, 17], 4).result(TIMEOUT)
        assert b.crashed is None and b.page_stats()["kv_pages_in_use"] == 0
    finally:
        b.close()
    assert ok == p.generate([[5, 9, 17]], max_new_tokens=4)["tokens"][0]


def test_pool_exhaustion_sheds_staged_remote_job_503(pairs):
    """The first request decodes and grows; the second stays staged on its
    (held) worker and holds a page; the growth exhausts the pool and the
    newest tenant, the staged remote job, sheds with 503. The survivor's
    tokens are its solo tokens; the held worker's late put is refused; no
    page stays held."""
    j, p = pairs("float")
    p1 = [5, 9, 17, 33]
    e1 = j.generate([p1], max_new_tokens=28)["tokens"][0]
    b = ContinuousBatcher(p, device="cpu", prefill_workers=1, max_slots=2, max_len=32,
                          len_buckets=(8,), page_size=4, pool_pages=10)
    try:
        gate = _stall(b._remote.workers[0], 40)
        first = threading.Event()
        f1 = b.submit(p1, 28, on_token=lambda t: first.set())
        assert first.wait(TIMEOUT)
        f2 = b.submit([40, 3, 22, 8, 1], 28)
        with pytest.raises(ShedError) as ei:
            f2.result(TIMEOUT)
        assert ei.value.status_code == 503 and ei.value.reason == "RESOURCE_EXHAUSTED"
        gate.set()
        assert f1.result(TIMEOUT) == e1
        deadline = time.monotonic() + TIMEOUT
        while b._remote.workers[0].backlog_depth() or b._transfer.depth():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert b._transfer.stats()[0] == 1          # f2's put was refused
        assert b.page_stats()["kv_pages_in_use"] == 0
        assert b.page_stats()["kv_page_sheds"] == 1
    finally:
        b.close()


def test_close_fails_staged_jobs_instead_of_hanging(pairs):
    _, p = pairs("float")
    b = ContinuousBatcher(p, device="cpu", prefill_workers=1, max_slots=2, max_len=32,
                          len_buckets=(8,), page_size=8)
    gate = _stall(b._remote.workers[0], 5)
    fut = b.submit([5, 9, 17], 4)
    deadline = time.monotonic() + TIMEOUT
    while not b._remote_jobs:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    closer = threading.Thread(target=b.close)
    closer.start()
    with pytest.raises(ShedError, match="batcher closed"):
        fut.result(10)
    gate.set()
    closer.join(TIMEOUT)
    assert not closer.is_alive()
    assert b.page_stats()["kv_pages_in_use"] == 0


def test_interactive_preempts_staged_batch_remote_job(pairs):
    """One slot, a batch-class job staged on a held worker: an interactive
    request preempts it (requeued, immune to a second preemption); both
    finish with their solo tokens, the interactive one first."""
    _, p = pairs("float")
    b = ContinuousBatcher(p, device="cpu", prefill_workers=1, max_slots=1, max_len=32,
                          len_buckets=(8,), page_size=8)
    done = []
    try:
        gate = _stall(b._remote.workers[0], 40)
        fb = b.submit([40, 3, 22], 4, slo_class="batch")
        fb.add_done_callback(lambda f: done.append("batch"))
        deadline = time.monotonic() + TIMEOUT
        while not b._remote_jobs:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        fi = b.submit([5, 9, 17], 4, slo_class="interactive")
        fi.add_done_callback(lambda f: done.append("interactive"))
        while not any(j.req.slo_class == "interactive" for j in b._remote_jobs.values()):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        gate.set()
        outs = fi.result(TIMEOUT), fb.result(TIMEOUT)
        counters = {(r["tenant"], r["slo_class"]): r for r in b._pending.counters()}
    finally:
        b.close()
    assert outs == tuple(p.generate([pr], max_new_tokens=4)["tokens"][0]
                         for pr in ([5, 9, 17], [40, 3, 22]))
    assert done == ["interactive", "batch"]
    assert counters[("", "batch")]["preempted"] == 1
    assert b._transfer.stats()[0] == 2       # the preempted job's first put was refused


# ------------------------------------------------------------- validation
BAD_LOADS = [dict(disaggregation="banana"),
             dict(disaggregation="remote_prefill", prefill_devices=-1),
             dict(disaggregation="remote_prefill", prefill_workers=-2),
             dict(disaggregation="remote_prefill", tensor_parallel=2),
             dict(disaggregation="remote_prefill", sequence_parallel=2),
             dict(disaggregation="remote_prefill", lora_rank=2),
             dict(disaggregation="remote_prefill", handoff_transport="banana"),
             dict(handoff_transport="network")]


@pytest.mark.parametrize("bad", BAD_LOADS, ids=lambda d: ",".join(f"{k}={v}" for k, v in
                                                                   d.items()))
def test_load_validation_equals_jax(bad):
    base = dict(COMMON, disaggregation="", prefill_devices=0)
    msgs = []
    for make in (lambda kw: JaxLLMServer(init_random=True, **kw),
                 lambda kw: LLMServer(device="cpu", **kw)):
        with pytest.raises(ValueError) as ei:
            make(dict(base, **bad)).load()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_batcher_validates_handoff_transport(pairs):
    j, p = pairs("float")
    msgs = []
    with pytest.raises(ValueError) as ei:
        ContinuousBatcher(p, device="cpu", handoff_transport="banana", **BKW)
    msgs.append(str(ei.value))
    with pytest.raises(ValueError) as ei:
        JaxBatcher(j, layout="dense", handoff_transport="banana", **BKW)
    msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_one_device_accepted_and_weights_shared():
    """One device serves disaggregation (the JAX package needs two): the
    default is one worker on the server's device, whose weights are the
    server's own tensors."""
    p = LLMServer(device="cpu", **dict(COMMON, prefill_devices=0, init_random=True))
    p.load()
    b = ContinuousBatcher(p, device="cpu", **BKW)
    try:
        (w,) = b._remote.workers
        assert w.device == p.device == b.disagg_mesh.decode_devices[0]
        assert w._params is p._module
        ptrs = [t.data_ptr() for t in p._module.parameters()]
        assert ptrs and [t.data_ptr() for t in p._params_on(torch.device("cpu")).parameters()] \
            == ptrs
        out = b.submit([5, 9, 17], 4).result(TIMEOUT)
    finally:
        b.close()
    assert out == p.generate([[5, 9, 17]], max_new_tokens=4)["tokens"][0]


def test_decode_devices_must_hold_the_server_device(pairs):
    from seldon_core_tpu_torch.parallel.mesh import DisaggregatedMesh

    _, p = pairs("float")
    with pytest.raises(ValueError, match="decode slice must contain"):
        ContinuousBatcher(p, device="cpu", disagg_mesh=DisaggregatedMesh(["cpu"], ["meta"]),
                          **BKW)


def test_multi_device_decode_slice_serves():
    """A decode slice of two devices (decode_devices=2): the port's one
    card names it twice and decodes on it, as the JAX batcher decodes on the
    default device inside its two-device slice; tokens equal JAX's, the
    scaling snapshot counts 2 decode devices on both, and the autoscaler's
    rebalance decision on that snapshot equals JAX's (a backlog now moves
    the split up under the default ``min_decode_devices``). An explicit
    slice naming two devices decodes on the server's."""
    from seldon_core_tpu.controlplane import autoscaler as jax_auto
    from seldon_core_tpu.observability.timeline import scaling_snapshot as jax_snapshot
    from seldon_core_tpu_torch.controlplane import autoscaler as auto
    from seldon_core_tpu_torch.observability.timeline import scaling_snapshot
    from seldon_core_tpu_torch.parallel.mesh import DisaggregatedMesh

    j, p = _pair(prefill_devices=1, decode_devices=2)
    outs, stats, pages, b = port_batch(p, PROMPTS)
    assert len(b.disagg_mesh.decode_devices) == 2 and stats["handoffs_total"] == len(PROMPTS)

    async def go():
        jb = JaxBatcher(j, layout="paged", **BKW)
        jouts = await asyncio.gather(*[jb.submit(q, max_new_tokens=8) for q in PROMPTS])
        snap = jax_snapshot(j, batcher=jb)
        await jb.close()
        return jouts, snap

    jouts, jsnap = asyncio.run(go())
    assert outs == jouts
    snap = scaling_snapshot(p, batcher=b)
    assert snap["decode_devices"] == jsnap["decode_devices"] == 2
    assert snap["prefill_devices"] == jsnap["prefill_devices"] == 1
    kw = dict(rebalance=True, rebalance_stable_ticks=1, rebalance_cooldown_s=0.0)
    for s in (snap, dict(snap, handoff_queue_depth=6)):
        got = [(d.action, d.target, d.reason) for d in (
            mod.decide_rebalance([mod.ReplicaSignals.from_scaling(s)],
                                 mod.AutoscalerConfig(**kw), mod.ControllerState(), 0.0)[0]
            for mod in (auto, jax_auto))]
        assert got[0] == got[1]
    assert got[0][:2] == (auto.REBALANCE, 2)
    two, _, _, b2 = port_batch(p, PROMPTS,
                               disagg_mesh=DisaggregatedMesh(["cpu"], ["cpu", "cpu"]))
    assert two == outs and len(b2.disagg_mesh.decode_devices) == 2


# --------------------------------------------------------------- metrics
def _samples(text: str, names):
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            kind, name, rest = line[2:].split(" ", 2)
            if kind == "HELP" and name in names:
                out["help", name] = rest
            continue
        metric, value = line.rsplit(" ", 1)
        name = metric.split("{", 1)[0]
        if name in names:
            out[name] = float(value)
    return out


def test_handoff_series_reach_metrics_equal_jax(pairs):
    from seldon_core_tpu.metrics.registry import MetricsRegistry as JaxRegistry
    from seldon_core_tpu.runtime.batcher import BatcherService as JaxService
    from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
    from seldon_core_tpu_torch.runtime.batcher import BatcherService

    extra = dict(continuous_batching=2, continuous_batching_max_len=32)
    j, p = _pair(**extra)
    svc, jsvc = BatcherService(p, max_slots=2), JaxService(j, max_slots=2)
    p._batcher_service, j._batcher_service = svc, jsvc
    try:
        assert svc.submit_sync([3, 1, 4, 1, 5], 6) == jsvc.submit_sync([3, 1, 4, 1, 5], 6)
        st, jst = p.llm_stats(), j.llm_stats()
        keys = ("disaggregation", "handoffs_total", "handoff_transfer_bytes_total",
                "handoff_queue_depth", "handoff_network_bytes_total")
        assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
        assert len(st["handoff_times_s"]) == len(jst["handoff_times_s"]) == 1
        texts = []
        for reg, s in ((MetricsRegistry(deployment="d", predictor="p"), p),
                       (JaxRegistry(deployment="d", predictor="p"), j)):
            s._handoff_times.append(0.25)
            reg.sync_llm(s)
            texts.append(reg.expose().decode())
    finally:
        svc.close()
        jsvc.close()
    names = ("seldon_llm_handoffs_total", "seldon_llm_handoff_queue_depth",
             "seldon_llm_handoff_network_bytes_total", "seldon_llm_handoff_seconds_count",
             "seldon_llm_handoff_seconds_sum", "seldon_llm_handoff_seconds")
    got, want = _samples(texts[0], names), _samples(texts[1], names)
    assert got == want
    assert got["seldon_llm_handoffs_total"] == 1 and got["seldon_llm_handoff_seconds_count"] == 1
