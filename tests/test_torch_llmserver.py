"""Port of LLM serving (servers/llmserver.py, runtime/batcher.py,
transport/rest.py of seldon_core_tpu_torch) held against the JAX package
and against itself, on the CPU at llama-tiny widths:

- greedy ``generate()`` tokens EQUAL the JAX ``LLMServer.generate()``
  tokens on the same params (float32);
- inside the port, the paged continuous batcher (pipeline depth 2,
  mid-stream admission, chunked prefill) gives exactly ``generate()``'s
  greedy tokens, and a seeded sampled request gives ``generate(seed=)``'s;
- page-pool exhaustion sheds the newest request with 503 and returns every
  page; the stdlib REST server answers /ready and /v1/generate."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, PageAllocator
from seldon_core_tpu_torch.runtime.resilience import ShedError
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32", tie_embeddings=True)
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, eos_id=-1, seed=3,
              len_buckets=(16, 32), batch_buckets=(1, 4))
PROMPTS = ["hello world", [5, 9, 17, 2, 40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13, 1, 2],
           "a"]


@pytest.fixture(scope="module")
def jax_params():
    s = JaxLLMServer(init_random=True, temperature=0.0, **COMMON)
    s.load()
    return s, {"params": jax.tree_util.tree_map(np.asarray, s._params["params"])}


def port_server(params, **extra) -> LLMServer:
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


@pytest.fixture(scope="module")
def server(jax_params):
    return port_server(jax_params[1], temperature=0.0)


@pytest.fixture(scope="module")
def sampled_server(jax_params):
    return port_server(jax_params[1], temperature=0.8, top_k=20)


def run_batch(server, prompts, seeds=None, n=8, **kw):
    kw.setdefault("page_size", 8)
    b = ContinuousBatcher(server, device="cpu", **kw)
    try:
        futs = [b.submit(p, n, seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        outs = [f.result(120) for f in futs]
        return outs, b.page_stats(), b._inflight_hwm
    finally:
        b.close()


def test_greedy_generate_equals_jax(jax_params, server):
    jserver, _ = jax_params
    for p in PROMPTS:
        assert server.generate([p])["tokens"] == jserver.generate([p])["tokens"]
    batch = server.generate(PROMPTS)
    assert batch["tokens"] == jserver.generate(PROMPTS)["tokens"]
    assert batch["texts"][0] == jserver.generate([PROMPTS[0]])["texts"][0]
    assert batch["texts"][1] is None


def test_batcher_greedy_equals_generate(server):
    """3 concurrent requests on 2 slots: the third is admitted mid-stream
    while decode steps are in flight; the 18-token prompt prefills in three
    chunks of 8 between decode steps."""
    expected = [server.generate([p])["tokens"][0] for p in PROMPTS]
    outs, pages, hwm = run_batch(server, PROMPTS, max_slots=2, pipeline_depth=2,
                                 prefill_chunk=8)
    assert outs == expected
    assert hwm == 2, "the pipeline never had two steps in flight"
    assert pages["kv_pages_in_use"] == 0 and pages["kv_page_sheds"] == 0


def test_batcher_seeded_equals_generate_seed(sampled_server):
    seeds = [42, 1234, 7]
    expected = [sampled_server.generate([p], seed=sd)["tokens"][0]
                for p, sd in zip(PROMPTS, seeds)]
    outs, _, _ = run_batch(sampled_server, PROMPTS, seeds=seeds, max_slots=3)
    assert outs == expected
    # the chain is the seed's: another seed samples differently
    assert sampled_server.generate([PROMPTS[0]], seed=43)["tokens"][0] != expected[0]


def test_pool_exhaustion_sheds_newest_503(server):
    """Two generations outgrow an oversubscribed pool (8 allocatable pages
    of 4 tokens; each needs ~7): the newest sheds with 503 + Retry-After,
    the oldest completes exactly, and every page comes back."""
    p1, p2 = [5, 9, 17, 33], [40, 3, 22, 8]
    e1 = server.generate([p1], max_new_tokens=24)["tokens"][0]
    b = ContinuousBatcher(server, max_slots=2, max_len=32, len_buckets=(8,), page_size=4,
                          pool_pages=10, device="cpu")
    try:
        f1 = b.submit(p1, max_new_tokens=24)
        f2 = b.submit(p2, max_new_tokens=24)
        assert f1.result(120) == e1
        err = f2.exception(120)
        assert isinstance(err, ShedError)
        assert err.status_code == 503 and err.reason == "RESOURCE_EXHAUSTED"
        assert err.retry_after_s > 0
        stats = b.page_stats()
        assert stats["kv_page_sheds"] >= 1 and stats["kv_pages_in_use"] == 0
    finally:
        b.close()


def test_batcher_tables_meet_the_kernels_page_walk(server, monkeypatch):
    """The CUDA paged-attention kernel walks each row's block table only up
    to the query position's page, where the plain version walks it all.
    Every decode read the batcher issues — with pages released and handed
    out again to requests of other lengths, and free slots riding along on
    all-TRASH rows — must give the same result on the table cut there."""
    from seldon_core_tpu_torch.ops import paged_attention as pa

    real, reads = pa.paged_attention, []

    def checked(q, cache, block_tables, positions):
        out = real(q, cache, block_tables, positions)
        ps = cache[0].shape[1]
        for r in range(block_tables.shape[0]):
            last = max(1, min(block_tables.shape[1], int(positions[r, 0]) // ps + 1))
            cut = pa.paged_attention_ref(q[r:r + 1], cache, block_tables[r:r + 1, :last],
                                         positions[r:r + 1])
            torch.testing.assert_close(cut, out[r:r + 1], rtol=1e-5, atol=1e-6)
        reads.append(block_tables.shape[0])
        return out

    prompts = [[5, 9, 17, 33, 2, 40, 3, 22, 8, 11], [7], "hello", [1, 2, 3], "abcdefghijk"]
    expected = [server.generate([p], max_new_tokens=12)["tokens"][0] for p in prompts]
    monkeypatch.setattr(pa, "paged_attention", checked)
    b = ContinuousBatcher(server, max_slots=2, max_len=32, len_buckets=(16,), page_size=4,
                          pool_pages=14, device="cpu")
    try:
        outs = [b.submit(p, 12).result(120) for p in prompts[:2]]
        futs = [b.submit(p, 12) for p in prompts[2:]]
        outs += [f.result(120) for f in futs]
        assert b.page_stats()["kv_pages_in_use"] == 0
    finally:
        b.close()
    assert outs == expected
    assert len(reads) >= 40


def test_concurrent_submitters_stress(server):
    """More submitting threads than cores against a 2-slot batcher, with a
    tiny switch interval: every request resolves to generate()'s tokens
    and every page comes back (a lost queue update would hang or leak)."""
    import sys

    want = server.generate(["hi"], max_new_tokens=3)["tokens"][0]
    b = ContinuousBatcher(server, max_slots=2, page_size=8, device="cpu")
    results, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client():
            try:
                results.append(b.submit("hi", 3).result(120))
            except Exception as e:  # surfaced by the assertion below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not errors and results == [want] * 16
    assert b.page_stats()["kv_pages_in_use"] == 0


def test_page_allocator_exact_accounting():
    a = PageAllocator(total_pages=8, page_size=16)
    assert a.capacity == 6
    g1 = a.alloc(4)
    assert g1 == [2, 3, 4, 5] and a.alloc(3) is None
    a.retain(g1[:1])
    a.free(g1)
    assert a.free_count() == 5 and a.refs_of(2) == 1
    a.free([2])
    with pytest.raises(ValueError):
        a.free([2])
    assert a.stats() == (8, 0, 0)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_rest_generate_and_ready(jax_params):
    server = port_server(jax_params[1], temperature=0.0, continuous_batching=2,
                         kv_page_size=8)
    httpd, _ = start(make_component_app(server, device="cpu"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/ready", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        want = server.generate(["hello"])
        results = [None] * 3

        def client(i):
            results[i] = _post(url + "/v1/generate", {"prompt": "hello"})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for code, _, body in results:  # concurrent requests share the batch
            assert code == 200
            assert body == {"tokens": want["tokens"][0], "text": want["texts"][0]}
        code, _, body = _post(url + "/v1/generate", {"prompts": ["hello", "a"]})
        assert code == 200 and body == server.generate(["hello", "a"])
        code, _, body = _post(url + "/v1/generate", {"prompt": "hello", "temperature": 0.0})
        assert code == 200 and body["tokens"] == want["tokens"][0]
        code, _, body = _post(url + "/v1/generate", {"prompt": "hello", "stream": True})
        assert code == 501 and "stream" in body["status"]["info"]
        code, _, body = _post(url + "/v1/generate", {"nothing": 1})
        assert code == 400 and body["status"]["status"] == "FAILURE"
        # a shed answers 503 + Retry-After: hold every page with no tenant
        # in flight, so the admission can never fit
        batcher = server._batcher_service.batcher
        held = batcher._allocator.alloc(batcher._allocator.free_count())
        code, headers, body = _post(url + "/v1/generate", {"prompt": "hello"})
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert body["status"]["reason"] == "RESOURCE_EXHAUSTED"
        batcher._allocator.free(held)
        assert batcher.page_stats()["kv_pages_in_use"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server._batcher_service.close()


@pytest.mark.parametrize("kw,slice_name", [
    (dict(spec_mode="ngram"), "speculative"),
    (dict(disaggregation="remote_prefill"), "disaggregation"),
    (dict(prefix_cache_size=4), "prefix"),
    (dict(lora_rank=4), "LoRA"),
    (dict(tensor_parallel=2), "parallelism"),
    (dict(quantize="int8"), "int8"),
    (dict(kv_cache_dtype="int8"), "int8-KV"),
    (dict(decode_fuse_steps=4), "decode_fuse_steps"),
])
def test_later_slice_knobs_raise(kw, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        LLMServer(device="cpu", **dict(COMMON, **kw))


def test_dense_batcher_layout_raises(jax_params):
    s = port_server(jax_params[1], kv_cache_layout="dense")
    with pytest.raises(NotImplementedError, match="dense"):
        ContinuousBatcher(s, device="cpu")


def test_rest_app_device_defaults_to_cuda(monkeypatch, server):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_component_app(server)
