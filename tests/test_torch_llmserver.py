"""Port of LLM serving (servers/llmserver.py, runtime/batcher.py,
transport/rest.py of seldon_core_tpu_torch) held against the JAX package
and against itself, on the CPU at llama-tiny widths:

- greedy ``generate()`` tokens EQUAL the JAX ``LLMServer.generate()``
  tokens on the same params (float32);
- inside the port, the paged continuous batcher (pipeline depth 2,
  mid-stream admission, chunked prefill) gives exactly ``generate()``'s
  greedy tokens, and a seeded sampled request gives ``generate(seed=)``'s;
- a server of ``kv_cache_layout="dense"`` serves through the dense slot
  pool with ``generate()``'s tokens;
- page-pool exhaustion sheds the newest request with 503 and returns every
  page; the stdlib REST server answers /ready and /v1/generate;
- int8 serving: greedy ``generate()`` equals JAX's for ``kv_cache_dtype=
  "int8"``, ``quantize="int8"`` (weights from the JAX quantized tree) and
  both; inside the port the int8 batcher equals ``generate()``, greedy and
  seeded, with chunked prefill."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.contracts.payload import SeldonError
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
        req = urllib.request.Request(url + "/v1/generate",
                                     data=json.dumps({"prompt": "hello", "stream": True}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:  # served as SSE
            assert r.status == 200 and r.headers["Content-Type"] == "text/event-stream"
            events = [json.loads(line[6:]) for line in (raw.decode().strip() for raw in r)
                      if line.startswith("data: ")]
        assert [e["token"] for e in events[:-1]] == want["tokens"][0]
        assert events[-1] == {"done": True, "tokens": want["tokens"][0], "text": want["texts"][0]}
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


def _two_devices():
    from seldon_core_tpu_torch.parallel.topology import Topology

    return Topology(devices=["cpu", "meta"])


@pytest.mark.parametrize("kw,slice_name", [
    (dict(sequence_parallel=2), "Queue A 9b"),
    (dict(topology="two devices", tensor_parallel=2, sequence_parallel=1), "Queue A 9b"),
    (dict(tokenizer="hf"), "HF tokenizers"),
    (dict(tensor_parallel=2), "Queue A 9b"),
])
def test_later_slice_knobs_raise(kw, slice_name):
    """The knobs of later slices raise naming them: the HF tokenizer at
    construction; parallelism knobs over ranks on distinct devices (a CPU
    and a meta device here) at load(), naming two-card meshes, before any
    weight moves (the co-located meshes are tests/test_torch_parallel.py's)."""
    if "tokenizer" in kw:
        with pytest.raises(NotImplementedError, match=slice_name):
            LLMServer(device="cpu", **dict(COMMON, **kw))
        return
    kw = dict(kw, topology=_two_devices())
    s = LLMServer(device="cpu", init_random=True, **dict(COMMON, **kw))
    with pytest.raises(NotImplementedError, match=slice_name):
        s.load()
    assert not s.ready


def test_dense_batcher_layout_serves(jax_params):
    """A server configured for the dense layout gives its batcher the dense
    slot pool, which serves greedy and seeded requests with ``generate()``'s
    tokens (tests/test_torch_dense_batcher.py holds it to JAX's)."""
    s = port_server(jax_params[1], kv_cache_layout="dense")
    b = ContinuousBatcher(s, device="cpu", max_slots=2)
    try:
        assert not b.paged and b.page_stats()["kv_pages_total"] == 0
        prompts = [[5, 9, 17], list(range(1, 21)), [7]]
        futs = [b.submit(q, 6) for q in prompts]
        assert [f.result(60) for f in futs] == [s.generate([q], max_new_tokens=6)["tokens"][0]
                                                for q in prompts]
    finally:
        b.close()


def test_rest_app_device_defaults_to_cuda(monkeypatch, server):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_component_app(server)


INT8_KNOBS = {"kv": dict(kv_cache_dtype="int8"), "weights": dict(quantize="int8"),
              "both": dict(kv_cache_dtype="int8", quantize="int8")}


@pytest.fixture(scope="module", params=sorted(INT8_KNOBS))
def int8_pair(request):
    """(JAX server, port server) with the same int8 knobs: the port's
    weights are the JAX server's params (its quantized tree, for
    quantize='int8') through params_from_jax."""
    knobs = INT8_KNOBS[request.param]
    js = JaxLLMServer(init_random=True, temperature=0.0, **COMMON, **knobs)
    js.load()
    tree = {"params": jax.tree_util.tree_map(np.asarray, js._params["params"])}
    return request.param, js, port_server(tree, temperature=0.0, **knobs)


def test_int8_generate_equals_jax(int8_pair):
    _, jserver, server = int8_pair
    assert server.generate(PROMPTS)["tokens"] == jserver.generate(PROMPTS)["tokens"]


def test_int8_batcher_greedy_equals_generate(int8_pair):
    """The int8 knobs through the paged batcher (chunked prefill over three
    chunks, mid-stream admission) give generate()'s tokens exactly."""
    _, _, server = int8_pair
    expected = [server.generate([p])["tokens"][0] for p in PROMPTS]
    outs, pages, _ = run_batch(server, PROMPTS, max_slots=2, prefill_chunk=8)
    assert outs == expected
    assert pages["kv_pages_in_use"] == 0


def test_int8_batcher_seeded_equals_generate_seed(jax_params):
    server = port_server(jax_params[1], temperature=0.8, top_k=20, quantize="int8",
                         kv_cache_dtype="int8")
    seeds = [42, 1234, 7]
    expected = [server.generate([p], seed=sd)["tokens"][0] for p, sd in zip(PROMPTS, seeds)]
    outs, _, _ = run_batch(server, PROMPTS, seeds=seeds, max_slots=3, prefill_chunk=8)
    assert outs == expected


def test_int8_server_random_init_equals_quantized_float_tree(jax_params):
    """Random init with quantize='int8' builds the int8 layout first and
    fills it leaf by leaf; the weights equal the float model's, drawn from
    the same seed, quantized afterwards."""
    s = LLMServer(device="cpu", init_random=True, quantize="int8", **COMMON)
    s.load()
    f = LLMServer(device="cpu", init_random=True, **COMMON)
    f.load()
    f._module.quantize_()
    a, b = s._module.state_dict(), f._module.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[n], b[n]) for n in a)
    assert not any(p.dtype == torch.float32 and p.dim() >= 2 for p in s._module.parameters())


def test_quantize_knob_validation(jax_params):
    with pytest.raises(SeldonError, match="int8 only"):
        LLMServer(device="cpu", quantize="bogus", init_random=True, **COMMON).load()
    jq = JaxLLMServer(init_random=True, quantize="int8", **COMMON)
    jq.load()
    tree = {"params": jax.tree_util.tree_map(np.asarray, jq._params["params"])}
    with pytest.raises(SeldonError, match="quantize='int8'"):
        port_server(tree)  # int8 leaves into a float server


# ---------------------------------------------------------------------------
# LLMServer.predict / tags through components/dispatch (the /predict surface)
# ---------------------------------------------------------------------------
TINY = dict(model="llama-tiny", max_new_tokens=6, eos_id=-1, seed=5, len_buckets=(16, 32),
            batch_buckets=(1, 4), temperature=0.0)
PREDICT_BODIES = [
    {"strData": "hello"},
    {"jsonData": {"prompts": ["hi", "a longer prompt"], "max_new_tokens": 3}},
    {"data": {"ndarray": [[5, 9, 17, -1, -1], [4, 2, 8, 20, 7]]}},
]


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX server, its params as numpy) on llama-tiny."""
    from seldon_core_tpu.components import dispatch as jax_dispatch
    from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage

    js = JaxLLMServer(init_random=True, **TINY)
    js.load()
    tree = {"params": jax.tree_util.tree_map(np.asarray, js._params["params"])}
    return js, tree, jax_dispatch, JaxMessage


def tiny_server(tree, **extra) -> LLMServer:
    s = LLMServer(device="cpu", **dict(TINY, **extra))
    s.load(params=tree)
    return s


@pytest.mark.parametrize("body", PREDICT_BODIES, ids=["strData", "jsonData", "ndarray"])
def test_predict_payloads_equal_jax(tiny_pair, body):
    """strData, jsonData with prompts and max_new_tokens, and a -1-padded
    int array through the port's and the JAX package's dispatch.predict on
    the same weights: equal responses (texts, tokens, -1 padding, meta tags
    {"llm_requests": N})."""
    from seldon_core_tpu_torch.components import dispatch
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage

    js, tree, jax_dispatch, JaxMessage = tiny_pair
    server = tiny_server(tree)
    n0 = js.tags()["llm_requests"]
    want = jax_dispatch.predict(js, JaxMessage.from_dict(body)).to_dict()
    got = dispatch.predict(server, SeldonMessage.from_dict(body)).to_dict()
    assert got["meta"]["tags"] == {"llm_requests": 1}
    assert want["meta"]["tags"] == {"llm_requests": n0 + 1}
    got["meta"]["tags"] = want["meta"]["tags"] = None
    assert got == want
    assert server.tags() == {"llm_requests": 1}
    if "data" in body:
        assert got["data"]["ndarray"][0][:3] != [-1, -1, -1]


def test_predict_rejects_json_without_prompts(tiny_pair):
    from seldon_core_tpu_torch.components import dispatch
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage

    server = tiny_server(tiny_pair[1])
    with pytest.raises(SeldonError, match="prompts"):
        dispatch.predict(server, SeldonMessage.from_dict({"jsonData": {"max_new_tokens": 2}}))


def test_rest_predict_llm(tiny_pair):
    """POST /predict and /api/v0.1/predictions to an LLM answer with the
    generated text, as the JAX package's dispatch does."""
    js, tree, jax_dispatch, JaxMessage = tiny_pair
    server = tiny_server(tree)
    body = {"strData": "hello", "meta": {"puid": "p-1"}}
    want = jax_dispatch.predict(js, JaxMessage.from_dict(body)).to_dict()
    httpd, _ = start(make_component_app(server, device="cpu"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for route in ("/predict", "/api/v0.1/predictions"):
            code, _, got = _post(url + route, body)
            assert code == 200
            assert got["strData"] == want["strData"] and got["meta"]["puid"] == "p-1"
        code, _, got = _post(url + "/predict", {"jsonData": {"temperature": 0.0}})
        assert code == 400 and got["status"]["status"] == "FAILURE"
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert server.tags() == {"llm_requests": 2}


def test_predict_single_prompt_joins_the_batch(tiny_pair):
    """A jsonData {"prompt", "max_new_tokens"} predict to a server with
    continuous_batching slots goes through the shared batcher service (its
    admissions move, generate() is not called) and returns generate()'s
    tokens in the unbatched response shape; a seeded or multi-prompt body
    keeps the private path."""
    from seldon_core_tpu_torch.components import dispatch
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage

    server = tiny_server(tiny_pair[1], continuous_batching=2, kv_page_size=8)
    want = server.generate(["hello"], max_new_tokens=4)
    try:
        results = [None] * 3

        def client(i):
            results[i] = dispatch.predict(server, SeldonMessage.from_dict(
                {"jsonData": {"prompt": "hello", "max_new_tokens": 4}})).to_dict()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        svc = server._batcher_service
        assert svc is not None and svc.batcher._admit_seq == 3
        assert server.tags() == {"llm_requests": 1}   # only the generate() above
        for got in results:
            assert got["jsonData"] == {"texts": want["texts"], "tokens": want["tokens"]}
            assert got["meta"]["tags"] == {"llm_requests": 1}
        private = dispatch.predict(server, SeldonMessage.from_dict(
            {"jsonData": {"prompt": "hello", "max_new_tokens": 4, "seed": 1}})).to_dict()
        assert private["jsonData"]["tokens"] == want["tokens"]
        assert svc.batcher._admit_seq == 3 and server.tags() == {"llm_requests": 2}
    finally:
        if server._batcher_service is not None:
            server._batcher_service.close()
