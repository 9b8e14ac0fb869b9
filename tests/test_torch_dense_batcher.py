"""The port's batcher over the dense slot pool (``kv_cache_layout="dense"``:
``runtime/batcher.py``'s dense arms, ``transformer.SlotCaches``,
``LLMServer._get_decode_step`` and the dense ``_get_spec_step``) held
against the JAX package's dense ``ContinuousBatcher`` on the CPU, at a tiny
width in float32 (vocab 96, dim 32, 2 layers, 4 query heads on 2 KV heads;
2 slots of 32 positions):

- greedy tokens equal JAX's dense batcher and the port's ``generate()``
  (held to JAX's elsewhere), float and int8
  weights + int8 KV, K = 1 and fused K = 4; every admission one eager
  prefill, every dispatch the eager step; the pool ``[slots, max_len + 1]``
  (a trash column a row); ``page_stats`` all zero, no trie even with
  ``prefix_cache_size``, and a slot's budget stops where JAX's does;
- seeded sampled tokens (the port's own chain) equal ``generate(seed=)``
  and the paged batcher's (paged == dense, JAX ``tests/test_paged_kv.py::
  test_paged_matches_dense_batcher``);
- a slot reused after a longer occupant decodes its solo tokens and holds
  none of the old occupant's positions; a free slot steps past ``max_len``
  into its trash column without error;
- n-gram (K = 1 and 4) and draft speculation over dense equal plain greedy
  and JAX's dense spec batcher, with JAX's counters;
- LoRA over dense: a mixed batch equals JAX's dense batcher and each
  request alone;
- the flight recorder's dense timeline (``prefill`` with the prompt's
  tokens, then ``first_token`` and the steps) equals JAX's;
- a loop killed mid-decode releases every slot and restarts to serve;
- ``/v1/generate``, SSE and ``BatcherService`` on a dense component equal
  ``generate()``;
- {data 2, model 2} and {data 1, seq 2, model 2}: the dense batcher over
  the mesh equals the unsharded port's and JAX's dense batcher on the same
  mesh (n-gram too on the 'seq' mesh).

Tolerances: tokens exactly."""

import asyncio
import http.client
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.tracing import TraceContext as JaxTraceContext
from seldon_core_tpu_torch.models.transformer import PAD_POS, SlotCaches
from seldon_core_tpu_torch.parallel.topology import Topology
from seldon_core_tpu_torch.runtime.adapters import projection_dims
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, ensure_stream_service
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.testing.faults import BatcherKiller, LeakSweep
from seldon_core_tpu_torch.tracing import TraceContext
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3)
BKW = dict(max_slots=2, max_len=32, len_buckets=(8,), pipeline_depth=2)
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11], [7], [60, 61, 62, 63],
           [12, 13, 14, 15, 16, 17, 18, 19, 20, 21]]
KNOBS = {"float": {}, "int8": dict(quantize="int8", kv_cache_dtype="int8")}
TIMEOUT = 120


def tree(server):
    return {"params": jax.tree_util.tree_map(np.asarray, server._params["params"])}


def port_server(params, **extra):
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


def serve(server, prompts, n=8, seeds=None, **kw):
    """All prompts at once through one port batcher (dense unless ``kw``
    says otherwise): (their tokens, the batcher, closed)."""
    b = ContinuousBatcher(server, device="cpu", **dict(BKW, **dict(dict(layout="dense"), **kw)))
    try:
        futs = [b.submit(p, n, seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        return [f.result(TIMEOUT) for f in futs], b
    finally:
        b.close()


def jax_serve(server, prompts, n=8, **kw):
    """The same through the JAX package's dense batcher: (tokens, spec_stats)."""
    async def go():
        b = JaxBatcher(server, **dict(BKW, **dict(dict(layout="dense"), **kw)))
        outs = await asyncio.gather(*[b.submit(p, max_new_tokens=n) for p in prompts])
        stats = b.spec_stats()
        await b.close()
        return outs, stats

    return asyncio.run(go())


@pytest.fixture(scope="module", params=list(KNOBS))
def pair(request):
    """(knobs, JAX server, port server on its weights), greedy."""
    knobs = KNOBS[request.param]
    j = JaxLLMServer(init_random=True, **dict(COMMON, **knobs))
    j.load()
    return request.param, j, port_server(tree(j), **knobs)


@pytest.fixture(scope="module")
def float_pair():
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    return j, port_server(tree(j))


# ------------------------------------------------------------ plain decode
@pytest.mark.parametrize("k", [1, 4])
def test_dense_greedy_equals_jax_dense_batcher(pair, k):
    _, j, p = pair
    fuse = dict(fuse_steps=k if k > 1 else 0)
    before = (p._prefill_eager, p._decode_eager)
    got, b = serve(p, PROMPTS, **fuse)
    want, _ = jax_serve(j, PROMPTS, **fuse)
    assert got == want == p.generate(PROMPTS, max_new_tokens=8)["tokens"]
    # one eager prefill an admission, the eager step every dispatch
    assert p._prefill_eager - before[0] == len(PROMPTS)
    assert p._decode_eager > before[1] and p._decode_replays == p._prefill_replays == 0
    assert isinstance(b._caches, SlotCaches) and b._caches.width == 32
    assert all(t.shape[:2] == (2, 33) for layer in b._caches for t in layer)
    assert b._block_tables is None and b._allocator is None


def test_dense_budget_stops_where_jax_does(float_pair):
    """A budget the row cannot hold stops at the cache edge, as JAX's dense
    layout does (the last token sits at position max_len, never written);
    page_stats all zero, no trie although the server asks for one."""
    j, p = float_pair
    q = port_server(tree(j), prefix_cache_size=4)
    got, b = serve(q, [PROMPTS[1], PROMPTS[4]], n=40)
    want, _ = jax_serve(j, [PROMPTS[1], PROMPTS[4]], n=40)
    assert got == want
    assert [len(t) for t in got] == [32 - 5 + 1, 32 - 10 + 1]
    assert b._radix is None
    assert b.page_stats() == {"kv_pages_total": 0, "kv_pages_in_use": 0, "kv_page_size": 0,
                              "kv_page_fragmentation": 0.0, "kv_page_sheds": 0}
    assert b.retry_after_hint() > 0


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_dense_seeded_equals_generate_and_paged(knobs, k):
    s = LLMServer(device="cpu", init_random=True,
                  **dict(COMMON, temperature=0.8, top_k=20, seed=5, **KNOBS[knobs]))
    s.load()
    seeds = [11, 99, 7, 4, 23]
    fuse = dict(fuse_steps=k if k > 1 else 0)
    dense, _ = serve(s, PROMPTS, seeds=seeds, **fuse)
    paged, _ = serve(s, PROMPTS, seeds=seeds, layout="paged", page_size=8, **fuse)
    assert dense == paged == [s.generate([q], max_new_tokens=8, seed=sd)["tokens"][0]
                              for q, sd in zip(PROMPTS, seeds)]


def test_slot_reused_after_longer_occupant(float_pair):
    """One slot: a long occupant, then a short one, which decodes its solo
    tokens; the row holds nothing of the old occupant past the short one's
    writes (admission reset it, trash column included)."""
    _, p = float_pair
    b = ContinuousBatcher(p, device="cpu", **dict(BKW, max_slots=1, layout="dense"))
    try:
        b.submit(PROMPTS[4], 16).result(TIMEOUT)
        short = b.submit([7], 6).result(TIMEOUT)
        assert short == p.generate([[7]], max_new_tokens=6)["tokens"][0]
        b._quiesce()
        for layer in b._caches:
            pos = layer[-1][0]
            # written: the prompt (1) and the steps fed so far, the run-ahead included
            assert torch.all(pos[12:] == PAD_POS), pos
            assert torch.equal(pos[:6], torch.arange(6, dtype=pos.dtype))
    finally:
        b.close()


def test_free_slot_steps_past_max_len(float_pair):
    """Requests one after another on slot 0 while slot 1 stays free: slot 1
    keeps stepping with the batch, past its row's 32 positions, and its
    writes past the row land in its trash column (position PAD_POS) without
    an error; the served tokens are the solo ones."""
    _, p = float_pair
    b = ContinuousBatcher(p, device="cpu", **dict(BKW, layout="dense"))
    try:
        for q in PROMPTS[:4]:
            assert b.submit(q, 12).result(TIMEOUT) == p.generate([q], max_new_tokens=12)[
                "tokens"][0]
        b._quiesce()
        assert int(b._next_pos[1]) > 40 and b.crashed is None
        for layer in b._caches:
            assert int(layer[-1][1, 32]) == PAD_POS   # slot 1's trash column
    finally:
        b.close()


# ------------------------------------------------------------ speculation
@pytest.mark.parametrize("k", [1, 4])
def test_ngram_dense_equals_greedy_and_jax(float_pair, k):
    j, p = float_pair
    got, b = serve(p, PROMPTS, spec_mode="ngram", spec_k=k)
    want, jst = jax_serve(j, PROMPTS, spec_mode="ngram", spec_k=k)
    assert got == want == p.generate(PROMPTS, max_new_tokens=8)["tokens"]
    st = b.spec_stats()
    for key in ("spec_accept_rate", "spec_tokens_per_forward", "spec_slot_steps_total"):
        assert st[key] == pytest.approx(jst[key]), key


def test_draft_dense_equals_jax_perfect_drafter():
    """A draft configured like the target and holding its weights: every
    draft verifies (acceptance 1.0), tokens equal JAX's dense draft batcher
    and greedy."""
    extra = dict(spec_mode="draft", spec_k=4, draft_model="transformer", draft_model_kwargs=KW)
    j = JaxLLMServer(init_random=True, **dict(COMMON, **extra))
    j.load()
    draft = {"params": jax.tree_util.tree_map(np.asarray, j._draft_params["params"])}
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=tree(j), draft_params=draft)
    got, b = serve(s, PROMPTS)
    want, jst = jax_serve(j, PROMPTS)
    assert got == want == s.generate(PROMPTS, max_new_tokens=8)["tokens"]
    st = b.spec_stats()
    assert st["spec_accept_rate"] == pytest.approx(1.0) == jst["spec_accept_rate"]
    assert st["spec_tokens_per_forward"] == pytest.approx(jst["spec_tokens_per_forward"])


# ------------------------------------------------------------ LoRA
RANK = 4
NAMES = ["tenant-0", "tenant-1", "tenant-2"]


def _load_adapters(server):
    rng = np.random.default_rng(1234)
    cfg = server._cfg
    for name in NAMES:
        w = {proj: (rng.normal(size=(cfg.n_layers, din, RANK)) * 0.25,
                    rng.normal(size=(cfg.n_layers, RANK, dout)) * 0.25)
             for proj, (din, dout) in projection_dims(cfg).items()}
        server.adapter_registry.load(name, w, alpha=2 * RANK)


def test_lora_dense_equals_jax_and_solo():
    extra = dict(lora_rank=RANK, lora_max_adapters=6)
    j = JaxLLMServer(init_random=True, **dict(COMMON, **extra))
    j.load()
    _load_adapters(j)
    p = port_server(tree(j), **extra)
    _load_adapters(p)
    prompts, adapters = PROMPTS[:4], NAMES + [None]

    def port_run(ps, ads, slots):
        b = ContinuousBatcher(p, device="cpu", **dict(BKW, max_slots=slots, layout="dense"))
        try:
            futs = [b.submit(q, 6, adapter=a, tenant=a or "base") for q, a in zip(ps, ads)]
            return [f.result(TIMEOUT) for f in futs]
        finally:
            b.close()

    async def jax_run():
        b = JaxBatcher(j, **dict(BKW, max_slots=4, layout="dense"))
        outs = await asyncio.gather(*[b.submit(q, max_new_tokens=6, adapter=a, tenant=a or "base")
                                      for q, a in zip(prompts, adapters)])
        await b.close()
        return outs

    before = p._prefill_eager
    mixed = port_run(prompts, adapters, 4)
    assert p._prefill_eager - before == 4
    assert mixed == asyncio.run(jax_run())
    for q, a, got in zip(prompts, adapters, mixed):
        assert got == port_run([q], [a], 1)[0], a
    assert mixed[3] == p.generate([prompts[3]], max_new_tokens=6)["tokens"][0]
    assert all(p.adapter_registry.refs_of(n) == 0 for n in NAMES)


# ------------------------------------------------------------ flight, crash
def _kinds(timeline):
    return [(e["kind"], e.get("tokens")) for e in timeline["events"]]


def test_dense_timeline_equals_jax(float_pair):
    j, p = float_pair

    async def jax_run():
        b = JaxBatcher(j, tracing=True, **dict(BKW, max_slots=3, layout="dense"))
        ctxs = [JaxTraceContext.from_traceparent(None, ingress="rest:/v1/generate")
                for _ in PROMPTS]
        outs = await asyncio.gather(*[b.submit(q, max_new_tokens=8, trace=ctxs[i])
                                      for i, q in enumerate(PROMPTS)])
        rec = b._flight
        await b.close()
        return outs, rec, ctxs

    jouts, jrec, jctxs = asyncio.run(jax_run())
    b = ContinuousBatcher(p, device="cpu", tracing=True, **dict(BKW, max_slots=3, layout="dense"))
    try:
        ctxs = [TraceContext.from_traceparent(None, ingress="rest:/v1/generate") for _ in PROMPTS]
        outs = [f.result(TIMEOUT) for f in [b.submit(q, 8, trace=ctxs[i])
                                            for i, q in enumerate(PROMPTS)]]
    finally:
        b.close()
    assert outs == jouts
    got = {t["trace_id"]: t for t in b._flight.timelines()}
    want = {t["trace_id"]: t for t in jrec.timelines()}
    for i, prompt in enumerate(PROMPTS):
        g, w = got[ctxs[i].trace_id], want[jctxs[i].trace_id]
        assert _kinds(g) == _kinds(w), i
        assert _kinds(g)[:2] == [("prefill", len(prompt)), ("first_token", 1)]
        assert (g["status"], g["tokens"], g["token_events_sum"]) == ("done", 8, 8)
    assert b._flight.live_slots() == []


def test_crash_path_releases_every_slot(float_pair):
    """A loop killed mid-decode with both slots busy: every slot released
    before the clients are told, no residue, and the restarted loop serves
    the solo tokens."""
    _, p = float_pair
    s = port_server(tree(float_pair[0]), kv_cache_layout="dense", continuous_batching=2,
                    max_new_tokens=16)
    svc = ensure_stream_service(s)
    b = svc.batcher
    assert not b.paged
    sweep = LeakSweep(b)
    try:
        got = []
        killer = BatcherKiller(trigger=lambda _: len(got) >= 3).install(b)
        futs = [svc.submit(q, 16, on_token=got.append) for q in PROMPTS[:2]]
        for f in futs:
            with pytest.raises(Exception, match="chaos"):
                f.result(TIMEOUT)
        killer.killed_thread.join(TIMEOUT)
        assert b.crashed is not None and b._thread is None
        assert not any(sl.active or sl.prefilling for sl in b._slots)
        sweep.assert_clean("the kill")
        assert svc.submit_sync(PROMPTS[2], 5) == p.generate([PROMPTS[2]], max_new_tokens=5)[
            "tokens"][0]
        assert b.crashed is None
        sweep.assert_clean("serving after the restart")
    finally:
        svc.close()


# ------------------------------------------------------------ the entry points
def test_rest_sse_and_service_serve_dense(float_pair):
    j, p = float_pair
    s = port_server(tree(j), kv_cache_layout="dense", continuous_batching=2)
    want = p.generate([PROMPTS[1]], max_new_tokens=6)["tokens"][0]
    httpd, _ = start(make_component_app(s, device="cpu"))
    port = httpd.server_address[1]
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                     data=json.dumps({"prompt": PROMPTS[1],
                                                      "max_new_tokens": 6}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 200 and json.loads(r.read())["tokens"] == want
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        conn.request("POST", "/v1/generate", json.dumps({"prompt": PROMPTS[1], "max_new_tokens": 6,
                                                         "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        events = [json.loads(line[6:]) for line in resp.read().decode().splitlines()
                  if line.startswith("data: ")]
        assert [e["token"] for e in events if "token" in e] == want
        svc = ensure_stream_service(s)
        assert not svc.batcher.paged and svc.submit_sync(PROMPTS[1], 6) == want
    finally:
        httpd.shutdown()
        httpd.server_close()
        s._batcher_service.close()


# ------------------------------------------------------------ meshes
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
            max_seq_len=128, dtype="float32", tie_embeddings=True)
MESHES = {"data2-model2": {"data": 2, "model": 2},
          "seq2-model2": {"data": 1, "seq": 2, "model": 2}}
MBKW = dict(max_slots=4, max_len=36, len_buckets=(16, 32), pipeline_depth=2)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_dense_equals_unsharded_and_jax(mesh, eight_devices):
    axes = MESHES[mesh]
    size = int(np.prod(list(axes.values())))
    shape = dict(model="transformer", model_kwargs=TINY, max_new_tokens=6, len_buckets=(16, 32),
                 batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3)
    j = JaxLLMServer(init_random=True, mesh=jax_make_mesh(axes, eight_devices[:size]), **shape)
    j.load()
    params = tree(j)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 255, size=int(n)).tolist() for n in (5, 14, 27, 9)]

    def port(mesh_axes, **extra):
        s = LLMServer(device="cpu", mesh=None if mesh_axes is None else
                      Topology(devices=["cpu"] * size).mesh(mesh_axes), **dict(shape, **extra))
        s.load(params=params)
        return s

    plain, _ = serve(port(None), prompts, n=6, **MBKW)
    sharded = port(axes)
    got, b = serve(sharded, prompts, n=6, **MBKW)
    jgot, _ = jax_serve(j, prompts, n=6, **MBKW)
    assert got == plain == jgot
    sp = axes.get("seq", 1)
    n = -(-36 // sp)
    assert b._caches.width == 36 and b._caches.lead == (4, sp * (n + 1))
    assert all(layer[-1].shape == (4 // axes["data"], n + 1) for layer in b._caches)
    if sp > 1:
        spec, _ = serve(port(axes, spec_mode="ngram", spec_k=3), prompts, n=6, **MBKW)
        assert spec == plain
