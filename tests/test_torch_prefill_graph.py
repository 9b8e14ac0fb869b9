"""The port's paged prefill-chunk program (``LLMServer._get_prefill_chunk``)
and the batcher's prefill through its fixed buffers, held against the JAX
package on the CPU at llama-tiny widths with the JAX params crossed over.
On the CPU the program runs eagerly; its CUDA graphs (one per chunk length)
are tested on the card (``tests/test_torch_kernels_cuda.py``).

- ``_get_prefill_chunk(C, n_pages)`` gives the JAX package's
  ``_get_prefill_chunk(C, n_pages)`` logits within 1e-4 (float32, the
  port-vs-JAX tolerance of ``test_torch_transformer.py``) and its pools: the
  position rows equal, float K/V within 1e-5 (``test_torch_fused_decode``'s),
  int8 K/V codes within one step and their float32 scales within 1e-5 of
  each other (a float32 value may round to the neighbouring code), for
  C in {8, 16}, a first and a later chunk, a float and an int8 KV pool;
- the batcher through its fixed row, token and position buffers, with
  prompts of 1–3 chunks at two chunk lengths, gives ``generate()``'s greedy
  tokens and the JAX ``ContinuousBatcher``'s;
- the chunk lengths the batcher derives from ``_truncate_prompt`` are
  exactly those its admissions produce;
- on a stub card path (chunk graphs present) the batcher replays and never
  runs the eager program, and a chunk length without a graph raises."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.transformer import init_paged_kv_caches as jax_init_paged
from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxContinuousBatcher
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import (NULL_PAGE, PAD_POS, TRASH_PAGE,
                                                      init_paged_kv_caches)
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32", tie_embeddings=True)
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, eos_id=-1, seed=3,
              len_buckets=(16, 32), batch_buckets=(1, 4))
# prompts of 3, 5, 11 and 20 tokens: a chunk of 4, one chunk of 8, two of 8,
# and three of 8 (the last padded) under BATCH's buckets and chunk
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11], "hello world",
           [7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19]]
BATCH = dict(max_slots=2, max_len=48, page_size=8, prefill_chunk=8, len_buckets=(4, 16, 32))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_pair():
    s = JaxLLMServer(init_random=True, temperature=0.0, **COMMON)
    s.load()
    return s, {"params": jax.tree_util.tree_map(np.asarray, s._params["params"])}


@pytest.fixture(scope="module")
def server(jax_pair):
    s = LLMServer(device="cpu", temperature=0.0, **COMMON)
    s.load(params=jax_pair[1])
    return s


def _chunk_inputs(ids, start, C, n_pages, pages):
    toks = np.zeros((1, C), np.int64)
    pos = np.full((1, C), PAD_POS, np.int32)
    part = ids[start:start + C]
    toks[0, :len(part)] = part
    pos[0, :len(part)] = np.arange(start, start + len(part))
    row = np.full((1, n_pages), NULL_PAGE, np.int32)
    row[0, :len(pages)] = pages
    return toks, pos, row, len(part)


def _assert_pools_match(pools, jpools):
    """Every page but TRASH, whose K/V rows hold whichever padding token's
    write landed last (a scatter of duplicate indices, in either package)."""
    keep = np.arange(pools[0][0].shape[0]) != TRASH_PAGE
    for layer, jlayer in zip(pools, jpools):
        jl = [np.asarray(t) for t in jlayer]
        np.testing.assert_array_equal(layer[-1].numpy(), jl[-1])    # position rows
        if len(layer) == 5:
            for i in (0, 2):   # int8 codes, then their float32 scales
                codes = layer[i].numpy()[keep].astype(np.int32) - jl[i][keep].astype(np.int32)
                assert np.abs(codes).max() <= 1
                np.testing.assert_allclose(layer[i + 1].numpy()[keep], jl[i + 1][keep],
                                           rtol=1e-5)
        else:
            for a, b in zip(layer[:2], jl[:2]):
                np.testing.assert_allclose(a.numpy()[keep], b[keep], atol=1e-5)


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("C", [8, 16])
def test_prefill_chunk_program_equals_jax(jax_pair, server, C, kv):
    """A first chunk (C tokens at positions 0..C-1) and a later one (5
    tokens at C.., padded to C, attending over the first through the pool)
    written through a row of shuffled pages: the same logits and pools as
    the JAX package's program, chunk after chunk."""
    jserver, _ = jax_pair
    n_pages, ps, n_pool = 6, 8, 12
    ids = list(np.random.default_rng(C).integers(1, 256, C + 5))
    pages = [7, 2, 10, 4]
    pools = init_paged_kv_caches(server._cfg, n_pool, ps, kv, device="cpu")
    jpools = jax_init_paged(jserver._cfg, n_pool, ps, kv or None)
    prog = server._get_prefill_chunk(C, n_pages)
    assert server._get_prefill_chunk(C, n_pages) is prog
    assert ("pchunk", C, n_pages, False) in server._prefill_cache
    jfn = jserver._get_prefill_chunk(C, n_pages)
    for start in (0, C):
        toks, pos, row, n = _chunk_inputs(ids, start, C, n_pages, pages)
        want, jpools = jfn(jserver._params, jpools, jnp.asarray(row),
                           jnp.asarray(toks.astype(np.int32)), jnp.asarray(pos))
        with torch.no_grad():
            got = prog(pools, torch.from_numpy(row), torch.from_numpy(toks),
                       torch.from_numpy(pos))
        assert got.shape == (1, C, KW["vocab_size"])
        np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(want[:, :n]), **TOL)
        _assert_pools_match(pools, jpools)
    with pytest.raises(ValueError, match="pchunk"):
        prog(pools, torch.from_numpy(row), torch.from_numpy(toks[:, :C - 1]),
             torch.from_numpy(pos[:, :C - 1]))


def _run(server, prompts, n=10, **kw):
    b = ContinuousBatcher(server, device="cpu", **dict(BATCH, **kw))
    try:
        return [f.result(120) for f in [b.submit(p, n) for p in prompts]], b
    finally:
        b.close()


def test_batcher_prefill_through_fixed_buffers_equals_generate_and_jax(jax_pair, server):
    """Four prompts on two slots (two admitted while the first decode),
    prefilled in 1, 1, 2 and 3 chunks of two lengths (4 and 8) through the
    batcher's fixed row, token and position buffers: every token equals the
    private ``generate()``'s and the JAX paged batcher's (greedy), every
    chunk ran the eager program, and every page came back."""
    jserver, _ = jax_pair
    before = server._prefill_eager, server._prefill_replays
    outs, b = _run(server, PROMPTS)
    assert b._chunks == (4, 8)
    assert tuple(b._row.shape) == (1, b.n_pages) and tuple(b._chunk_tokens.shape) == (1, 8)
    assert outs == [server.generate([p], max_new_tokens=10)["tokens"][0] for p in PROMPTS]
    assert server._prefill_eager - before[0] == 1 + 1 + 2 + 3
    assert server._prefill_replays == before[1]
    assert b.page_stats()["kv_pages_in_use"] == 0

    async def jax_run():
        jb = JaxContinuousBatcher(jserver, layout="paged", **BATCH)
        got = await asyncio.gather(*[jb.submit(p, max_new_tokens=10) for p in PROMPTS])
        await jb.close()
        return got

    assert outs == [list(map(int, o)) for o in asyncio.run(jax_run())]


def test_chunk_lengths_cover_every_admission():
    """The chunk lengths ``_chunk_lengths`` derives are exactly the
    ``min(prefill_chunk, plen)`` of every prompt length ``_truncate_prompt``
    admits, up to past the model's context: with the defaults (buckets
    32/128/512/2048, chunk 256) {32, 128, 256}; with a chunk past the top
    bucket, its multiples too; with a chunk past the cap, the cap."""
    s = LLMServer(device="cpu", model="transformer", init_random=True, max_new_tokens=8,
                  model_kwargs=dict(KW, max_seq_len=4096))
    s.load()
    cases = [({}, (32, 128, 256)),
             (dict(len_buckets=(16, 48), prefill_chunk=200, max_len=1000),
              (16, 48, 96, 144, 192, 200)),
             (dict(len_buckets=(8, 16), prefill_chunk=8), (8,)),
             (dict(len_buckets=(8, 64), prefill_chunk=512, max_len=100), (8, 64, 99))]
    for kw, want in cases:
        b = ContinuousBatcher(s, device="cpu", max_slots=1, **kw)
        seen = {min(b.prefill_chunk, b._truncate_prompt([1] * n, 1, None)[1])
                for n in range(1, min(b.max_len, s._cfg.max_seq_len) + 300)}
        assert b._chunk_lengths() == b._chunks == tuple(sorted(seen)) == want, kw


class _StubGraph:
    """A captured chunk as the batcher sees it: ``replay()`` runs the
    chunk's program on the batcher's fixed buffers and returns its logits."""

    def __init__(self, server, b, C):
        self.replays = 0
        self.fn = lambda: server._get_prefill_chunk(C, b.n_pages)(
            b._caches, b._row, b._chunk_tokens[:, :C], b._chunk_pos[:, :C])

    def replay(self):
        self.replays += 1
        return self.fn()


def test_card_path_replays_and_a_chunk_without_a_graph_raises(server):
    """With chunk graphs present (stubs here) every chunk is a replay of its
    length's graph and no eager program runs; the tokens still equal
    ``generate()``'s. A chunk length without a graph raises (the request
    fails with it) instead of falling back to the eager program."""
    b = ContinuousBatcher(server, device="cpu", **BATCH)
    try:
        stubs = {C: _StubGraph(server, b, C) for C in b._chunks}
        b._prefill_graphs = dict(stubs)
        before = server._prefill_eager, server._prefill_replays
        outs = [f.result(120) for f in [b.submit(p, 10) for p in PROMPTS]]
        assert outs == [server.generate([p], max_new_tokens=10)["tokens"][0] for p in PROMPTS]
        assert (stubs[4].replays, stubs[8].replays) == (1, 6)
        assert server._prefill_replays - before[1] == 7
        assert server._prefill_eager == before[0]
        del b._prefill_graphs[4]
        with pytest.raises(RuntimeError, match="no prefill graph for a chunk of 4"):
            b.submit([5, 9, 17], 4).result(120)
        assert server._prefill_eager == before[0]
    finally:
        b.close()
