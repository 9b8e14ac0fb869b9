"""The port's paged batcher over a serving mesh (``runtime/batcher.py`` on a
``models/sharded.py`` model whose ranks share the CPU) against the unsharded
port batcher and the JAX package on 8 virtual devices, float32:

- on {data 2, model 2}, {data 1, seq 2, model 2} and {data 2, seq 2,
  model 1}, float weights and int8 weights + int8 KV: greedy tokens equal
  the unsharded port batcher's and JAX's ``generate()`` on the same mesh;
  one pool a (data, seq) pair, a slot's pages in its data rank's pools, a
  sequence's page j on seq rank j mod sp; every page comes back;
- K1's partial mode (its plain version, what a CPU tensor takes) merged by
  ``softmax_merge`` over 2 and 4 'seq' ranks within 1e-5 of
  ``paged_attention_ref`` over the whole table, a rank holding no page of a
  row included;
- the prefix trie keyed by data rank on {data 2, model 2}: each rank's hits
  and copy-on-write copies equal the traffic's arithmetic, and the tokens
  equal the trie-off batcher's.

Tolerances: tokens exactly; the partial merge 1e-5 (float32 sums in
another order)."""

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import (NULL_PAGE, PAD_POS, RESERVED_PAGES,
                                                      quantize_kv)
from seldon_core_tpu_torch.ops.paged_attention import (paged_attention_partial,
                                                       paged_attention_ref)
from seldon_core_tpu_torch.parallel import collectives
from seldon_core_tpu_torch.parallel.topology import Topology
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.servers.llmserver import LLMServer

TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
            max_seq_len=128, dtype="float32", tie_embeddings=True)
MESHES = {"data2-model2": {"data": 2, "model": 2},
          "seq2-model2": {"data": 1, "seq": 2, "model": 2},
          "data2-seq2": {"data": 2, "seq": 2, "model": 1}}
KNOBS = {"float": {}, "int8": dict(quantize="int8", kv_cache_dtype="int8")}
SHAPE = dict(max_new_tokens=6, len_buckets=(16, 32), batch_buckets=(1, 4))
TIMEOUT = 120


def _size(axes):
    return int(np.prod(list(axes.values())))


def _jax_server(axes, devices, **extra):
    mesh = None if axes is None else jax_make_mesh(axes, devices[:_size(axes)])
    s = JaxLLMServer(model="transformer", model_kwargs=TINY, init_random=True, temperature=0.0,
                     eos_id=-1, seed=3, mesh=mesh, **extra)
    s.load()
    return s


def _port(tree, axes=None, **extra):
    mesh = None if axes is None else Topology(devices=["cpu"] * _size(axes)).mesh(axes)
    s = LLMServer(model="transformer", model_kwargs=TINY, temperature=0.0, eos_id=-1, seed=3,
                  device="cpu", mesh=mesh, **extra)
    s.load(params=tree)
    return s


def _serve(server, prompts, **kw):
    b = ContinuousBatcher(server, device="cpu", max_slots=4, prefill_chunk=8, page_size=8, **kw)
    try:
        outs = [f.result(TIMEOUT) for f in [b.submit(p, 6) for p in prompts]]
        assert b.page_stats()["kv_pages_in_use"] == 0
    finally:
        b.close()
    return outs, b


@pytest.fixture(scope="module")
def jax_float():
    return _jax_server(None, None, **SHAPE)


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_batcher_equals_unsharded_and_jax(mesh, knobs, jax_float, eight_devices):
    axes = MESHES[mesh]
    extra = dict(KNOBS[knobs], **SHAPE)
    tree = {"params": jax.tree_util.tree_map(np.asarray, jax_float._params["params"])}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 255, size=int(n)).tolist() for n in (5, 14, 27, 9)]
    plain, _ = _serve(_port(tree, **extra), prompts)
    sharded = _port(tree, axes, **extra)
    got, b = _serve(sharded, prompts)
    assert sharded._prefill_eager > 0 and sharded._decode_eager > 0
    assert got == plain
    # JAX on the same mesh; for int8 a server of the same seed that
    # quantizes the same init, then shards it over JAX's own mesh
    assert got == _jax_server(axes, eight_devices, **extra).generate(prompts)["tokens"]
    # the pools: one a (data, seq) pair, each rank's 'model' share of its
    # KV heads, the pages past the reserved ones split evenly
    dp, sp = axes.get("data", 1), axes.get("seq", 1)
    m = sharded._module
    assert m.page_pools() == dp * sp and b._allocator.pools == dp * sp
    local = m.pool_share((b.pool_pages, b.page_size))[0]
    assert all(layer[-1].shape[0] == local for layer in b._caches)
    assert (local - RESERVED_PAGES) * dp * sp == b.pool_pages - RESERVED_PAGES


@pytest.mark.parametrize("mesh", ["data2-model2", "data2-seq2"])
def test_pages_lie_in_the_slot_rank_pools(mesh):
    """Live block tables over 'data' and 'seq': slot i's page j comes from
    pool (i's data rank) * sp + j mod sp, and each rank's table holds its
    own pages at local ids (another rank's page, TRASH)."""
    axes = MESHES[mesh]
    s = LLMServer(model="llama-tiny", init_random=True, max_new_tokens=4, len_buckets=(32,),
                  device="cpu", mesh=Topology(devices=["cpu"] * _size(axes)).mesh(axes))
    s.load()
    b = ContinuousBatcher(s, device="cpu", max_slots=4, page_size=4)
    try:
        dp, sp = axes.get("data", 1), axes.get("seq", 1)
        for i, n in ((0, 7), (3, 5)):
            pages = b._alloc_pages(i, 0, n)
            assert [b._allocator.pool_of(p) for p in pages] == [
                b._data_rank(i) * sp + j % sp for j in range(n)]
            b._block_tables[i, :n] = torch.tensor(pages, dtype=torch.int32)
        rows = [s._module._rows(r, 4) for r in range(s.mesh.size)]
        tables = s._module.rank_tables(b._block_tables, b._caches, rows)
        cap = b._allocator.pool_cap
        for r, t in enumerate(tables):
            c = s.mesh.coords(r)
            mine = [p for p in range(RESERVED_PAGES, b.pool_pages)
                    if b._allocator.pool_of(p) == c["data"] * sp + c.get("seq", 0)]
            want = b._block_tables[rows[r]][:, c.get("seq", 0)::sp].long()
            want = torch.where(torch.isin(want, torch.tensor(mine)),
                               want - (c["data"] * sp + c.get("seq", 0)) * cap, want)
            assert torch.equal(t.long(), want), r
    finally:
        b.close()


# -------------------------------------------------- K1's partial mode
def _pool(rng, n_pool, ps, kvh, hd):
    k = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    k[:RESERVED_PAGES] = 0
    v[:RESERVED_PAGES] = 0
    return torch.from_numpy(k), torch.from_numpy(v)


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("sp", [2, 4])
def test_k1_partial_merged_over_seq_ranks_equals_ref(sp, kv):
    """Each 'seq' rank reads its table columns ``s::sp`` (pages s, s + sp,
    ...) through the partial mode; the merge equals one read of the whole
    table. Row 1 has one page, so ranks 1.. hold none of it; row 2 has
    nothing but its first token."""
    rng = np.random.default_rng(40 + sp)
    b, h, kvh, hd, ps, n_pages = 3, 4, 2, 16, 8, 6
    n_pool = RESERVED_PAGES + b * n_pages
    k, v = _pool(rng, n_pool, ps, kvh, hd)
    pos = torch.full((n_pool, ps), PAD_POS, dtype=torch.int32)
    bt = torch.full((b, n_pages), NULL_PAGE, dtype=torch.int32)
    ctx = [41, 5, 1]
    perm = rng.permutation(n_pool - RESERVED_PAGES) + RESERVED_PAGES
    at = 0
    for i, n in enumerate(ctx):
        for j in range(-(-n // ps)):
            page = int(perm[at])
            at += 1
            bt[i, j] = page
            span = min(ps, n - j * ps)
            pos[page, :span] = torch.arange(j * ps, j * ps + span, dtype=torch.int32)
    cache = (k, v, pos)
    if kv == "int8":
        cache = (*quantize_kv(k), *quantize_kv(v), pos)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(np.float32))
    qpos = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32)
    want = paged_attention_ref(q, cache, bt, qpos)
    parts = [paged_attention_partial(q, cache, bt[:, s::sp].contiguous(), qpos, sp, s)
             for s in range(sp)]
    m, l, acc = parts[1]
    assert m.shape == l.shape == (b, h, 1) and acc.shape == (b, 1, h, hd)
    assert (m[1] == torch.finfo(torch.float32).min).all()   # no page of row 1 on rank 1
    got = collectives.softmax_merge(parts, torch.float32)[0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="stride"):
        paged_attention_partial(q, cache, bt, qpos, sp, sp)


# -------------------------------------------------- the trie over 'data'
def _common(a, b):
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def test_trie_keyed_by_data_rank():
    """Two conversations admitted together land on the two data ranks (no
    hit, most free slots); each second turn lands where its first turn's
    history is cached, and each rank's trie counts that hit: k0 = the
    common prefix with the inserted history (the prompt and every credited
    token but the last), capped at the prompt less one, in k0 // ps shared
    pages and one copy-on-write copy for a remainder. Tokens equal the
    trie-off batcher's; after clearing the tries no page is held."""
    ps = 8
    kw = dict(model="llama-tiny", init_random=True, max_new_tokens=6, len_buckets=(16, 32),
              temperature=0.0, seed=3, device="cpu", eos_id=-1, kv_page_size=ps)
    mesh = Topology(devices=["cpu"] * 4).mesh({"data": 2, "model": 2})
    rng = np.random.default_rng(9)
    first = [rng.integers(1, 255, size=20).tolist() for _ in range(2)]
    got = {}
    for name, cache in (("on", 8), ("off", 0)):
        s = LLMServer(mesh=mesh, prefix_cache_size=cache, **kw)
        s.load()
        b = ContinuousBatcher(s, device="cpu", max_slots=4)
        try:
            turn1 = [f.result(TIMEOUT) for f in [b.submit(p, 6) for p in first]]
            second = [p + t[:2] + [7, 11] for p, t in zip(first, turn1)]
            turn2 = [f.result(TIMEOUT) for f in [b.submit(p, 6) for p in second]]
            got[name] = (turn1, turn2)
            if cache:
                for d in range(2):
                    hist = first[d] + turn1[d][:5]
                    k0 = min(_common(hist, second[d]), len(second[d]) - 1)
                    st = b._radix.tries[d].stats()
                    assert st["prefix_hit_tokens"] == k0, d
                    assert st["prefix_hit_blocks"] == k0 // ps + (k0 % ps > 0), d
                    assert st["prefix_cow_copies"] == int(k0 % ps > 0), d
                total = b._radix.stats()
                assert total["prefix_cached_blocks"] == b.page_stats()["kv_pages_in_use"] > 0
                b._radix.clear()
            assert b.page_stats()["kv_pages_in_use"] == 0
        finally:
            b.close()
    assert got["on"] == got["off"]
