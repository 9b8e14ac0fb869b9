"""Port of the paged-attention decode read (seldon_core_tpu_torch/ops/
paged_attention.py) held against the JAX package: the port's plain version
(what a CPU tensor takes) against JAX ``paged_attention_ref`` and against
the Pallas kernel in interpret mode, in float32 within 1e-5 (the same
gather + masked softmax; only reduction order differs).

The block tables cover GQA (h=4, kvh=2), non-contiguous and shared pages,
an all-NULL_PAGE row (must stay finite), and query positions mid-page. The
CUDA kernel itself runs only on a card: tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seldon_core_tpu.models.transformer import PAD_POS as JAX_PAD_POS
from seldon_core_tpu.ops.paged_attention import paged_attention as jax_kernel
from seldon_core_tpu.ops.paged_attention import paged_attention_ref as jax_ref
from seldon_core_tpu_torch.models.transformer import (NULL_PAGE, PAD_POS, TRASH_PAGE,
                                                      paged_write_targets)
from seldon_core_tpu_torch.ops import paged_attention as port

B, H, KVH, HD, PS, N_PAGES, POOL = 4, 4, 2, 16, 8, 4, 14


def make_case(seed: int):
    """Pool + tables: row 0 on scattered pages, row 1 sharing row 0's first
    page (a common prefix) then its own, row 2 all NULL_PAGE, row 3 a
    single page; query positions mid-page."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((POOL, PS, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((POOL, PS, KVH, HD)).astype(np.float32)
    k[NULL_PAGE] = v[NULL_PAGE] = 0.0
    pos = np.full((POOL, PS), PAD_POS, np.int32)
    bt = np.full((B, N_PAGES), NULL_PAGE, np.int32)
    rows = {0: ([9, 3, 12], 21), 1: ([9, 5], 13), 3: ([7], 4)}
    for i, (pages, qpos) in rows.items():
        bt[i, :len(pages)] = pages
        for j, p in enumerate(pages):
            n = min(PS, qpos + 1 - j * PS)
            pos[p, :n] = np.arange(j * PS, j * PS + n)
    qpos = np.array([[21], [13], [5], [4]], np.int32)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    return q, (k, v, pos), bt, qpos


def test_case_uses_jax_sentinels():
    assert PAD_POS == JAX_PAD_POS


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_plain_matches_jax(seed, oracle):
    q, (k, v, pos), bt, qpos = make_case(seed)
    jcache = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    if oracle == "ref":
        want = jax_ref(jnp.asarray(q), jcache, jnp.asarray(bt), jnp.asarray(qpos))
    else:
        want = jax_kernel(jnp.asarray(q), jcache, jnp.asarray(bt), jnp.asarray(qpos),
                          interpret=True)
    tcache = tuple(torch.from_numpy(a) for a in (k, v, pos))
    got = port.paged_attention(torch.from_numpy(q), tcache, torch.from_numpy(bt),
                               torch.from_numpy(qpos))
    assert got.shape == (B, 1, H, HD)
    assert torch.isfinite(got).all()  # the all-NULL row included
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_plain_wrapper_counts_no_launch_and_rejects_prefill_and_int8():
    """The plain version launches nothing; the wrapper rejects a prefill
    query (s > 1) and a cache that is neither the bf16 triple nor the int8
    5-tuple."""
    q, (k, v, pos), bt, qpos = make_case(0)
    cache = tuple(torch.from_numpy(a) for a in (k, v, pos))
    before = port.paged_attention.launches
    port.paged_attention(torch.from_numpy(q), cache, torch.from_numpy(bt),
                         torch.from_numpy(qpos))
    assert port.paged_attention.launches == before
    with pytest.raises(ValueError):
        port.paged_attention(torch.zeros((B, 2, H, HD)), cache, torch.from_numpy(bt),
                             torch.from_numpy(qpos))
    with pytest.raises(ValueError, match="5-tuple"):
        port.paged_attention(torch.from_numpy(q), cache + (None,),
                             torch.from_numpy(bt), torch.from_numpy(qpos))


def test_write_targets_redirect_garbage():
    """NULL table entries and past-table positions redirect to TRASH_PAGE,
    as the JAX package's ``paged_write_targets`` does."""
    bt = torch.tensor([[2, 3, NULL_PAGE]], dtype=torch.int32)
    positions = torch.tensor([[0, 9, 16, 23, 24, 999, PAD_POS]], dtype=torch.int32)
    entry, off = paged_write_targets(bt, positions, 8)
    assert entry[0].tolist() == [2, 3] + [TRASH_PAGE] * 5
    assert off[0, :2].tolist() == [0, 1]



# ---------------------------------------------------------------------------
# The kernel's split design on the CPU: its plan, and a plain emulation of
# its split-and-merge held against the JAX package
# ---------------------------------------------------------------------------
F32_MIN = float(np.finfo(np.float32).min)
SPLIT_PS, SPLIT_PAGES, SPLIT_HD = 32, 4, 16   # chunks of 16 keys: 8 chunks per table


def split_merge_emulation(q, cache, bt, qpos, splits):
    """The CUDA kernel's arithmetic in plain float32 PyTorch (a test aid):
    each row walks pages 0 .. max(1, min(n_pages, qpos // ps + 1)) - 1 in
    chunks of ``_chunk_keys(ps)`` keys; split s of S takes the s-th of S
    equal contiguous chunk ranges and keeps (m, l, acc) of a masked softmax
    (masked logits ``finfo(float32).min``), an empty range (-FLT_MAX, 0, 0);
    the splits merge by log-sum-exp. q [b, 1, h, hd]; cache the float32
    triple or the int8 5-tuple (numpy)."""
    q = torch.from_numpy(q)[:, 0]                              # [b, h, hd]
    b, h, hd = q.shape
    if len(cache) == 5:
        kq, ks, vq, vs, pos = (torch.from_numpy(a) for a in cache)
        k = kq.float() * ks[..., None]
        v = vq.float() * vs[..., None]
    else:
        k, v, pos = (torch.from_numpy(a) for a in cache)
    ps, kvh = k.shape[1], k.shape[2]
    G = h // kvh
    chunk = port._chunk_keys(ps)
    out = torch.empty((b, h, hd))
    for i in range(b):
        qp = int(qpos[i, 0])
        last_page = max(1, min(bt.shape[1], int(qp / ps) + 1))   # C's truncating division
        n_chunks = last_page * (ps // chunk)
        per = -(-n_chunks // splits)
        parts = []
        for s in range(splits):
            c0, c1 = s * per, min(n_chunks, (s + 1) * per)
            if c0 >= n_chunks:
                parts.append((torch.full((h,), F32_MIN), torch.zeros(h), torch.zeros(h, hd)))
                continue
            keys = torch.arange(c0 * chunk, c1 * chunk)
            pages = torch.from_numpy(bt[i]).long()[keys // ps]
            kk, vv = k[pages, keys % ps], v[pages, keys % ps]    # [n, kvh, hd]
            kk = kk.repeat_interleave(G, dim=1)
            vv = vv.repeat_interleave(G, dim=1)
            logits = torch.einsum("hd,nhd->hn", q[i], kk) * hd ** -0.5
            logits = logits.masked_fill(~(pos[pages, keys % ps] <= qp)[None], F32_MIN)
            m = logits.max(dim=1).values
            p = torch.exp(logits - m[:, None])
            parts.append((m, p.sum(dim=1), torch.einsum("hn,nhd->hd", p, vv)))
        m_all = torch.stack([p[0] for p in parts])              # [S, h]
        w = torch.exp(m_all - m_all.max(dim=0).values)
        l_sum = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
        acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(dim=0)
        out[i] = acc / l_sum[:, None]
    return out[:, None]


def make_split_case(seed, h, kvh):
    """Rows: 70 keys over scattered pages (not a multiple of the chunk),
    1 key, an all-NULL row (nothing to attend: every split empty or fully
    masked), the full table of 128 keys."""
    rng = np.random.default_rng(seed)
    pool = 2 + 3 * SPLIT_PAGES
    k = rng.standard_normal((pool, SPLIT_PS, kvh, SPLIT_HD)).astype(np.float32)
    v = rng.standard_normal((pool, SPLIT_PS, kvh, SPLIT_HD)).astype(np.float32)
    k[NULL_PAGE] = v[NULL_PAGE] = 0.0
    pos = np.full((pool, SPLIT_PS), PAD_POS, np.int32)
    bt = np.full((4, SPLIT_PAGES), NULL_PAGE, np.int32)
    rows = {0: ([9, 3, 12], 70), 1: ([7], 1), 3: ([4, 5, 10, 11], 128)}
    for i, (pages, ctx) in rows.items():
        bt[i, :len(pages)] = pages
        for j, p in enumerate(pages):
            n = min(SPLIT_PS, ctx - j * SPLIT_PS)
            pos[p, :n] = np.arange(j * SPLIT_PS, j * SPLIT_PS + n)
    qpos = np.array([[69], [0], [5], [127]], np.int32)
    q = rng.standard_normal((4, 1, h, SPLIT_HD)).astype(np.float32)
    return q, (k, v, pos), bt, qpos


_ORACLES = {}


def split_case_and_oracle(pool, G, oracle):
    """(case, JAX's answer) per pool, G and oracle, computed once."""
    key = (pool, G, oracle)
    if key not in _ORACLES:
        q, cache, bt, qpos = make_split_case(G, h=2 * G, kvh=2)
        if pool == "int8":
            from seldon_core_tpu.models import transformer as jt

            kq, ks = jt.quantize_kv(jnp.asarray(cache[0]))
            vq, vs = jt.quantize_kv(jnp.asarray(cache[1]))
            cache = tuple(np.array(a) for a in (kq, ks, vq, vs)) + (cache[2],)
        jargs = (jnp.asarray(q), tuple(jnp.asarray(a) for a in cache), jnp.asarray(bt),
                 jnp.asarray(qpos))
        want = jax_ref(*jargs) if oracle == "ref" else jax_kernel(*jargs, interpret=True)
        _ORACLES[key] = ((q, cache, bt, qpos), np.asarray(want))
    return _ORACLES[key]


@pytest.mark.parametrize("splits", range(1, SPLIT_PAGES * SPLIT_PS // 16 + 1))
@pytest.mark.parametrize("pool", ["float32", "int8"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_split_merge_emulation_matches_jax(splits, pool, G, oracle):
    """Every S from 1 to the table's chunk count: the split-and-merge gives
    the JAX package's answer within 1e-5 (float32), the all-NULL row
    (empty and fully masked splits only) included."""
    (q, cache, bt, qpos), want = split_case_and_oracle(pool, G, oracle)
    got = split_merge_emulation(q, cache, bt, qpos, splits)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_split_plan_properties():
    """S >= 1, never more than the chunks of n_pages pages, a pure function
    of its shapes; chunks divide the page; head tiles cover G in at most
    ceil(G / 8) tiles of a power of two."""
    for ps in (4, 8, 16, 24, 64, 100, 256):
        chunk = port._chunk_keys(ps)
        assert ps % chunk == 0 and chunk & (chunk - 1) == 0 and chunk <= port.CHUNK_KEYS
        for b in (1, 3, 8, 64):
            for kvh, G in ((32, 1), (8, 4), (4, 8), (2, 12), (1, 32)):
                for n_pages in (1, 2, 5, 65):
                    for hd, quantized in ((128, False), (64, True)):
                        args = (b, kvh, G, n_pages, ps, hd, quantized)
                        s = port._split_plan(*args)
                        assert 1 <= s <= n_pages * (ps // chunk)
                        port._split_plan.cache_clear()
                        assert port._split_plan(*args) == s
    for G in range(1, 40):
        tile = port._head_tile(G)
        assert tile in (1, 2, 4, 8) and tile >= min(G, 8)
        assert -(-G // tile) == max(1, -(-G // 8))
