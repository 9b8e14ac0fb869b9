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
    q, (k, v, pos), bt, qpos = make_case(0)
    cache = tuple(torch.from_numpy(a) for a in (k, v, pos))
    before = port.paged_attention.launches
    port.paged_attention(torch.from_numpy(q), cache, torch.from_numpy(bt),
                         torch.from_numpy(qpos))
    assert port.paged_attention.launches == before
    with pytest.raises(ValueError):
        port.paged_attention(torch.zeros((B, 2, H, HD)), cache, torch.from_numpy(bt),
                             torch.from_numpy(qpos))
    with pytest.raises(NotImplementedError):
        port.paged_attention(torch.from_numpy(q), cache + (None, None),
                             torch.from_numpy(bt), torch.from_numpy(qpos))


def test_write_targets_redirect_garbage():
    """NULL table entries and past-table positions redirect to TRASH_PAGE,
    as the JAX package's ``paged_write_targets`` does."""
    bt = torch.tensor([[2, 3, NULL_PAGE]], dtype=torch.int32)
    positions = torch.tensor([[0, 9, 16, 23, 24, 999, PAD_POS]], dtype=torch.int32)
    entry, off = paged_write_targets(bt, positions, 8)
    assert entry[0].tolist() == [2, 3] + [TRASH_PAGE] * 5
    assert off[0, :2].tolist() == [0, 1]

