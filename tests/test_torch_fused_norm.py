"""Port of the fused residual-add + RMSNorm (seldon_core_tpu_torch/ops/
fused_norm.py) held against the JAX package: the port's plain version
(what a CPU tensor takes) against JAX ``residual_rmsnorm_ref`` and against
the Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances: float32 within 1e-6 (the same op chain; only the mean's
reduction order may differ); bf16 ``y`` bit-equal (one rounding of a
float32 add in both) and ``o`` within one bf16 ulp. The Triton kernel
itself runs only on a card: tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seldon_core_tpu.ops.fused_norm import fused_residual_rmsnorm as jax_fused
from seldon_core_tpu.ops.fused_norm import residual_rmsnorm_ref as jax_ref
from seldon_core_tpu_torch.ops import fused_norm as port

SHAPES = [(7, 128), (2, 3, 64), (5, 200), (3, 130)]  # ragged d: 200, 130


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1]).astype(np.float32))


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_plain_matches_jax_f32(shape, oracle):
    x, h, w = _inputs(shape, 0)
    jx, jh, jw = jnp.asarray(x), jnp.asarray(h), jnp.asarray(w)
    if oracle == "ref":
        jy, jo = jax_ref(jx, jh, jw, 1e-5)
    else:
        jy, jo = jax_fused(jx, jh, jw, 1e-5, interpret=True)
    py, po = port.fused_residual_rmsnorm(torch.from_numpy(x), torch.from_numpy(h),
                                         torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_plain_matches_jax_bf16(shape, oracle):
    x, h, w = _inputs(shape, 1)
    jx, jh = jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16)
    if oracle == "ref":
        jy, jo = jax_ref(jx, jh, jnp.asarray(w), 1e-5)
    else:
        jy, jo = jax_fused(jx, jh, jnp.asarray(w), 1e-5, interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    th = torch.from_numpy(h).to(torch.bfloat16)
    py, po = port.fused_residual_rmsnorm(tx, th, torch.from_numpy(w), 1e-5)
    assert py.dtype == torch.bfloat16 and po.dtype == torch.bfloat16
    np.testing.assert_array_equal(py.float().numpy(), np.asarray(jy, np.float32))
    jo32 = np.asarray(jo, np.float32)
    assert np.all(np.abs(po.float().numpy() - jo32) <= _bf16_ulp(jo32))


def test_plain_is_unfused_block_path():
    """The fused call's contract is the unfused ``x + h`` then rms_norm."""
    from seldon_core_tpu_torch.models.transformer import rms_norm

    x, h, w = (torch.from_numpy(a) for a in _inputs((4, 96), 2))
    y, o = port.fused_residual_rmsnorm(x, h, w, 1e-5)
    assert torch.equal(y, x + h)
    assert torch.equal(o, rms_norm(x + h, w, 1e-5))


def test_wrapper_checks_shapes_and_counts_only_launches():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        port.fused_residual_rmsnorm(x, torch.zeros((2, 9)), torch.ones(8), 1e-5)
    with pytest.raises(ValueError):
        port.fused_residual_rmsnorm(x, x, torch.ones(9), 1e-5)
    before = port.fused_residual_rmsnorm.launches
    port.fused_residual_rmsnorm(x, x, torch.ones(8), 1e-5)
    assert port.fused_residual_rmsnorm.launches == before  # CPU: plain, no launch

