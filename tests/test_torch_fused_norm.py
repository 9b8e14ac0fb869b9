"""Port of the fused residual-add + RMSNorm (seldon_core_tpu_torch/ops/
fused_norm.py) held against the JAX package: the port's plain version
(what a CPU tensor takes) against JAX ``residual_rmsnorm_ref`` and against
the Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances: float32 within 1e-6 (the same op chain; only the mean's
reduction order may differ); bf16 ``y`` bit-equal (one rounding of a
float32 add in both) and ``o`` within one bf16 ulp. The CUDA kernel
itself runs only on a card: tests/test_torch_kernels_cuda.py; its order of
sums is walked on the CPU by ``fused_residual_rmsnorm_emulated``."""

import functools

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



# The kernel's reduction order (csrc/fused_norm.cu), walked on the CPU by
# fused_residual_rmsnorm_emulated, against the same JAX oracles: the served
# shapes, the ragged ones and a row wider than one CTA holds, at the plan's
# pick and at plans that walk a row in several chunks. The tolerances
# above, but for float32 ``o`` at the served widths: there |o| reaches ~12,
# where 1e-6 is one float32 ulp, and a mean of 4,096 squares summed in
# another order moves o by up to ~2 ulps, so float32 ``o`` is held within
# 1e-6 + F32_RTOL * |o|.
F32_RTOL = 4e-7
EMU_SHAPES = [(8, 4096), (128, 4096), (5, 200), (3, 130), (2, 3, 64), (2, 20000)]
EMU_PLANS = [None, (32, 1), (64, 4), (128, 2), (512, 1)]


@functools.lru_cache(maxsize=None)
def _jax_out(shape, dtype, oracle):
    x, h, w = _inputs(shape, 3)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jx, jh, jw = jnp.asarray(x, jdt), jnp.asarray(h, jdt), jnp.asarray(w)
    fn = jax_ref if oracle == "ref" else functools.partial(jax_fused, interpret=True)
    jy, jo = fn(jx, jh, jw, 1e-5)
    return np.asarray(jy, np.float32), np.asarray(jo, np.float32)


def _emulated(shape, dtype, plan, fault=None):
    x, h, w = (torch.from_numpy(a) for a in _inputs(shape, 3))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    y, o = port.fused_residual_rmsnorm_emulated(x.to(tdt), h.to(tdt), w, 1e-5, plan,
                                                fault=fault)
    assert y.dtype == tdt and o.dtype == tdt and y.shape == x.shape and o.shape == x.shape
    return y.float().numpy(), o.float().numpy()


def _within(dtype, got, want):
    if dtype == "bf16":
        return bool(np.all(np.abs(got - want) <= _bf16_ulp(want)))
    return bool(np.all(np.abs(got - want) <= 1e-6 + F32_RTOL * np.abs(want)))


@pytest.mark.parametrize("shape", EMU_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("plan", EMU_PLANS)
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_emulated_kernel_matches_jax(shape, dtype, plan, oracle):
    jy, jo = _jax_out(shape, dtype, oracle)
    y, o = _emulated(shape, dtype, plan)
    if dtype == "bf16":
        np.testing.assert_array_equal(y, jy)
    else:
        np.testing.assert_allclose(y, jy, rtol=0, atol=1e-6)
    assert _within(dtype, o, jo), f"max abs diff {np.abs(o - jo).max()}"


@pytest.mark.parametrize("fault,shape,plan", [
    ("warp", (8, 4096), None), ("warp", (128, 4096), None), ("warp", (2, 20000), None),
    ("last_chunk", (8, 4096), (32, 1)), ("last_chunk", (8, 4096), (128, 2)),
    ("last_chunk", (2, 20000), None)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_seeded_fault_fails_against_jax(fault, shape, plan, dtype):
    """A reduction that normalises each warp by its own sum, or a chunk
    loop that restarts the sum, must fail the tolerance the kernel is held
    to."""
    _, jo = _jax_out(shape, dtype, "interpret")
    _, o = _emulated(shape, dtype, plan, fault=fault)
    assert not _within(dtype, o, jo)


@pytest.mark.parametrize("d", [4096, 5120, 8192, 200, 130, 16384, 20000, 32768])
@pytest.mark.parametrize("vec", [8, 4])   # bf16/f16, float32
@pytest.mark.parametrize("plan", [None, (32, 1), (256, 2), (512, 4)])
def test_launch_plan_fits_the_kernel(d, vec, plan):
    """Every plan the wrapper launches is one the kernel takes: at most
    512 threads a CTA in warps, 1, 2 or 4 slots, chunks that cover the row
    and no more; its own pick holds the row in one chunk where 512 threads
    x 4 slots do."""
    threads, slots, chunks = port._launch_plan(d, vec, plan)
    nvec = -(-d // vec)
    assert threads % 32 == 0 and 32 <= threads <= port.MAX_THREADS and slots in port.SLOTS
    assert (chunks - 1) * threads * slots < nvec <= chunks * threads * slots
    if plan is None:
        assert chunks == max(1, -(-nvec // (port.MAX_THREADS * port.SLOTS[-1])))
    else:
        assert (threads, slots) == plan


def test_launch_plan_at_the_served_shapes():
    """The fit to ``chip_smoke.py --k2-sweep``: 256 threads a row, two
    16-byte slots each, at Llama-2-7B's width in bf16; a row wider than one
    CTA holds (bf16 past 16,384) is walked in chunks of 512 x 4 vectors."""
    assert port._launch_plan(4096, 8) == (256, 2, 1)
    assert port._launch_plan(4096, 4) == (256, 4, 1)
    assert port._launch_plan(16384, 8) == (512, 4, 1)
    assert port._launch_plan(32768, 8) == (512, 4, 2)


@pytest.mark.parametrize("d,plan", [(0, None), (port.MAX_D + 1, None), (64, (48, 1)),
                                    (64, (1024, 1)), (64, (32, 3))])
def test_launch_plan_raises_past_the_kernel(d, plan):
    with pytest.raises(ValueError):
        port._launch_plan(d, 4, plan)
