"""Port of the folded-BN identity bottleneck chain (seldon_core_tpu_torch/ops/
fused_resnet.py, K3) held against the JAX package: the port's plain version
(what a CPU tensor takes) against JAX ``identity_chain_ref`` and the Pallas
kernel in interpret mode, on the same seeded inputs.

Tolerance: within n_blocks bf16 ulps of max|reference| elementwise. Both
sides sum the same bf16 products in float32, in different orders, so a bf16
hand-off may round to the neighbouring value once per block. The bound is
tight enough to catch the two faults a port of this kernel is prone to,
which the tests show: a 3x3 halo filled with relu(b1) (the 1x1 conv run
over a zero-padded x instead of padding y1), two taps of w2 read in each
other's place, and the kernel's wrap mask dropped. The kernel's tiling,
flat tap shifts and masks are held here through ``gemm_chain_emulated``,
its CPU emulation, and its plan as a pure function. The CUDA kernel itself
runs only on a card:
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seldon_core_tpu.ops.fused_resnet import _block_param_list as jax_param_list
from seldon_core_tpu.ops.fused_resnet import folded_block_params as jax_folded_block_params
from seldon_core_tpu.ops.fused_resnet import fused_identity_chain as jax_kernel
from seldon_core_tpu.ops.fused_resnet import identity_chain_ref as jax_ref
from seldon_core_tpu_torch.ops import fused_resnet as port


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (through torch), as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def make_case(seed, b, h, w, c, f, n_blocks, live=False):
    """x and blocks as numpy: bf16-valued x and weights, float32 biases.
    ``live``: weights at 1/sqrt(fan_in) and b1 in [0.5, 1] (the halo's
    relu(b1) far from zero); else the JAX test's 0.05-scaled draw."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, h, w, c)))
    blocks = []
    for _ in range(n_blocks):
        if live:
            blk = dict(w1=_bf16(rng.standard_normal((c, f)) * c ** -0.5),
                       b1=rng.uniform(0.5, 1.0, f).astype(np.float32),
                       w2=_bf16(rng.standard_normal((3, 3, f, f)) * (9 * f) ** -0.5),
                       b2=(rng.standard_normal(f) * 0.1).astype(np.float32),
                       w3=_bf16(rng.standard_normal((f, c)) * f ** -0.5),
                       b3=(rng.standard_normal(c) * 0.1).astype(np.float32))
        else:
            blk = dict(w1=_bf16(rng.standard_normal((c, f)) * 0.05),
                       b1=(rng.standard_normal(f) * 0.05).astype(np.float32),
                       w2=_bf16(rng.standard_normal((3, 3, f, f)) * 0.05),
                       b2=(rng.standard_normal(f) * 0.05).astype(np.float32),
                       w3=_bf16(rng.standard_normal((f, c)) * 0.05),
                       b3=(rng.standard_normal(c) * 0.05).astype(np.float32))
        assert np.abs(blk["w3"]).max() > 0  # a live residual branch
        blocks.append(blk)
    return x, blocks


def to_jax(x, blocks):
    jb = [{k: jnp.asarray(v, jnp.bfloat16 if k[0] == "w" else jnp.float32)
           for k, v in blk.items()} for blk in blocks]
    return jnp.asarray(x, jnp.bfloat16), jb


def to_port(x, blocks):
    pb = [{k: torch.from_numpy(v).to(torch.bfloat16 if k[0] == "w" else torch.float32)
           for k, v in blk.items()} for blk in blocks]
    return torch.from_numpy(x).to(torch.bfloat16), pb


def within(out, ref, n_blocks) -> bool:
    """n_blocks bf16 ulps of max|ref|, elementwise."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return bool(np.all(np.abs(out - ref) <= n_blocks * ulp))


@pytest.mark.parametrize("b,h,w,c,f,group,n_blocks", [
    (2, 8, 8, 32, 16, 1, 2),   # the JAX test's shapes: a chain of two
    (4, 6, 6, 16, 8, 2, 1),    # grouped images
    (4, 6, 6, 16, 8, 4, 3),    # the whole batch in one program, 3 blocks
])
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_plain_matches_jax(b, h, w, c, f, group, n_blocks, oracle):
    x, blocks = make_case(0, b, h, w, c, f, n_blocks)
    jx, jb = to_jax(x, blocks)
    if oracle == "ref":
        want = jax_ref(jx, jb)
    else:
        want = jax_kernel(jx, jb, group=group, interpret=True)
    px, pb = to_port(x, blocks)
    before = port.fused_identity_chain.launches
    got = port.fused_identity_chain(px, pb, group=group)
    assert port.fused_identity_chain.launches == before  # a CPU tensor launches nothing
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, c)
    assert within(got.float().numpy(), np.asarray(want, np.float32), n_blocks)


def test_rejects_bad_shapes():
    x, blocks = make_case(0, 3, 4, 4, 8, 4, 1)
    px, pb = to_port(x, blocks)
    with pytest.raises(ValueError, match="not divisible"):
        port.fused_identity_chain(px, pb, group=2)
    with pytest.raises(ValueError, match="3x3"):
        port.fused_identity_chain(px, [dict(pb[0], w2=pb[0]["w2"][:2])], group=1)


def test_param_list_and_scope_mapping_match_jax():
    """w2 flattened tap-major, row (3*kh + kw)*F + ci, as the JAX kernel's
    operand; a folded flax scope maps to the same block dict."""
    x, blocks = make_case(1, 1, 4, 4, 16, 8, 2)
    _, jb = to_jax(x, blocks)
    _, pb = to_port(x, blocks)
    jl = jax_param_list(jb)
    pl = port._block_param_list(pb)
    assert len(jl) == len(pl) == 12
    for j, p in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(j, np.float32).reshape(p.shape),
                                      p.float().numpy())
    rng = np.random.default_rng(2)
    scope = {"Conv_0": {"kernel": rng.standard_normal((1, 1, 16, 8)), "bias": rng.random(8)},
             "Conv_1": {"kernel": rng.standard_normal((3, 3, 8, 8)), "bias": rng.random(8)},
             "Conv_2": {"kernel": rng.standard_normal((1, 1, 8, 16)), "bias": rng.random(16)}}
    want = jax_folded_block_params(scope)
    got = port.folded_block_params(scope)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(got[k]))


def _halo_relu_b1(x, blk):
    """The fault: the 1x1 reduce run over a zero-padded x, so the 3x3
    conv's halo holds relu(b1) instead of zero."""
    h, w = x.shape[1:3]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    y1 = torch.relu(xp @ blk["w1"].float() + blk["b1"]).to(torch.bfloat16).float()
    taps = [y1[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    f = blk["w1"].shape[1]
    y2 = torch.relu(torch.cat(taps, -1) @ blk["w2"].float().reshape(9 * f, f) + blk["b2"])
    y = (y2.to(torch.bfloat16).float() @ blk["w3"].float() + blk["b3"]).to(torch.bfloat16)
    return torch.relu(x + y)


def test_border_with_positive_b1_pads_y1_with_zeros():
    """b1 > 0: the port's plain version zero-pads y1 as JAX does, and the
    halo fault lands outside the tolerance — on the border pixels only."""
    x, blocks = make_case(3, 2, 6, 7, 32, 16, 1, live=True)
    jx, jb = to_jax(x, blocks)
    want = np.asarray(jax_ref(jx, jb), np.float32)
    px, pb = to_port(x, blocks)
    assert within(port.fused_identity_chain(px, pb).float().numpy(), want, 1)
    faulty = _halo_relu_b1(px, pb[0]).float().numpy()
    assert not within(faulty, want, 1)
    # the interior (no tap reaches the halo) agrees
    assert within(faulty[:, 1:-1, 1:-1], want[:, 1:-1, 1:-1], 1)


@pytest.mark.parametrize("fault", ["halo_relu_b1", "swapped_taps"])
def test_tolerance_catches_seeded_faults(fault):
    x, blocks = make_case(4, 2, 8, 8, 32, 16, 2, live=True)
    jx, jb = to_jax(x, blocks)
    want = np.asarray(jax_ref(jx, jb), np.float32)
    px, pb = to_port(x, blocks)
    assert within(port.fused_identity_chain(px, pb).float().numpy(), want, 2)
    if fault == "halo_relu_b1":
        out = px
        for blk in pb:
            out = _halo_relu_b1(out, blk)
    else:
        taps = pb[0]["w2"].reshape(9, 16, 16)
        order = [0, 1, 2, 3, 4, 6, 5, 7, 8]  # taps (1, 2) and (2, 0) swapped
        swapped = [dict(pb[0], w2=taps[order].reshape(3, 3, 16, 16))] + pb[1:]
        out = port.fused_identity_chain(px, swapped)
    assert not within(out.float().numpy(), want, 2)


@pytest.mark.parametrize("b,h,w,c,f", [
    (3, 7, 7, 16, 8),     # 147 pixels: the second tile ragged, tiles cross image seams
    (2, 5, 9, 32, 16),    # rows shorter than a tile: taps wrap and cross seams in every tile
    (2, 10, 40, 16, 8),   # 800 pixels, 7 tiles, the last one ragged
    (1, 5, 9, 16, 16),    # one image: shifts past both ends of the batch read TMA's zeros
])
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_gemm_emulation_matches_jax(b, h, w, c, f, oracle):
    """The kernel's arithmetic (128-row tiles over the flattened batch,
    each tap a flat shift of y1 with zeros past the ends, the seam and wrap
    masks, the three epilogues) against JAX's plain chain and its Pallas
    kernel with every image of the batch stacked in one program (its own
    seam masks), within n_blocks ulps."""
    x, blocks = make_case(5, b, h, w, c, f, 2, live=True)
    jx, jb = to_jax(x, blocks)
    want = jax_ref(jx, jb) if oracle == "ref" else jax_kernel(jx, jb, group=b, interpret=True)
    px, pb = to_port(x, blocks)
    got = port.gemm_chain_emulated(px, pb)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, c)
    assert within(got.float().numpy(), np.asarray(want, np.float32), 2)


@pytest.mark.parametrize("b,h,w", [(3, 7, 7), (2, 10, 40)])
def test_gemm_emulation_without_wrap_mask_fails_the_tolerance(b, h, w):
    """The seeded fault: without the column mask, taps at a row's ends read
    the neighbouring row's pixels — outside the tolerance, and only on the
    first and last columns."""
    x, blocks = make_case(6, b, h, w, 16, 8, 2, live=True)
    jx, jb = to_jax(x, blocks)
    want = np.asarray(jax_ref(jx, jb), np.float32)
    px, pb = to_port(x, blocks)
    assert within(port.gemm_chain_emulated(px, pb).float().numpy(), want, 2)
    faulty = port.gemm_chain_emulated(px, pb, col_mask=False).float().numpy()
    assert not within(faulty, want, 2)
    # one block: the fault reaches only the pixels whose taps wrap
    want1 = np.asarray(jax_ref(jx, jb[:1]), np.float32)
    faulty1 = port.gemm_chain_emulated(px, pb[:1], col_mask=False).float().numpy()
    assert within(faulty1[:, :, 1:-1], want1[:, :, 1:-1], 1)
    assert not within(faulty1, want1, 1)


def test_tap_keep_marks_seams_and_wraps():
    """Tap bits of the stacked batch: the centre tap always; (-1, 0) not on
    an image's first row (the previous image's last row sits there in the
    flat order); (0, +1) not on a row's last column."""
    keep = port._tap_keep(2, 3, 4)
    assert keep.shape == (24, 9) and keep[:, 4].all()
    p = torch.arange(24)
    assert torch.equal(keep[:, 1], (p // 4) % 3 != 0)
    assert torch.equal(keep[:, 5], p % 4 != 3)
    assert torch.equal(port._tap_keep(2, 3, 4, col_mask=False)[:, 5], torch.ones(24, dtype=bool))


@pytest.mark.parametrize("b", [1, 2, 8, 32, 128, 1024])
@pytest.mark.parametrize("hw,c,f", [(56, 256, 64), (28, 512, 128), (14, 1024, 256),
                                    (7, 2048, 512), (5, 64, 128)])
@pytest.mark.parametrize("sms", [132, 114])
def test_k3_plan_and_expected_launches(b, hw, c, f, sms):
    """The plan as a pure function: per conv a tile width that divides N,
    splits that cover K with none empty; expected_launches counts three
    launches a block plus a reduce per split conv."""
    convs = port._k3_plan(b, hw, hw, c, f, sms)
    assert len(convs) == 3
    dims = port._conv_dims(c, f)
    assert dims == ((c, f, c // 64), (f, f, 9 * f // 64), (f, c, f // 64))
    reduces = 0
    for (bn, splits, per), (_, n, steps) in zip(convs, dims):
        assert bn in port.GEMM_BNS and n % bn == 0
        assert 1 <= splits <= steps and splits * per >= steps and (splits - 1) * per < steps
        reduces += splits > 1
    assert port.expected_launches(b, hw, hw, c, f, 3, sms) == 3 * (3 + reduces)
    assert port._k3_plan(b, hw, hw, c, f, sms) == convs   # pure: the same answer


def test_k3_plan_follows_the_sweep():
    """Where the sweep's timings were clear, the plan picks as they did
    (chip_smoke.py --k3-sweep, NVIDIA H100 80GB HBM3): one split at B = 128;
    the widest tile for the 3x3 at 7x7; K split at 7x7 and 14x14 for B = 8,
    whose 1x1 reduce at 7x7 has 4 row tiles."""
    for hw, c, f in [(56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512)]:
        assert all(splits == 1 for _, splits, _ in port._k3_plan(128, hw, hw, c, f))
    assert port._k3_plan(128, 7, 7, 2048, 512)[1][0] == 256
    assert port._k3_plan(8, 7, 7, 2048, 512)[0][1] > 1
    assert port._k3_plan(8, 14, 14, 1024, 256)[1][1] > 1
