"""Port of weight-only int8 (seldon_core_tpu_torch/ops/quantize.py,
ops/int8_matmul.py, ``Transformer.quantize_`` and the int8 crossing of
models/convert.py) held against the JAX package on the CPU:

- ``quantize_array`` codes and scales bit-equal to JAX's, zero channels and
  ties at .5 included (both round half to even), float32 and bf16 leaves;
- the int8 GEMM's plain version (what a CPU tensor takes) against JAX
  ``int8_matmul`` — the Pallas kernel in interpret mode and its XLA
  expression — within 1e-5, ragged shapes included;
- a quantized llama-tiny-width model loaded from the JAX quantized tree
  gives the JAX model's logits (float32, within 1e-4) cache-less and through
  int8 KV caches;
- inside the port: the streamed (layout-first) init equals init then
  ``quantize_``, and the tied int8 head refuses a card without its
  transposed copy (``prepare_head_``).
The CUDA kernel itself runs only on a card: tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models import transformer as jt
from seldon_core_tpu.ops import pallas_int8 as jint8
from seldon_core_tpu.ops import quantize as jq
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.models import transformer as tt
from seldon_core_tpu_torch.models.convert import has_quantized_leaves, params_from_jax
from seldon_core_tpu_torch.ops import int8_matmul as k4
from seldon_core_tpu_torch.ops import quantize as tq

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def _weight(seed, shape=(24, 6)):
    """Random columns plus the edge cases: column 0 has scale exactly 1
    (max |w| = 127) and ties at +-.5, +-1.5, +-2.5; column 1 is all zeros
    (scale 1, codes 0); column 2 has scale 0.5 and ties at 0.25 / 0.75."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0
    w[:8, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    w[:, 1] = 0.0
    w[:, 2] = 0.0
    w[:4, 2] = [63.5, 0.25, 0.75, -0.25]
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(24, 6), (3, 8, 6)])
def test_quantize_array_bit_equal_to_jax(dtype, shape):
    w = _weight(0, (int(np.prod(shape[:-1])), shape[-1])).reshape(shape)
    want = jq.quantize_array(jnp.asarray(w, dtype=dtype))
    got = tq.quantize_array(torch.from_numpy(w).to(tt.to_torch_dtype(dtype)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.orig_dtype == tt.to_torch_dtype(want.orig_dtype)
    np.testing.assert_array_equal(tq.dequantize_array(got, torch.float32).numpy(),
                                  np.asarray(jq.dequantize_array(want, jnp.float32)))
    if len(shape) == 2:  # column 0: ties round half to even
        assert got.q[1:7, 0].tolist() == [0, 2, 2, 0, -2, -2]


@pytest.mark.parametrize("orig", [torch.float32, torch.bfloat16])
def test_quantize_into_equals_quantize_array(orig):
    w = torch.from_numpy(_weight(1))
    want = tq.quantize_array(w.to(orig))
    got = tq.QuantizedTensor(torch.empty_like(want.q), torch.empty_like(want.scale), orig)
    tq.quantize_into_(got, w.clone())
    assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (5, 40, 33), (8, 256, 200)])
@pytest.mark.parametrize("oracle", ["interpret", "xla"])
def test_int8_matmul_plain_matches_jax(m, k, n, oracle):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = (rng.random(n).astype(np.float32) + 0.5) / 127
    if oracle == "interpret":
        want = jint8.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                 interpret=True)
    else:
        want = (jnp.asarray(x) @ (jnp.asarray(q).astype(jnp.float32) * jnp.asarray(scale)))
    before = k4.int8_matmul.launches
    got = k4.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale))
    assert k4.int8_matmul.launches == before  # the plain version launches nothing
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_int8_dense_and_quantized_matmul_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 24)).astype(np.float32)
    w = _weight(2, (24, 6))
    jqt = jq.quantize_array(jnp.asarray(w))
    tqt = tq.quantize_array(torch.from_numpy(w))
    want = jint8.int8_dense(jnp.asarray(x), jqt)
    got = k4.int8_dense(torch.from_numpy(x), tqt)
    assert got.shape == (2, 3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = jq.quantized_matmul(jnp.asarray(x), jqt)
    got = tq.quantized_matmul(torch.from_numpy(x), tqt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    vec = k4.int8_dense(torch.from_numpy(x[0, 0]), tqt)  # 1-D input: [N] out, as JAX
    assert vec.shape == (6,)


def test_int8_matmul_rejects_bad_shapes():
    x, q, s = torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int8), torch.ones(4)
    for args in ((x, q[:7], s), (x, q, s[:3]), (x[0], q, s)):
        with pytest.raises(ValueError):
            k4.int8_matmul(*args)


# (K, N) of the int8 7B model's products: wq/wk/wv/wo, w1/w3, w2, lm_head
_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# The decode kernel's plan (strip width, splits, stages per split) at the
# four M = 8 decode shapes: the fastest of each shape's turn in
# chip_smoke.py --k4-decode-sweep on an NVIDIA H100 80GB HBM3 at 700 W.
_DECODE_SWEPT = {(4096, 4096): (128, 3, 11), (4096, 11008): (256, 2, 32),
                 (11008, 4096): (256, 6, 29), (4096, 32000): (256, 1, 64)}


@pytest.mark.parametrize("m,n,k", [(8, 4096, 4096), (8, 11008, 4096), (8, 4096, 11008),
                                   (8, 32000, 4096), (256, 11008, 4096), (37, 1000, 40),
                                   (1, 16, 0), (1, 4096, 4096), (16, 4096, 11008),
                                   (17, 11008, 4096), (63, 32000, 4096)])
def test_decode_plan_covers_every_strip_and_step(m, n, k):
    """The decode kernel's grid (splits, row tiles, strips) in clusters of
    (splits, 1, 1), walked as csrc/int8_matmul.cu walks it: every row, every
    column strip and every stage of K exactly once, no empty split, the
    cluster at most 8 CTAs and a divisor of the grid, the merge's shares
    covering the tile once; at the four M = 8 decode shapes, the plan the
    sweep found fastest."""
    bn, splits, per = k4._decode_plan(m, n, k, 132)
    assert bn in k4.DEC_WIDTHS and 1 <= splits <= k4.DEC_MAX_SPLITS and per >= 1
    grid = (splits, -(-m // k4._decode_rows(m)), -(-n // bn))
    assert grid[0] % splits == 0
    bk = k4.DEC_STAGE_BYTES // bn
    k_steps = -(-k // bk)
    covered = []
    for z in range(splits):   # kt0, n_steps
        n_steps = max(0, min(per, k_steps - z * per))
        assert n_steps > 0 or k == 0
        covered += range(z * per, z * per + n_steps)
    assert covered == list(range(k_steps))
    rows = [r for y in range(grid[1]) for r in range(y * k4._decode_rows(m),
                                                     (y + 1) * k4._decode_rows(m))]
    cols = [c for z in range(grid[2]) for c in range(z * bn, (z + 1) * bn)]
    assert rows[:m] == list(range(m)) and cols[:n] == list(range(n))
    quads = k4._decode_rows(m) * bn // 4   # the merge: rank r sums quads [lo, hi)
    shares = [i for r in range(splits) for i in range(r * quads // splits,
                                                      (r + 1) * quads // splits)]
    assert shares == list(range(quads))
    if m == 8 and (k, n) in _7B:
        assert (bn, splits, per) == _DECODE_SWEPT[(k, n)]


def test_frag_columns_is_a_permutation_of_the_slab():
    cols = k4._frag_columns()
    assert sorted(cols.tolist()) == list(range(k4.DEC_SLAB))
    # fragment 0 at rows g and g + 8: bytes 0 and 1 of lane group g's load
    assert cols[:16].tolist() == [16 * (r % 8) + r // 8 for r in range(16)]


# (m, k, n, plan): ragged M (one and two 16-row tiles), ragged N within a
# strip and across strips, K off the stage, one split and several
_EMULATED = [(1, 300, 200, (128, 3, 1)), (5, 1000, 300, (256, 4, 4)),
             (16, 520, 136, (128, 5, 1)), (17, 700, 264, (256, 3, 4)),
             (8, 1024, 384, (128, 1, 8)), (33, 200, 40, (256, 2, 2))]


def _emulated_case(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = ((rng.random(n) + 0.5) / 127).astype(np.float32)
    want = jint8.int8_matmul(jnp.asarray(x.float().numpy()), jnp.asarray(q), jnp.asarray(scale),
                             interpret=True)
    reach = x.float().abs() @ (torch.from_numpy(q).float() * torch.from_numpy(scale)).abs()
    return x, torch.from_numpy(q), torch.from_numpy(scale), torch.from_numpy(np.array(want)), reach


@pytest.mark.parametrize("m,k,n,plan", _EMULATED)
def test_decode_kernel_walk_matches_jax(m, k, n, plan):
    """The decode kernel's walk (strips, splits, the fragment's column
    interleave, the rank-order merge) on bf16 x, int8 q and float32 scales
    from a seed, against the JAX package's Pallas kernel in interpret mode:
    within 1e-5 * (|x| @ |q * scale|) elementwise (float32 summation order),
    as the card's kernel is held to its plain version."""
    x, q, scale, want, reach = _emulated_case(m, k, n)
    got = k4.int8_matmul_emulated(x, q, scale, plan)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert torch.all((got - want).abs() <= 1e-5 * reach)


@pytest.mark.parametrize("m,k,n,plan", _EMULATED[:2])
def test_decode_kernel_walk_catches_an_undone_interleave(m, k, n, plan):
    """Seeded fault: the epilogue leaves the columns in register order. The
    tolerance above must catch it (random inputs: the permutation shows)."""
    x, q, scale, want, reach = _emulated_case(m, k, n)
    got = k4.int8_matmul_emulated(x, q, scale, plan, interleave=False)
    assert not torch.all((got - want).abs() <= 1e-5 * reach)


@pytest.mark.parametrize("m,k,n,x_off,q_off,wgmma", [
    *[(8, k, n, 0, 0, False) for k, n in _7B],        # every decode shape: 8 serving slots
    *[(m, k, n, 0, 0, True) for m in (64, 128, 256) for k, n in _7B],
    (63, 4096, 4096, 0, 0, False),     # under one wgmma's 64 rows
    (200, 4104, 1040, 0, 0, True),     # M, N and K off the tile, still TMA-addressable
    (300, 4096, 1000, 0, 0, False),    # N % 16 != 0
    (128, 4100, 4096, 0, 0, False),    # K % 8 != 0
    (128, 4096, 4096, 8, 0, False),    # x not 16-byte aligned
    (128, 4096, 4096, 0, 4, False),    # q not 16-byte aligned
    (128, 0, 16, 0, 0, False),         # K = 0
])
def test_int8_matmul_route(m, k, n, x_off, q_off, wgmma):
    """The prefill kernel takes M >= 64 where TMA can address x and q;
    everything else, every decode step included, takes the decode kernel."""
    assert k4._uses_wgmma(m, n, k, (1 << 20) + x_off, (1 << 21) + q_off) is wgmma


@pytest.mark.parametrize("m,k,n", [*[(m, k, n) for m in (128, 256) for k, n in _7B],
                                   (64, 4096, 4096), (200, 4104, 1040), (1248, 4096, 32000),
                                   (64, 8, 16)])
def test_wgmma_plan_covers_every_tile_and_step(m, k, n):
    """The prefill kernel's grid, walked as the kernel walks it: every
    output tile and every 64-deep step of K exactly once, no empty split;
    the plan is the least of the modelled times, and at the four M = 128
    shapes it keeps at least 90 % of 132 SMs busy."""
    sms = 132
    bn, splits, per = k4._wgmma_plan(m, n, k, sms)
    assert bn in k4.WG_BNS and 1 <= splits <= k4._MAX_SPLITS
    steps = -(-k // k4.WG_BK)
    covered = []
    for z in range(splits):   # csrc/int8_matmul_wgmma.cu: kt0, n_steps
        kt0 = z * per
        n_steps = max(0, min(per, steps - kt0))
        assert n_steps > 0
        covered += range(kt0, kt0 + n_steps)
    assert covered == list(range(steps))
    rows = {r for bx in range(-(-m // k4.WG_BM)) for r in range(bx * k4.WG_BM, (bx + 1) * k4.WG_BM)}
    cols = {c for by in range(-(-n // bn)) for c in range(by * bn, (by + 1) * bn)}
    assert set(range(m)) <= rows and set(range(n)) <= cols

    def modelled_us(bn, s):
        tiles = -(-m // k4.WG_BM) * -(-n // bn)
        p = -(-steps // s)
        return (-(-tiles * s // sms) * p * k4._STEP_US[bn]
                + (s > 1) * s * m * n * 8 / k4._PARTIAL_BYTES_PER_US)

    assert modelled_us(bn, splits) == min(modelled_us(b, s) for b in k4.WG_BNS
                                          for s in range(1, min(steps, k4._MAX_SPLITS) + 1))
    if m == 128 and (k, n) in _7B:
        assert -(-m // k4.WG_BM) * -(-n // bn) * splits >= 0.9 * sms


@pytest.mark.parametrize("rows", [128, 256])
def test_int8_dense_prefill_chunk_matches_jax(rows):
    """A prefill chunk [1, rows, 4096] through int8_dense, the shape the
    prefill kernel takes on a card, against the JAX package's int8_dense
    (both on the CPU: the plain expression)."""
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((1, rows, 4096)).astype(np.float32)
    w = (rng.standard_normal((4096, 1024)) / 64).astype(np.float32)
    want = jint8.int8_dense(jnp.asarray(x), jq.quantize_array(jnp.asarray(w)))
    got = k4.int8_dense(torch.from_numpy(x), tq.quantize_array(torch.from_numpy(w)))
    assert got.shape == (1, rows, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jmod = jax_get_model("transformer", **KW)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    jparams_q = jq.quantize_params(variables["params"])
    deq = {"params": jq.dequantize_params(jparams_q)}
    tree = jax.tree_util.tree_map(np.asarray, jparams_q)
    tmod = get_model("transformer", device="meta", **KW).quantize_().to_empty(device="cpu")
    params_from_jax({"params": tree}, tmod)
    return jmod, deq, tmod, tree, jax.tree_util.tree_map(np.asarray, variables["params"])


def _prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (b, s)).astype(np.int32)


def test_params_from_jax_quantized_tree(models):
    _, _, tmod, tree, float_tree = models
    assert has_quantized_leaves({"params": tree}) and not has_quantized_leaves(float_tree)
    sd = tmod.state_dict()
    np.testing.assert_array_equal(sd["layer_1.ffn.w2.q"].numpy(), tree["layer_1"]["ffn"]["w2"].q)
    np.testing.assert_array_equal(sd["lm_head.scale"].numpy(), tree["lm_head"].scale)
    assert sd["layer_0.attention_norm.weight"].dtype == torch.float32
    assert tmod.lm_head.orig_dtype == torch.float32
    fresh_q = get_model("transformer", device="cpu", **KW).quantize_()
    with pytest.raises(TypeError):  # a float leaf where the port is quantized
        params_from_jax(float_tree, fresh_q)
    with pytest.raises(TypeError):  # an int8 leaf where the port is float
        params_from_jax(tree, get_model("transformer", device="cpu", **KW))
    bad = dict(tree, lm_head=jq.QuantizedTensor(np.zeros((64, 3), np.int8),
                                                np.ones(3, np.float32), "float32"))
    with pytest.raises(ValueError):
        params_from_jax(bad, fresh_q)


def test_quantize_after_float_load_equals_jax_quantized_tree(models):
    _, _, tmod, _, float_tree = models
    late = params_from_jax(float_tree, get_model("transformer", device="cpu", **KW)).quantize_()
    for (n1, a), (n2, b) in zip(sorted(late.state_dict().items()),
                                sorted(tmod.state_dict().items())):
        assert n1 == n2 and torch.equal(a, b), n1


def test_quantized_logits_match_jax(models):
    jmod, deq, tmod, _, _ = models
    toks = _prompt(2, 12)
    want, _ = jmod.apply(deq, jnp.asarray(toks))
    got, _ = tmod(torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_quantized_int8_kv_paged_decode_matches_jax(models):
    """Both knobs: int8 weights and an int8 paged pool, a prefill chunk then
    a decode step, against the JAX paged path on the dequantized tree."""
    jmod, deq, tmod, _, _ = models
    bt = np.array([[7, 2, 10, 0], [4, 11, 3, 0]], np.int32)
    toks = _prompt(2, 8, 1)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    jp = jt.init_paged_kv_caches(jmod.cfg, 12, 8, "int8")
    tp = tt.init_paged_kv_caches(tmod.cfg, 12, 8, "int8", device="cpu")
    want, jp = jmod.apply(deq, jnp.asarray(toks), positions=jnp.asarray(pos), caches=jp,
                          block_tables=jnp.asarray(bt))
    got, tp = tmod(torch.from_numpy(toks), positions=torch.from_numpy(pos), caches=tp,
                   block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    nxt, p = np.array([[5], [6]], np.int32), np.array([[8], [8]], np.int32)
    want, _ = jmod.apply(deq, jnp.asarray(nxt), positions=jnp.asarray(p), caches=jp,
                         block_tables=jnp.asarray(bt))
    got, _ = tmod(torch.from_numpy(nxt), positions=torch.from_numpy(p), caches=tp,
                  block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_quantize_module_layout():
    m = get_model("llama-tiny", device="cpu", dtype="bfloat16", param_dtype="auto")
    m.init_params(torch.Generator().manual_seed(0))
    m.quantize_()
    assert [n for n, _ in m.named_parameters()] == [
        "layer_0.attention_norm.weight", "layer_0.ffn_norm.weight",
        "layer_1.attention_norm.weight", "layer_1.ffn_norm.weight", "norm.weight"]
    qts = {n: t for n, t in m.named_modules() if isinstance(t, tq.QuantizedTensor)}
    assert len(qts) == 1 + 2 * 7 and "tok_embeddings" in qts
    assert all(t.orig_dtype == torch.bfloat16 and t.q.dtype == torch.int8
               for t in qts.values())
    logits, _ = m(torch.zeros((1, 4), dtype=torch.int64))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


@pytest.mark.parametrize("param_dtype", [None, "auto"])
def test_streamed_init_equals_init_then_quantize(param_dtype):
    kw = dict(KW, dtype="bfloat16")
    whole = get_model("transformer", device="cpu", param_dtype=param_dtype, **kw)
    whole.init_params(torch.Generator().manual_seed(5))
    whole.quantize_()
    streamed = get_model("transformer", device="meta", param_dtype=param_dtype, **kw)
    streamed.quantize_().to_empty(device="cpu")
    streamed.init_params(torch.Generator().manual_seed(5))
    a, b = whole.state_dict(), streamed.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_tied_int8_head_refuses_a_card():
    """The tied head's int8 scale sits on K, which the GEMM kernel does not
    take: the CPU computes the plain product; any other device reads the
    transposed int8 copy ``prepare_head_`` makes and refuses without it (the
    meta device stands in for the card here). The copy is the codes
    transposed, with a scale of ones, and stays out of the state dict."""
    m = get_model("llama-tiny", device="meta").quantize_()
    with pytest.raises(RuntimeError, match="tied int8 head.*prepare_head_"):
        m._logits(torch.zeros((1, 2, 64), device="meta"))
    cpu = get_model("llama-tiny", device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    cpu.quantize_()
    keys = list(cpu.state_dict())
    qt, ones = cpu.prepare_head_()._head_t
    emb = cpu.tok_embeddings
    assert torch.equal(qt, emb.q.t()) and qt.is_contiguous() and torch.equal(ones, torch.ones(256))
    assert list(cpu.state_dict()) == keys
    x = torch.randn((1, 2, 64), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(cpu._logits(x), x @ (emb.q.float() * emb.scale).t(), rtol=0,
                               atol=1e-5)


# ------------------------------------------- predict models (MLP, ViT)
def test_quantize_params_over_a_module_equals_jax_tree():
    """``quantize_params`` over a vit-tiny's leaves: the codes and scales
    of JAX's ``quantize_params`` over the same tree, the 3-D ``cls`` /
    ``pos_embed`` and the 4-D patch kernel included, the 1-D leaves left
    float; ``dequantize_params`` JAX's dequantized tree; ``quantized_bytes``
    JAX's count from metadata."""
    jm = jax_get_model("vit-tiny", num_classes=4)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32),
                          variables["params"])
    port = get_model("vit-tiny", num_classes=4, input_shape=[16, 16, 3], device="cpu")
    params_from_jax({"params": params}, port)
    want = jq.quantize_params(params)
    tq.quantize_params(port)
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda v: isinstance(v, jq.QuantizedTensor))[0]}
    leaves = port.leaves()
    assert set(flat) == set(leaves)
    for name, leaf in flat.items():
        got = leaves[name]
        if isinstance(leaf, jq.QuantizedTensor):
            assert isinstance(got, tq.QuantizedTensor), name
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(leaf.q))
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(leaf.scale))
        else:
            assert not isinstance(got, tq.QuantizedTensor) and got.dim() == 1, name
    deq = tq.dequantize_params(port)
    jdeq = jq.dequantize_params(want)
    np.testing.assert_array_equal(deq["pos_embed"].numpy(), np.asarray(jdeq["pos_embed"]))
    np.testing.assert_array_equal(deq["patch_embed.kernel"].numpy(),
                                  np.asarray(jdeq["patch_embed"]["kernel"]))
    assert tq.quantized_bytes(port) == jq.quantized_bytes(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_equals_autograd_through_plain(dtype):
    """K4's Function on a CPU tensor (forward: the plain version; backward:
    ``int8_matmul_backward``) against autograd through ``int8_matmul_ref``
    on one saved input, at the MLP's ragged shapes; the codes and scales
    take no gradient, and a scale asking for one raises."""
    g = torch.Generator().manual_seed(1)
    for k, n in ((4, 128), (128, 3)):
        qt = tq.quantize_array(torch.randn(k, n, generator=g))
        x = torch.randn(3, 5, k, generator=g).to(dtype)
        dy = torch.randn(3, 5, n, generator=g).to(dtype)
        xa = x.clone().requires_grad_()
        y = k4.int8_dense(xa, qt, dtype)
        assert y.grad_fn is not None
        (got,) = torch.autograd.grad(y, xa, dy)
        xb = x.clone().requires_grad_()
        ref = k4.int8_matmul_ref(xb.reshape(-1, k), qt.q, qt.scale, dtype).reshape(3, 5, n)
        (want,) = torch.autograd.grad(ref, xb, dy)
        tol = 1e-6 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * want.abs().max().item())
        torch.testing.assert_close(y, ref, rtol=0, atol=0)
    with torch.no_grad():
        assert k4.int8_dense(xa, qt, dtype).grad_fn is None
    qt.scale.requires_grad_()
    with pytest.raises(ValueError, match="not trained"):
        k4.int8_dense(xa, qt, dtype)


def test_linear_routes_by_the_activation_dtype(monkeypatch):
    """bf16 activations take K4 (``int8_dense``); float32 ones the
    dequantized weight and ``torch.matmul``, JAX's expression."""
    qt = tq.quantize_array(torch.randn(8, 6, generator=torch.Generator().manual_seed(2)))
    calls = []
    real = tq.int8_dense
    monkeypatch.setattr(tq, "int8_dense", lambda *a: calls.append(1) or real(*a))
    x = torch.randn(2, 8)
    torch.testing.assert_close(tq.linear(x, qt), x @ tq.dequantize_array(qt), rtol=0, atol=0)
    assert not calls
    tq.linear(x.to(torch.bfloat16), qt)
    head = tq.float32_head(x.to(torch.bfloat16), qt)
    assert len(calls) == 2 and head.dtype == torch.float32
