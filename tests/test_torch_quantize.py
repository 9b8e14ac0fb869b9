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
  ``quantize_``, and the tied int8 head refuses any device but the CPU.
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


@pytest.mark.parametrize("m,n,k", [(8, 4096, 4096), (8, 11008, 4096), (8, 4096, 11008),
                                   (8, 32000, 4096), (256, 11008, 4096), (37, 1000, 40),
                                   (1, 16, 0)])
def test_split_k_covers_k_without_empty_splits(m, n, k):
    splits, per = k4._split_k(m, n, k, 132)
    k_tiles = max(-(-k // k4.BK), 1)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < k_tiles <= splits * per
    tiles = -(-m // k4.BM) * -(-n // k4.BN)
    if tiles >= k4._WAVES * 132:
        assert splits == 1


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
    take: the CPU computes the plain product, any other device raises (the
    meta device stands in for the card here)."""
    m = get_model("llama-tiny", device="meta").quantize_()
    with pytest.raises(NotImplementedError, match="tied"):
        m._logits(torch.zeros((1, 2, 64), device="meta"))
