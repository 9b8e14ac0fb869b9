"""Port of the int8 KV cache (``kv_cache_dtype="int8"``: quantize_kv /
dequantize_kv, the 5-tuple dense and paged caches, and the int8 branch of
ops/paged_attention.py) held against the JAX package on the CPU:

- ``quantize_kv`` codes and scales bit-equal to JAX's, zero vectors and
  ties at .5 included; the 5-tuple caches match JAX's in shapes, dtypes and
  initial values;
- the paged-attention plain version on 5-tuple pools against JAX
  ``paged_attention_ref`` and the Pallas kernel in interpret mode, within
  1e-5 (float32, the same cases as the bf16 pool's tests);
- int8 dense prefill + decode and int8 paged chunks + decode give the JAX
  model's logits within 1e-4 (float32);
- inside the port, paged int8 == dense int8 bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models import transformer as jt
from seldon_core_tpu.ops.paged_attention import paged_attention as jax_kernel
from seldon_core_tpu.ops.paged_attention import paged_attention_ref as jax_ref
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.models import transformer as tt
from seldon_core_tpu_torch.models.convert import params_from_jax
from seldon_core_tpu_torch.ops import paged_attention as port
from test_torch_paged_attention import B, H, HD, make_case

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
PS = 8


def _kv(seed):
    """[2, 5, 3, 8] vectors: random, one all-zero vector (scale 1, codes 0),
    and one with max |x| = 127 (scale exactly 1) holding ties at +-.5,
    +-1.5, +-2.5."""
    x = np.random.default_rng(seed).standard_normal((2, 5, 3, 8)).astype(np.float32)
    x[0, 1, 2] = 0.0
    x[1, 3, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    x = _kv(0)
    jq, js = jt.quantize_kv(jnp.asarray(x, dtype=dtype))
    tq, ts = tt.quantize_kv(torch.from_numpy(x).to(tt.to_torch_dtype(dtype)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts[0, 1, 2] == 1.0 and not tq[0, 1, 2].any()
    assert tq[1, 3, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 0]  # half to even
    np.testing.assert_array_equal(tt.dequantize_kv(tq, ts, torch.float32).numpy(),
                                  np.asarray(jt.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("paged", [False, True])
def test_int8_caches_match_jax_layout(paged):
    jcfg = jt.TransformerConfig(dim=64, n_heads=4, n_kv_heads=2, n_layers=2)
    tcfg = tt.TransformerConfig(dim=64, n_heads=4, n_kv_heads=2, n_layers=2)
    if paged:
        want = jt.init_paged_kv_caches(jcfg, 5, PS, "int8")
        got = tt.init_paged_kv_caches(tcfg, 5, PS, "int8", device="cpu")
    else:
        want = jt.init_kv_caches(jcfg, 3, 16, "int8")
        got = tt.init_kv_caches(tcfg, 3, 16, "int8", device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got[0], want[0]):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _int8_case(seed):
    """make_case's pools quantized per head per position, as the int8 write
    path stores them."""
    q, (k, v, pos), bt, qpos = make_case(seed)
    kq, ks = jt.quantize_kv(jnp.asarray(k))
    vq, vs = jt.quantize_kv(jnp.asarray(v))
    return q, tuple(np.array(a) for a in (kq, ks, vq, vs)) + (pos,), bt, qpos


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_plain_int8_pool_matches_jax(seed, oracle):
    q, cache, bt, qpos = _int8_case(seed)
    jcache = tuple(jnp.asarray(a) for a in cache)
    if oracle == "ref":
        want = jax_ref(jnp.asarray(q), jcache, jnp.asarray(bt), jnp.asarray(qpos))
    else:
        want = jax_kernel(jnp.asarray(q), jcache, jnp.asarray(bt), jnp.asarray(qpos),
                          interpret=True)
    before = port.paged_attention.launches_int8
    got = port.paged_attention(torch.from_numpy(q), tuple(torch.from_numpy(a) for a in cache),
                               torch.from_numpy(bt), torch.from_numpy(qpos))
    assert port.paged_attention.launches_int8 == before
    assert got.shape == (B, 1, H, HD) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jmod = jax_get_model("transformer", **KW)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmod = params_from_jax(params, get_model("transformer", device="cpu", **KW))
    return jmod, {"params": variables["params"]}, tmod


def _prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (b, s)).astype(np.int32)


def test_int8_dense_prefill_and_decode_match_jax(models):
    jmod, jvars, tmod = models
    b, plen, max_len = 2, 8, 16
    toks = _prompt(b, plen, 1)
    pos = np.tile(np.arange(plen, dtype=np.int32), (b, 1))
    pos[1, 5:] = jt.PAD_POS  # right-padded second row
    jc = jt.init_kv_caches(jmod.cfg, b, max_len, "int8")
    want, jc = jmod.apply(jvars, jnp.asarray(toks), positions=jnp.asarray(pos), caches=jc,
                          cache_index=0)
    tc = tt.init_kv_caches(tmod.cfg, b, max_len, "int8", device="cpu")
    got, tc = tmod(torch.from_numpy(toks), positions=torch.from_numpy(pos), caches=tc,
                   cache_index=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1, :5].numpy(), np.asarray(want[1, :5]), **TOL)
    # what was written: K/V come out of two frameworks' matmuls, so a code
    # may sit one step off where the float value lies on a rounding edge
    kq, ks, vq, vs, kpos = tc[0]
    for got_q, want_q in ((kq, jc[0][0]), (vq, jc[0][2])):
        assert np.abs(got_q.numpy().astype(int) - np.asarray(want_q).astype(int)).max() <= 1
    for got_s, want_s in ((ks, jc[0][1]), (vs, jc[0][3])):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(kpos.numpy(), np.asarray(jc[0][4]))
    nxt = np.array([[7], [9]], np.int32)
    idx = np.array([8, 5], np.int32)
    want, _ = jmod.apply(jvars, jnp.asarray(nxt), positions=jnp.asarray(idx[:, None]),
                         caches=jc, cache_index=jnp.asarray(idx))
    got, _ = tmod(torch.from_numpy(nxt), positions=torch.from_numpy(idx[:, None]),
                  caches=tc, cache_index=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_paged_chunks_and_decode_match_jax(models):
    jmod, jvars, tmod = models
    bt = np.full((2, 4), tt.NULL_PAGE, np.int32)
    bt[0, :3] = [7, 2, 10]
    bt[1, :3] = [4, 11, 3]
    toks = _prompt(2, 13, 2)
    jp = jt.init_paged_kv_caches(jmod.cfg, 12, PS, "int8")
    tp = tt.init_paged_kv_caches(tmod.cfg, 12, PS, "int8", device="cpu")
    for start in (0, 8):
        n = min(8, 13 - start)
        chunk = np.zeros((2, 8), np.int32)
        pos = np.full((2, 8), jt.PAD_POS, np.int32)
        chunk[:, :n] = toks[:, start:start + n]
        pos[:, :n] = np.arange(start, start + n)
        want, jp = jmod.apply(jvars, jnp.asarray(chunk), positions=jnp.asarray(pos),
                              caches=jp, block_tables=jnp.asarray(bt))
        got, tp = tmod(torch.from_numpy(chunk), positions=torch.from_numpy(pos), caches=tp,
                       block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(want[:, :n]), **TOL)
    nxt = np.array([[5], [6]], np.int32)
    pos = np.array([[13], [13]], np.int32)
    want, _ = jmod.apply(jvars, jnp.asarray(nxt), positions=jnp.asarray(pos), caches=jp,
                         block_tables=jnp.asarray(bt))
    got, _ = tmod(torch.from_numpy(nxt), positions=torch.from_numpy(pos), caches=tp,
                  block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_paged_equals_dense_bit_for_bit(models):
    """Inside the port, on the CPU: the int8 paged pool on shuffled pages
    and an int8 dense cache of the same logical length give identical
    logits through a prefill and three decode steps."""
    _, _, tmod = models
    bt = torch.tensor([[7, 2, 10, tt.NULL_PAGE], [4, 11, 3, tt.NULL_PAGE]], dtype=torch.int32)
    toks = torch.from_numpy(_prompt(2, 10, 3))
    pos = torch.arange(10)[None].expand(2, 10)
    dense = tt.init_kv_caches(tmod.cfg, 2, bt.shape[1] * PS, "int8", device="cpu")
    paged = tt.init_paged_kv_caches(tmod.cfg, 12, PS, "int8", device="cpu")
    d_out, _ = tmod(toks, positions=pos, caches=dense, cache_index=0)
    p_out, _ = tmod(toks, positions=pos, caches=paged, block_tables=bt)
    assert torch.equal(d_out, p_out)
    tok = d_out[:, -1].argmax(-1)
    for step in range(3):
        p = torch.full((2,), 10 + step, dtype=torch.int64)
        d_out, _ = tmod(tok[:, None], positions=p[:, None], caches=dense, cache_index=p)
        p_out, _ = tmod(tok[:, None], positions=p[:, None], caches=paged, block_tables=bt)
        assert torch.equal(d_out, p_out), f"decode step {step}"
        tok = d_out[:, -1].argmax(-1)
