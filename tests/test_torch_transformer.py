"""Port of the transformer (seldon_core_tpu_torch/models/transformer.py) held
against the JAX package's ``Transformer`` on the same params: weights cross
with ``params_from_jax``; float32 logits within atol=rtol=1e-4 (the same op
chain; XLA and PyTorch reduce in different orders) for the cache-less,
dense-cache and paged-pool paths. Inside the port, paged == dense is
bit-for-bit on the CPU (the paged read is the dense read on gathered bytes),
and fused_norm=True == fused_norm=False exactly (its plain version is the
unfused op chain)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models import transformer as jt
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.models import transformer as tt
from seldon_core_tpu_torch.models.convert import params_from_jax

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
PS = 8


@pytest.fixture(scope="module")
def models():
    jmod = jax_get_model("transformer", **KW)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmod = params_from_jax({"params": params}, get_model("transformer", device="cpu", **KW))
    return jmod, {"params": variables["params"]}, tmod, params


def _prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (b, s)).astype(np.int32)


def _np(t):
    return t.detach().numpy()


def test_params_from_jax_round_trip(models):
    _, _, tmod, params = models
    sd = tmod.state_dict()
    assert sd["layer_1.attention.wq"].shape == (64, 64)
    np.testing.assert_array_equal(_np(sd["layer_1.ffn.w2"]), params["layer_1"]["ffn"]["w2"])
    np.testing.assert_array_equal(_np(sd["tok_embeddings"]), params["tok_embeddings"])
    fresh = get_model("transformer", device="cpu", **KW)
    with pytest.raises(KeyError):  # a leftover JAX leaf
        params_from_jax({**params, "extra": np.zeros(3)}, fresh)
    missing = {k: v for k, v in params.items() if k != "norm"}
    with pytest.raises(KeyError):  # a port parameter left unfilled
        params_from_jax(missing, fresh)
    bad = dict(params, tok_embeddings=np.zeros((3, 64), np.float32))
    with pytest.raises(ValueError):
        params_from_jax(bad, fresh)


def test_cacheless_logits_match_jax(models):
    jmod, jvars, tmod, _ = models
    toks = _prompt(2, 12)
    want, _ = jmod.apply(jvars, jnp.asarray(toks))
    got, _ = tmod(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_dense_prefill_and_decode_match_jax(models):
    jmod, jvars, tmod, _ = models
    b, plen, max_len = 2, 8, 16
    toks = _prompt(b, plen, 1)
    pos = np.tile(np.arange(plen, dtype=np.int32), (b, 1))
    pos[1, 5:] = jt.PAD_POS  # right-padded second row
    jc = jt.init_kv_caches(jmod.cfg, b, max_len)
    want, jc = jmod.apply(jvars, jnp.asarray(toks), positions=jnp.asarray(pos), caches=jc,
                          cache_index=0)
    tc = tt.init_kv_caches(tmod.cfg, b, max_len, device="cpu")
    got, tc = tmod(torch.from_numpy(toks), positions=torch.from_numpy(pos), caches=tc,
                   cache_index=0)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(_np(got[1, :5]), np.asarray(want[1, :5]), **TOL)
    # one decode step at per-sequence offsets
    nxt = np.array([[7], [9]], np.int32)
    idx = np.array([8, 5], np.int32)
    want, _ = jmod.apply(jvars, jnp.asarray(nxt), positions=jnp.asarray(idx[:, None]),
                         caches=jc, cache_index=jnp.asarray(idx))
    got, _ = tmod(torch.from_numpy(nxt), positions=torch.from_numpy(idx[:, None]),
                  caches=tc, cache_index=torch.from_numpy(idx))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _paged_tables():
    """Two sequences on shuffled, non-contiguous pages of a 12-page pool."""
    bt = np.full((2, 4), tt.NULL_PAGE, np.int32)
    bt[0, :3] = [7, 2, 10]
    bt[1, :3] = [4, 11, 3]
    return bt


def test_paged_chunks_and_decode_match_jax(models):
    """Chunked prefill (two chunks of 8, the second padded) then one decode
    step through block tables — against the JAX paged path (its gather
    read on the CPU)."""
    jmod, jvars, tmod, _ = models
    bt = _paged_tables()
    toks = _prompt(2, 13, 2)
    jp = jt.init_paged_kv_caches(jmod.cfg, 12, PS)
    tp = tt.init_paged_kv_caches(tmod.cfg, 12, PS, device="cpu")
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
        np.testing.assert_allclose(_np(got[:, :n]), np.asarray(want[:, :n]), **TOL)
    nxt = np.array([[5], [6]], np.int32)
    pos = np.array([[13], [13]], np.int32)
    want, _ = jmod.apply(jvars, jnp.asarray(nxt), positions=jnp.asarray(pos), caches=jp,
                         block_tables=jnp.asarray(bt))
    got, _ = tmod(torch.from_numpy(nxt), positions=torch.from_numpy(pos), caches=tp,
                  block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_paged_equals_dense_bit_for_bit(models):
    """Inside the port, on the CPU: the paged pool on shuffled pages and a
    dense cache of the same logical length give identical logits through a
    prefill and three decode steps."""
    _, _, tmod, _ = models
    bt = _paged_tables()
    L = bt.shape[1] * PS
    toks = _prompt(2, 10, 3)
    pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    dense = tt.init_kv_caches(tmod.cfg, 2, L, device="cpu")
    paged = tt.init_paged_kv_caches(tmod.cfg, 12, PS, device="cpu")
    d_out, _ = tmod(torch.from_numpy(toks), positions=torch.from_numpy(pos), caches=dense,
                    cache_index=0)
    p_out, _ = tmod(torch.from_numpy(toks), positions=torch.from_numpy(pos), caches=paged,
                    block_tables=torch.from_numpy(bt))
    assert torch.equal(d_out, p_out)
    tok = d_out[:, -1].argmax(-1)
    for step in range(3):
        p = torch.full((2,), 10 + step, dtype=torch.int64)
        d_out, _ = tmod(tok[:, None], positions=p[:, None], caches=dense, cache_index=p)
        p_out, _ = tmod(tok[:, None], positions=p[:, None], caches=paged,
                        block_tables=torch.from_numpy(bt))
        assert torch.equal(d_out, p_out), f"decode step {step}"
        tok = d_out[:, -1].argmax(-1)


def test_fused_norm_flag_is_exact_in_f32(models):
    _, _, tmod, params = models
    fused = params_from_jax(params, get_model("transformer", device="cpu", fused_norm=True,
                                              **KW))
    toks = torch.from_numpy(_prompt(2, 9, 4))
    assert torch.equal(fused(toks)[0], tmod(toks)[0])


def test_bf16_auto_storage_and_llama_tiny_maker():
    m = get_model("llama-tiny", device="cpu", dtype="bfloat16", param_dtype="auto")
    assert m.cfg.tie_embeddings and not hasattr(m, "lm_head")
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    m.init_params(torch.Generator().manual_seed(0))
    logits, _ = m(torch.zeros((1, 4), dtype=torch.int64))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    norms = [p for n, p in m.named_parameters() if n.endswith("weight")]
    assert all(torch.equal(p, torch.ones_like(p)) for p in norms)


def test_rope_llama3_scaling_matches_jax():
    scaling = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                   original_max_position_embeddings=64)
    pos = np.arange(40, dtype=np.int32)[None]
    jc, js = jt.rotary_embedding(jnp.asarray(pos), 32, 500000.0, tuple(scaling.items()))
    tc, ts = tt.rotary_embedding(torch.from_numpy(pos), 32, 500000.0, tuple(scaling.items()))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)


def test_kv_bytes_per_token_matches_jax():
    for kvd in ("bf16", "int8"):
        jcfg = jt.TransformerConfig(dtype=jnp.bfloat16)
        tcfg = tt.TransformerConfig(dtype=torch.bfloat16)
        assert tt.kv_cache_bytes_per_token(tcfg, kvd) == jt.kv_cache_bytes_per_token(jcfg, kvd)


@pytest.mark.parametrize("kw,what", [
    (dict(n_experts=4), "MoE"),
    (dict(attention_impl="ring"), "ring"),
])
def test_later_slices_raise(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        get_model("transformer", device="cpu", **dict(KW, **kw))


def test_adapters_raise(models):
    _, _, tmod, _ = models
    with pytest.raises(NotImplementedError, match="LoRA"):
        tmod(torch.zeros((1, 2), dtype=torch.int64), adapters={}, adapter_ids=None)


@pytest.mark.parametrize("kvd", ["bf16", "int8"])
def test_dense_multi_token_per_sequence_write_raises(models, kvd):
    """The s > 1 per-sequence dense write (the speculative verify step) is
    a later slice's, for either cache dtype."""
    _, _, tmod, _ = models
    cache = tt.init_kv_caches(tmod.cfg, 1, 8, kvd, device="cpu")
    with pytest.raises(NotImplementedError, match="speculative"):
        tmod(torch.zeros((1, 2), dtype=torch.int64), positions=torch.tensor([[0, 1]]),
             caches=cache, cache_index=torch.tensor([0]))


def test_registry_names():
    from seldon_core_tpu_torch.models.registry import _REGISTRY

    assert {"transformer", "llama2-7b", "llama-tiny"} <= set(_REGISTRY)
