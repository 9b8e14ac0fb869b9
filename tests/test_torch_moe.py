"""The port's MoE FFN (``MoEFFN`` in seldon_core_tpu_torch/models/
transformer.py) held against the JAX package's on the CPU, at tiny widths
(dim 64, 2 layers, 4 heads, 2 kv heads, 4 and 8 experts), inputs from a
numpy seed:

- ``MoEFFN`` against flax ``MoEFFN.apply`` in float32 within 1e-5 abs/rel
  at k in {1, 2, e}, and in bfloat16 within 2e-2 (a few bf16 ulps of the
  outputs: XLA and PyTorch round the bf16 products in different places);
- the chosen experts equal ``lax.top_k``'s, ties to the lower index;
- the MoE ``Transformer`` against JAX's within 1e-4: no cache, dense
  prefill + decode, paged chunks + paged decode (K1's plain version), and
  the speculative verify (``verify=True``) against JAX's chunk read;
- int8: JAX ``quantize_params`` -> ``params_from_jax`` -> the forward ==
  JAX's dequantized forward; a 3-D leaf's codes bit-equal and its scale
  [N]; the router never reaches the int8 GEMM;
- ``init_params``: an expert leaf's std is 1/sqrt(e * dim) (flax's
  fan_in), as JAX's init draws it;
- the tiny MoE ``LLMServer`` over ``/v1/generate`` gives the JAX server's
  greedy tokens; in the port, paged == dense, the batcher == ``generate()``,
  n-gram speculation == plain greedy, disaggregated == local and a prefix
  hit == a miss; a JAX-written msgpack checkpoint through ``model_uri``
  == ``load(params=...)``; ``lora_rank > 0`` with MoE raises as in JAX."""

import json
import math
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models import transformer as jt
from seldon_core_tpu.ops.quantize import dequantize_params, quantize_params
from seldon_core_tpu.servers.jaxserver import export_checkpoint
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.models import transformer as tt
from seldon_core_tpu_torch.models.convert import params_from_jax
from seldon_core_tpu_torch.ops import int8_matmul as k4
from seldon_core_tpu_torch.ops.quantize import QuantizedTensor
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32", n_experts=4, n_experts_per_token=2)
TOL = dict(rtol=1e-4, atol=1e-4)
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
PS = 8
SERVE = dict(model="transformer", max_new_tokens=8, eos_id=-1, seed=3, len_buckets=(16, 32),
             batch_buckets=(1, 4), temperature=0.0)
PROMPTS = ["hello world", [5, 9, 17, 2, 40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13, 1, 2], "a"]
BKW = dict(max_slots=2, max_len=64, len_buckets=(16, 32), page_size=8)
TIMEOUT = 120


def _np(t):
    return t.detach().float().numpy()


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------------ MoEFFN
def _ffn_pair(e, k, dtype="float32", seed=0):
    """(flax MoEFFN, its variables, the port's MoEFFN on the same weights)."""
    jcfg = jt.TransformerConfig(dim=64, ffn_dim=128, n_experts=e, n_experts_per_token=k,
                                dtype=getattr(jnp, dtype))
    jffn = jt.MoEFFN(jcfg)
    v = jffn.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 64), getattr(jnp, dtype)))
    tcfg = tt.TransformerConfig(dim=64, ffn_dim=128, n_experts=e, n_experts_per_token=k,
                                dtype=tt.to_torch_dtype(dtype))
    tffn = tt.MoEFFN(tcfg, device="cpu")
    for name, leaf in v["params"].items():
        getattr(tffn, name).copy_(torch.from_numpy(np.array(leaf)))
    return jffn, v, tffn


@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 8)])
def test_moe_ffn_equals_flax_float32(e, k):
    jffn, v, tffn = _ffn_pair(e, k, seed=e + k)
    x = _rng(e * 10 + k).standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jffn.apply(v, jnp.asarray(x)))
    got = tffn(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, **FFN_TOL)


@pytest.mark.parametrize("e", [4, 8])
def test_moe_ffn_equals_flax_bf16(e):
    jffn, v, tffn = _ffn_pair(e, 2, "bfloat16", seed=e)
    x = _rng(e).standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jffn.apply(v, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tffn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16_TOL)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (8, 3)])
def test_routing_equals_lax_top_k(e, k):
    """Random logits, and rows built with ties (equal values at several
    indices, the k-th and (k+1)-th among them): the chosen experts and
    their order equal ``lax.top_k``'s, the gates equal the softmax over
    them."""
    logits = _rng(e + k).standard_normal((64, e)).astype(np.float32)
    ties = np.round(_rng(k).standard_normal((64, e)) * 1.5).astype(np.float32)  # many ties
    ties[0] = 0.0
    ties[1, :] = 1.0
    ties[1, e - 1] = 2.0
    for rows in (logits, ties):
        gates, topi = tt.route(torch.from_numpy(rows), k)
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
        dense = np.zeros_like(rows)
        np.put_along_axis(dense, np.asarray(ji), np.asarray(jax.nn.softmax(jv, axis=-1)), -1)
        np.testing.assert_allclose(gates.numpy(), dense, rtol=1e-6, atol=1e-7)
    assert tt.route(torch.zeros((1, e)), k)[1].tolist() == [list(range(k))]


def test_tied_router_picks_the_lower_expert_as_jax():
    """A router whose columns 1, 2 and 3 are equal gives every token three
    equal gate logits: the MoE layer routes to the lower indices and its
    output equals flax's."""
    jffn, v, tffn = _ffn_pair(4, 2, seed=7)
    router = np.asarray(v["params"]["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    router[:, 0] = -router[:, 1]
    params = dict(v["params"], router=jnp.asarray(router))
    tffn.router.copy_(torch.from_numpy(router))
    x = _rng(3).standard_normal((1, 6, 64)).astype(np.float32)
    jlogits = jnp.asarray(x) @ jnp.asarray(router)
    _, ji = jax.lax.top_k(jlogits, 2)
    _, topi = tffn.gates(torch.from_numpy(x))
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    pos = np.asarray(jlogits)[..., 1] > 0       # tokens where the tied experts lead
    assert pos.any() and (topi.numpy()[pos] == [1, 2]).all()
    want = np.asarray(jffn.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_np(tffn(torch.from_numpy(x))), want, **FFN_TOL)


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def models():
    jmod = jax_get_model("transformer", **KW)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmod = params_from_jax({"params": params}, get_model("transformer", device="cpu", **KW))
    return jmod, {"params": variables["params"]}, tmod, params


def _prompt(b, s, seed=0):
    return _rng(seed).integers(0, KW["vocab_size"], (b, s)).astype(np.int32)


def test_state_dict_names_and_shapes(models):
    _, _, tmod, params = models
    sd = tmod.state_dict()
    assert not any(".ffn." in n for n in sd)
    assert {n.split(".", 2)[2] for n in sd if n.startswith("layer_0.moe.")} == \
        {"router", "w1", "w2", "w3"}
    assert sd["layer_1.moe.router"].shape == (64, 4)
    assert sd["layer_1.moe.w1"].shape == sd["layer_1.moe.w3"].shape == (4, 64, 128)
    assert sd["layer_1.moe.w2"].shape == (4, 128, 64)
    np.testing.assert_array_equal(_np(sd["layer_1.moe.w2"]), params["layer_1"]["moe"]["w2"])
    fresh = get_model("transformer", device="cpu", **KW)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["layer_0"]["moe"]["w1"] = np.zeros((4, 64, 127), np.float32)
    with pytest.raises(ValueError):
        params_from_jax(bad, fresh)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["layer_0"]["moe"]["w3"]
    with pytest.raises(KeyError):
        params_from_jax(missing, fresh)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["layer_0"]["moe"]["w4"] = np.zeros((4, 64, 128), np.float32)
    with pytest.raises(KeyError):
        params_from_jax(extra, fresh)


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
    pos[1, 5:] = jt.PAD_POS
    jc = jt.init_kv_caches(jmod.cfg, b, max_len)
    want, jc = jmod.apply(jvars, jnp.asarray(toks), positions=jnp.asarray(pos), caches=jc,
                          cache_index=0)
    tc = tt.init_kv_caches(tmod.cfg, b, max_len, device="cpu")
    got, tc = tmod(torch.from_numpy(toks), positions=torch.from_numpy(pos), caches=tc,
                   cache_index=0)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(_np(got[1, :5]), np.asarray(want[1, :5]), **TOL)
    nxt = np.array([[7], [9]], np.int32)
    idx = np.array([8, 5], np.int32)
    want, _ = jmod.apply(jvars, jnp.asarray(nxt), positions=jnp.asarray(idx[:, None]),
                         caches=jc, cache_index=jnp.asarray(idx))
    got, _ = tmod(torch.from_numpy(nxt), positions=torch.from_numpy(idx[:, None]),
                  caches=tc, cache_index=torch.from_numpy(idx))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _tables():
    bt = np.full((2, 4), tt.NULL_PAGE, np.int32)
    bt[0, :3] = [7, 2, 10]
    bt[1, :3] = [4, 11, 3]
    return bt


def _paged_prefill(jmod, jvars, tmod, toks, bt):
    """Chunks of 8 over ``toks`` on both sides: (JAX pools, port pools)."""
    jp = jt.init_paged_kv_caches(jmod.cfg, 12, PS)
    tp = tt.init_paged_kv_caches(tmod.cfg, 12, PS, device="cpu")
    n_tok = toks.shape[1]
    for start in range(0, n_tok, 8):
        n = min(8, n_tok - start)
        chunk = np.zeros((2, 8), np.int32)
        pos = np.full((2, 8), jt.PAD_POS, np.int32)
        chunk[:, :n] = toks[:, start:start + n]
        pos[:, :n] = np.arange(start, start + n)
        want, jp = jmod.apply(jvars, jnp.asarray(chunk), positions=jnp.asarray(pos),
                              caches=jp, block_tables=jnp.asarray(bt))
        got, tp = tmod(torch.from_numpy(chunk), positions=torch.from_numpy(pos), caches=tp,
                       block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(_np(got[:, :n]), np.asarray(want[:, :n]), **TOL)
    return jp, tp


def test_paged_chunks_and_decode_match_jax(models):
    jmod, jvars, tmod, _ = models
    bt = _tables()
    jp, tp = _paged_prefill(jmod, jvars, tmod, _prompt(2, 13, 2), bt)
    nxt = np.array([[5], [6]], np.int32)
    pos = np.array([[13], [13]], np.int32)
    want, _ = jmod.apply(jvars, jnp.asarray(nxt), positions=jnp.asarray(pos), caches=jp,
                         block_tables=jnp.asarray(bt))
    got, _ = tmod(torch.from_numpy(nxt), positions=torch.from_numpy(pos), caches=tp,
                  block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_verify_matches_jax_chunk(models):
    """The speculative verify (K + 1 = 5 columns a sequence, the second's
    last two past its draft cap) against JAX's paged chunk over the same
    pools: the real columns' logits."""
    jmod, jvars, tmod, _ = models
    bt = _tables()
    jp, tp = _paged_prefill(jmod, jvars, tmod, _prompt(2, 9, 4), bt)
    toks = _prompt(2, 5, 5)
    pos = np.tile(np.arange(9, 14, dtype=np.int32), (2, 1))
    pos[1, 3:] = jt.PAD_POS
    want, _ = jmod.apply(jvars, jnp.asarray(toks), positions=jnp.asarray(pos), caches=jp,
                         block_tables=jnp.asarray(bt))
    got, _ = tmod(torch.from_numpy(toks), positions=torch.from_numpy(pos), caches=tp,
                  block_tables=torch.from_numpy(bt), verify=True)
    real = pos != jt.PAD_POS
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)


def test_paged_equals_dense_bit_for_bit(models):
    _, _, tmod, _ = models
    bt = _tables()
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


# ------------------------------------------------------------------ int8
@pytest.fixture(scope="module")
def int8_models(models):
    jmod, jvars, _, _ = models
    qparams = quantize_params(jvars["params"])
    qtree = jax.tree_util.tree_map(np.asarray, qparams)
    layout = get_model("transformer", device="meta", **KW).quantize_().to_empty(device="cpu")
    return jmod, qparams, params_from_jax({"params": qtree}, layout)


def test_int8_forward_equals_jax_dequantized(int8_models, monkeypatch):
    jmod, qparams, tmod = int8_models
    w1 = tmod.layer_0.moe.w1
    assert isinstance(w1, QuantizedTensor) and tuple(w1.scale.shape) == (128,)
    assert isinstance(tmod.layer_0.moe.router, QuantizedTensor)
    calls = []
    real = k4.int8_matmul

    def recording(x, q, scale, out_dtype=None):
        calls.append(tuple(q.shape))
        return real(x, q, scale, out_dtype)

    monkeypatch.setattr(k4, "int8_matmul", recording)
    toks = _prompt(2, 12, 6)
    want, _ = jmod.apply({"params": dequantize_params(qparams)}, jnp.asarray(toks))
    got, _ = tmod(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    e, layers = KW["n_experts"], KW["n_layers"]
    # per layer wq wk wv wo + 3 products an expert, then the head; no
    # product is the router's [dim, e]
    assert len(calls) == layers * (4 + 3 * e) + 1
    assert (KW["dim"], e) not in calls
    assert calls.count((64, 128)) == 2 * e * layers and calls.count((128, 64)) == e * layers


def test_int8_codes_bit_equal_to_jax_quantize_params(models):
    _, jvars, tmod, _ = models
    qtree = jax.tree_util.tree_map(np.asarray, quantize_params(jvars["params"]))
    port = get_model("transformer", device="cpu", **KW)
    port.load_state_dict(tmod.state_dict())
    port.quantize_()
    for name in ("router", "w1", "w2", "w3"):
        ours = getattr(port.layer_1.moe, name)
        theirs = qtree["layer_1"]["moe"][name]
        assert ours.q.dtype == torch.int8 and tuple(ours.scale.shape) == (ours.q.shape[-1],)
        np.testing.assert_array_equal(ours.q.numpy(), np.asarray(theirs.q))
        np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(theirs.scale))
        deq = tt.dequantize_array(ours)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(theirs.q).astype(np.float32)
                                      * np.asarray(theirs.scale))


def test_random_int8_init_equals_quantized_float_init():
    """``init_params`` into the int8 layout (each 3-D leaf drawn and
    quantized straight into its buffers) == the float init then
    ``quantize_``."""
    kw = dict(KW, dtype="bfloat16")
    flt = get_model("transformer", device="cpu", param_dtype="auto", **kw)
    flt.init_params(torch.Generator().manual_seed(4))
    flt.quantize_()
    q8 = get_model("transformer", device="meta", param_dtype="auto", **kw).quantize_()
    q8.to_empty(device="cpu")
    q8.init_params(torch.Generator().manual_seed(4))
    for (na, a), (nb, b) in zip(flt.state_dict().items(), q8.state_dict().items()):
        assert na == nb and torch.equal(a, b), na


def test_init_std_uses_flax_fan_in():
    """An expert leaf [e, dim, ffn] has flax lecun_normal's fan_in e * dim
    (w2: e * ffn), so its std is 1/sqrt(fan_in) — within 5 %, as JAX's own
    init of the same shapes; 2-D leaves keep their std."""
    kw = dict(KW, n_experts=8)
    m = get_model("transformer", device="cpu", **kw)
    m.init_params(torch.Generator().manual_seed(0))
    jv = jax_get_model("transformer", **kw).init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 4), jnp.int32))["params"]
    e, d, f = 8, KW["dim"], KW["ffn_dim"]
    for leaf, fan_in in (("w1", e * d), ("w3", e * d), ("w2", e * f), ("router", d)):
        want = 1.0 / math.sqrt(fan_in)
        got = getattr(m.layer_0.moe, leaf).std().item()
        jax_std = float(np.std(np.asarray(jv["layer_0"]["moe"][leaf])))
        assert abs(got / want - 1) < 0.05, (leaf, got, want)
        assert abs(jax_std / want - 1) < 0.05, (leaf, jax_std, want)
    wq = m.layer_0.attention.wq.std().item()
    assert abs(wq * math.sqrt(d) - 1) < 0.05


# --------------------------------------------------------------- serving
MOE = dict(KW, tie_embeddings=True)


@pytest.fixture(scope="module")
def pair():
    """The JAX server and the port server on its weights (greedy)."""
    j = JaxLLMServer(model_kwargs=MOE, init_random=True, **SERVE)
    j.load()
    p = LLMServer(model_kwargs=MOE, device="cpu", **SERVE)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    return j, p


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def test_rest_generate_equals_jax(pair):
    j, p = pair
    server = LLMServer(model_kwargs=MOE, device="cpu", continuous_batching=2, kv_page_size=8,
                       **SERVE)
    server.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    httpd, _ = start(make_component_app(server, device="cpu"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for prompt in PROMPTS:
            want = j.generate([prompt])["tokens"][0]
            code, body = _post(url + "/v1/generate", {"prompt": prompt})
            assert code == 200 and body["tokens"] == want
        code, body = _post(url + "/v1/generate", {"prompts": ["hello", "a"]})
        assert code == 200 and body["tokens"] == j.generate(["hello", "a"])["tokens"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server._batcher_service.close()


def _batch(server, prompts, n=8, **kw):
    b = ContinuousBatcher(server, device="cpu", **dict(BKW, **kw))
    try:
        outs = [f.result(TIMEOUT) for f in [b.submit(pr, n) for pr in prompts]]
        return outs, b
    finally:
        b.close()


def _ids(server, prompts):
    return [server._tokenizer.encode(p) if isinstance(p, str) else list(p) for p in prompts]


@pytest.fixture(scope="module")
def expected(pair):
    _, p = pair
    return [p.generate([pr])["tokens"][0] for pr in _ids(p, PROMPTS)]


def test_generate_equals_jax(pair, expected):
    j, p = pair
    assert expected == [j.generate([pr])["tokens"][0] for pr in _ids(p, PROMPTS)]


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=8, page_size=4),
                                dict(decode_fuse_steps=3)],
                         ids=["plain", "chunked", "fused"])
def test_batcher_equals_generate(pair, expected, kw):
    _, p = pair
    fuse = kw.pop("decode_fuse_steps", 0)
    p.decode_fuse_steps = fuse
    try:
        outs, b = _batch(p, _ids(p, PROMPTS), **kw)
    finally:
        p.decode_fuse_steps = 0
    assert outs == expected
    assert b.page_stats()["kv_pages_in_use"] == 0


def test_ngram_spec_equals_plain_greedy(pair, expected):
    _, p = pair
    outs, b = _batch(p, _ids(p, PROMPTS), spec_mode="ngram", spec_k=3)
    assert outs == expected
    assert b.spec_stats()["spec_slot_steps_total"] > 0


def test_disaggregated_equals_local(pair, expected):
    j, _ = pair
    p = LLMServer(model_kwargs=MOE, device="cpu", disaggregation="remote_prefill",
                  prefill_devices=0, **SERVE)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    outs, b = _batch(p, _ids(p, PROMPTS))
    assert outs == expected
    assert b.handoff_stats()["handoffs_total"] == len(PROMPTS)
    assert sum(w.eager_runs for w in b._remote.workers) >= len(PROMPTS)


def test_prefix_hit_equals_miss(pair):
    """A three-turn chat (each prompt the last one + its answer + new
    tokens) hits the trie, a CoW copy of a partial page included, and gives
    the tokens of cold runs."""
    j, _ = pair
    p = LLMServer(model_kwargs=MOE, device="cpu", prefix_cache_size=8, **SERVE)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    turns = ([9, 8, 7, 6, 5, 4, 3, 2, 1, 11, 12], [30, 31, 32], [44, 45])
    b = ContinuousBatcher(p, device="cpu", **dict(BKW, page_size=4, prefill_chunk=8))
    prompts, outs = [], []
    try:
        for user in turns:
            prompts.append((prompts[-1] + outs[-1] if prompts else []) + user)
            outs.append(b.submit(prompts[-1], 6).result(TIMEOUT))
        stats = b._radix.stats()
    finally:
        b.close()
    assert stats["prefix_hit_tokens"] >= 16 and stats["prefix_cow_copies"] >= 1
    assert outs == [p.generate([pr], max_new_tokens=6)["tokens"][0] for pr in prompts]


def test_checkpoint_model_uri_equals_params(pair, tmp_path):
    j, p = pair
    path = export_checkpoint(str(tmp_path / "moe"), "transformer", j._params, kwargs=MOE,
                             use_orbax=False)
    from_uri = LLMServer(model=None, model_uri=path, device="cpu",
                         **{k: v for k, v in SERVE.items() if k != "model"})
    from_uri.load()
    assert isinstance(from_uri._module.layer_0.moe, tt.MoEFFN)
    prompts = _ids(p, PROMPTS)
    assert [from_uri.generate([pr])["tokens"][0] for pr in prompts] == \
        [p.generate([pr])["tokens"][0] for pr in prompts]
    for name, t in p._module.state_dict().items():
        assert torch.equal(from_uri._module.state_dict()[name], t), name


def test_int8_server_equals_jax(pair):
    """``quantize="int8"`` on both sides, from the same float weights."""
    j, _ = pair
    j8 = JaxLLMServer(model_kwargs=dict(MOE, tie_embeddings=False), init_random=True,
                      quantize="int8", **SERVE)
    j8.load()
    p8 = LLMServer(model_kwargs=dict(MOE, tie_embeddings=False), device="cpu",
                   quantize="int8", **SERVE)
    p8.load(params={"params": jax.tree_util.tree_map(np.asarray, j8._params["params"])})
    assert isinstance(p8._module.layer_1.moe.w2, QuantizedTensor)
    prompts = _ids(p8, PROMPTS)
    want = [j8.generate([pr])["tokens"][0] for pr in prompts]
    assert [p8.generate([pr])["tokens"][0] for pr in prompts] == want
    outs, _ = _batch(p8, prompts)
    assert outs == want


def test_lora_with_moe_raises_as_jax():
    kw = dict(model_kwargs=MOE, init_random=True, lora_rank=4, **SERVE)
    with pytest.raises(ValueError, match="MoE"):
        JaxLLMServer(**kw).load()
    with pytest.raises(ValueError, match="MoE"):
        LLMServer(device="cpu", **kw).load()
