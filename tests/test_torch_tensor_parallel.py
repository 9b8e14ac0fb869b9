"""Serving over a mesh in the port (``models/sharded.py`` through
``LLMServer`` and ``TorchServer``) against the JAX package's GSPMD serving,
on the CPU: JAX over its 8 virtual devices, the port over co-located ranks
(``["cpu"] * n``), the same weights (a JAX init carried over with
``params_from_jax``), float32 models at llama-tiny widths.

- ``generate()`` on ``{"data": 1, "seq": 4, "model": 2}`` (the ports of
  tests/test_llm.py's and tests/test_kv_cache.py's seq-sharded cases: a
  96-token prompt over 4 cache ranges, bf16-layout and int8 KV): greedy
  tokens EQUAL JAX's on JAX's mesh; the prefill logits within 1e-4 of
  JAX's (float32; the sharded sums and the log-sum-exp merge reassociate);
  each rank's cache holds its quarter of the positions and its KV head;
- the graph batcher at tp = 2 (bf16 layout; int8 weights + int8 KV): its
  tokens EQUAL the unsharded port batcher's and JAX's ``generate()`` (for
  int8, JAX's int8 server sharded over its own {"data": 1, "model": 2});
- MoE at tp = 2 and on an 'expert' axis: tokens EQUAL JAX's on the same
  mesh;
- the prefix caches at tp = 2 (``generate()``'s dense entries, the
  batcher's radix trie with its copy-on-write copy): tokens, hits and
  counters EQUAL the unsharded server's;
- ``TorchServer`` with ``tensor_parallel`` reached through a graph spec's
  typed parameters (with ``strict_sharding``) equals ``JAXServer`` on the
  same checkpoint (1e-4: float32 logits); its buckets round to the 'data'
  axis; a ResNet replicates: ``strict_sharding`` raises as JAX does, and
  over 'data' = 2 its logits equal the unsharded forward's within 1e-5
  (float32, each block its own batch).
"""

import asyncio

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.parallel.topology import Topology, set_topology
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.servers.llmserver import LLMServer

TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
            max_seq_len=128, dtype="float32", tie_embeddings=True)
MOE = dict(TINY, n_experts=4, n_experts_per_token=2, tie_embeddings=False)
KV = {"bf16-layout": {}, "int8": dict(kv_cache_dtype="int8")}
TIMEOUT = 120


def _cpu(n):
    return Topology(devices=["cpu"] * n)


def _jax_server(kw, mesh_axes=None, devices=None, **extra):
    mesh = None if mesh_axes is None else jax_make_mesh(mesh_axes, devices[:_size(mesh_axes)])
    s = JaxLLMServer(model="transformer", model_kwargs=kw, init_random=True, temperature=0.0,
                     eos_id=-1, seed=3, mesh=mesh, **extra)
    s.load()
    return s


def _size(axes):
    return int(np.prod(list(axes.values())))


def _tree(js):
    return {"params": jax.tree_util.tree_map(np.asarray, js._params["params"])}


def _port(tree, kw, mesh_axes=None, **extra):
    mesh = None if mesh_axes is None else _cpu(_size(mesh_axes)).mesh(mesh_axes)
    s = LLMServer(model="transformer", model_kwargs=kw, temperature=0.0, eos_id=-1, seed=3,
                  device="cpu", mesh=mesh, **extra)
    s.load(params=tree)
    return s


SEQ_MESH = {"data": 1, "seq": 4, "model": 2}


@pytest.mark.parametrize("kv", list(KV))
def test_seq_sharded_generate_equals_jax(kv, eight_devices):
    extra = dict(KV[kv], max_new_tokens=8, len_buckets=(96,), batch_buckets=(1, 2))
    js = _jax_server(TINY, SEQ_MESH, eight_devices, **extra)
    port = _port(_tree(js), TINY, SEQ_MESH, **extra)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 255, size=96).tolist(), rng.integers(1, 255, size=70).tolist()]
    assert port.generate(prompts)["tokens"] == js.generate(prompts)["tokens"]
    # the prefill program's logits (b = 2, plen = 96, max_len = 104: 26 a range)
    tokens = np.zeros((2, 96), np.int64)
    positions = np.full((2, 96), 1 << 28, np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        positions[i, :len(p)] = np.arange(len(p))
    jl, _ = js._get_prefill(2, 96, 104)(js._params, tokens.astype(np.int32), positions)
    caches = port._module.init_caches((2, 104), port.kv_cache_dtype, device="cpu")
    pl = port._get_prefill(2, 96, 104)(caches, torch.from_numpy(tokens),
                                       torch.from_numpy(positions))
    real = positions < (1 << 28)   # a padded column's logits are never read
    np.testing.assert_allclose(pl.numpy()[real], np.asarray(jl)[real], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv", list(KV))
def test_seq_sharded_cache_layout(kv):
    """Each of the 8 ranks holds positions [9j, 9j + 9) of max_len 36 and
    its KV head (2 heads over 'model' = 2), int8 scales beside their
    values."""
    s = LLMServer(model="llama-tiny", init_random=True, max_new_tokens=4, len_buckets=(32,),
                  batch_buckets=(1,), mesh=_cpu(8).mesh(SEQ_MESH), device="cpu", **KV[kv])
    s.load()
    caches = s._module.init_caches((1, 36), s.kv_cache_dtype, device="cpu")
    assert len(caches) == 8 * 2 and caches.lead == (1, 36)
    s._get_prefill(1, 32, 36)(caches, torch.zeros((1, 32), dtype=torch.int64),
                              torch.arange(32)[None, :].int())
    for r in range(8):
        layer = caches[r * 2]
        assert layer[0].shape == (1, 9, 1, 16)
        assert layer[-1].shape == (1, 9)
        if kv == "int8":
            assert layer[0].dtype == torch.int8 and layer[1].shape == (1, 9, 1)
        j = r // 2   # the rank's 'seq' coordinate
        want = torch.arange(9 * j, 9 * j + 9).int()
        want[want >= 32] = 1 << 28
        assert torch.equal(layer[-1][0], want)


def test_spec_driven_sequence_parallel():
    s = LLMServer(model="llama-tiny", init_random=True, max_new_tokens=4, len_buckets=(32,),
                  batch_buckets=(1,), sequence_parallel=4, tensor_parallel=2,
                  topology=_cpu(8), device="cpu")
    s.load()
    assert dict(s.mesh.shape) == {"data": 1, "seq": 4, "model": 2}
    out = s.generate([[7, 12, 80, 4]], max_new_tokens=4)["tokens"][0]
    assert len(out) <= 4
    with pytest.raises(Exception, match="does not divide 8"):
        LLMServer(model="llama-tiny", init_random=True, tensor_parallel=3, topology=_cpu(8),
                  device="cpu").load()


BATCHER_KNOBS = {"bf16-layout": {}, "int8": dict(quantize="int8", kv_cache_dtype="int8")}


@pytest.mark.parametrize("knobs", list(BATCHER_KNOBS))
def test_batcher_tp2_equals_unsharded_and_jax(knobs, eight_devices):
    shape = dict(max_new_tokens=6, len_buckets=(16, 32), batch_buckets=(1, 4))
    extra = dict(BATCHER_KNOBS[knobs], **shape)
    js = _jax_server(TINY, **shape)
    tree = _tree(js)
    plain = _port(tree, TINY, **extra)
    tp2 = _port(tree, TINY, {"data": 1, "model": 2}, **extra)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 255, size=int(n)).tolist() for n in (5, 14, 27, 9)]
    got = {}
    for name, server in (("plain", plain), ("tp2", tp2)):
        b = ContinuousBatcher(server, device="cpu", max_slots=4, prefill_chunk=8)
        try:
            got[name] = [f.result(TIMEOUT) for f in [b.submit(p, 6) for p in prompts]]
        finally:
            b.close()
        assert server._prefill_eager > 0 and server._decode_eager > 0
    assert got["tp2"] == got["plain"]
    # JAX's reference: the float server; for int8 a server of the same seed
    # that quantizes the same init, then shards it over JAX's own mesh
    jref = js if knobs != "int8" else _jax_server(TINY, {"data": 1, "model": 2}, eight_devices,
                                                   **extra)
    assert got["tp2"] == jref.generate(prompts)["tokens"]
    # each rank's pool holds its KV head, a copy of every position row
    b = ContinuousBatcher(tp2, device="cpu", max_slots=2)
    try:
        assert len(b._caches) == 2 * 2 and b._caches[0][0].shape[2] == 1
    finally:
        b.close()


@pytest.mark.parametrize("axes", [{"data": 1, "model": 2}, {"data": 1, "expert": 2, "model": 2},
                                  {"data": 2, "expert": 4}], ids=["tp2", "expert2-tp2",
                                                                  "data2-expert4"])
def test_moe_over_a_mesh_equals_jax(axes, eight_devices):
    extra = dict(max_new_tokens=6, len_buckets=(16,), batch_buckets=(1, 4))
    js = _jax_server(MOE, axes, eight_devices, **extra)
    port = _port(_tree(js), MOE, axes, **extra)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 255, size=int(n)).tolist() for n in (6, 11, 3, 15)]
    assert port.generate(prompts)["tokens"] == js.generate(prompts)["tokens"]
    m = port._module
    assert m.expert_split == ("expert" in axes) and m.mlp_split == ("model" in axes)


# ----------------------------------------------------------- TorchServer
def test_torchserver_tensor_parallel_spec_equals_jaxserver(eight_devices, tmp_path):
    """tests/test_sharding.py's spec-driven case on both servers: a typed
    ``tensor_parallel`` builds the ('data', 'model') mesh over the process
    topology, ``strict_sharding`` passes (the transformer shards)."""
    from seldon_core_tpu.contracts.graph import PredictorSpec as JSpec
    from seldon_core_tpu.contracts.payload import SeldonMessage as JMsg
    from seldon_core_tpu.models import get_model as jget
    from seldon_core_tpu.runtime.engine import GraphEngine as JEngine
    from seldon_core_tpu.servers.jaxserver import export_checkpoint
    from seldon_core_tpu_torch.contracts.graph import PredictorSpec
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.parallel.sharding import sharding_report
    from seldon_core_tpu_torch.runtime.engine import GraphEngine

    model = jget("llama-tiny")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))
    ckpt = export_checkpoint(str(tmp_path / "ckpt"), model="llama-tiny", params=variables,
                             input_shape=[8], input_dtype="int32", use_orbax=False)
    spec = {"name": "p", "graph": {
        "name": "llm", "type": "MODEL", "implementation": "JAX_SERVER", "modelUri": ckpt,
        "parameters": [{"name": "tensor_parallel", "value": "2", "type": "INT"},
                       {"name": "strict_sharding", "value": "true", "type": "BOOL"}]}}
    x = np.random.default_rng(3).integers(0, 256, size=(3, 8)).astype(float)
    body = {"data": {"tensor": {"shape": [3, 8], "values": x.ravel().tolist()}}}
    jout = asyncio.run(JEngine(JSpec.from_dict(spec)).predict(JMsg.from_dict(body))).to_dict()
    prev = set_topology(_cpu(8))
    try:
        engine = GraphEngine(PredictorSpec.from_dict(spec), device="cpu")
        pout = asyncio.run(engine.predict(SeldonMessage.from_dict(body))).to_dict()
    finally:
        set_topology(prev)
    unit = engine.state.root.component
    assert dict(unit.mesh.shape) == {"data": 4, "model": 2}
    assert all(b % 4 == 0 for b in unit.batch_buckets), unit.batch_buckets
    assert "model" in sharding_report(unit._module.rank_trees)["axes"]
    assert pout["data"]["tensor"]["shape"] == jout["data"]["tensor"]["shape"] == [3, 8, 256]
    np.testing.assert_allclose(np.asarray(pout["data"]["tensor"]["values"]),
                               np.asarray(jout["data"]["tensor"]["values"]), atol=1e-4, rtol=0)


def test_torchserver_resnet_replicates_over_data(tmp_path):
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint

    m = get_model("resnet18", num_classes=5, fused=True, dtype="float32", device="cpu")
    m.init_params(torch.Generator().manual_seed(0))
    path = export_checkpoint(str(tmp_path / "rn"), "resnet18", {"params": m.param_tree()},
                             kwargs={"num_classes": 5, "fused": True, "dtype": "float32"},
                             input_shape=[32, 32, 3])
    topo = _cpu(4)
    with pytest.raises(ValueError, match="every param leaf is replicated"):
        TorchServer(model_uri=path, tensor_parallel=2, topology=topo, strict_sharding=True,
                    device="cpu").load()
    x = np.random.default_rng(0).standard_normal((6, 32, 32, 3)).astype(np.float32)
    plain = TorchServer(model_uri=path, device="cpu")
    dp2 = TorchServer(model_uri=path, mesh=topo.mesh({"data": 2, "model": 2}), device="cpu")
    want = plain.predict(x, [])
    got = dp2.predict(x, [])
    assert all(b % 2 == 0 for b in dp2.batch_buckets)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_prefix_caches_over_tp2_equal_unsharded():
    """The dense prefix entries of ``generate()`` (copies of every rank's
    caches; a partial hit through ``_get_extend``) and the batcher's radix
    trie (its copy-on-write page copy walks every rank's pools) at tp = 2:
    tokens, hits and the trie's counters equal the unsharded server's."""
    kw = dict(model="llama-tiny", init_random=True, max_new_tokens=6, len_buckets=(16, 32),
              batch_buckets=(1, 4), temperature=0.0, seed=3, device="cpu", eos_id=-1,
              prefix_cache_size=8, kv_page_size=8)
    shared = list(range(5, 25))
    prompts = [shared + [30, 31], shared + [40, 41, 42], shared + [30, 31]]
    got = []
    for mesh_kw in ({}, dict(tensor_parallel=2, topology=_cpu(2))):
        s = LLMServer(**kw, **mesh_kw)
        s.load()
        dense = [s.generate([p])["tokens"][0] for p in prompts]
        b = ContinuousBatcher(s, device="cpu", max_slots=2)
        try:
            paged = [b.submit(p, 6).result(TIMEOUT) for p in prompts]
            stats = b._radix.stats()
        finally:
            b.close()
        got.append((dense, s._prefix_hits, paged, stats))
    assert got[1] == got[0]
    assert got[1][1] >= 1 and got[1][3]["prefix_cow_copies"] > 0
