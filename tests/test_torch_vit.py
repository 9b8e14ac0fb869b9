"""The port's MLP and ViT families (``seldon_core_tpu_torch/models/mlp.py``,
``models/vit.py``), their int8 and param-dtype predict through
``TorchServer``, and the ViT over a mesh, held against the JAX package's
``JAXServer`` on the CPU.

Each checkpoint is written by the JAX package's ``export_checkpoint(
use_orbax=False)`` from its own ``init`` with every leaf moved off flax's
zeros (``_live``: a zero head or ``cls`` would hide the head and the class
token). Inputs come from numpy with a seed. Tolerances, on max|output|:
float32 compute within 1e-4 (float32 sums in another order); bf16 within
2e-2 (bf16 roundings at other points: the GELU, the bias adds), top-1
equal wherever the reference's top two are further apart; int8 within
1e-4 under float32 compute (the same dequantized weights), 3e-2 under bf16
(K4's plain version scales after the sum where JAX dequantizes to float32
and rounds the weight to bf16)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.contracts.payload import SeldonError as JaxError
from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.ops import quantize as jq
from seldon_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seldon_core_tpu.parallel.sharding import shard_apply as jax_shard_apply
from seldon_core_tpu.servers.jaxserver import JAXServer
from seldon_core_tpu.servers.jaxserver import export_checkpoint as jax_export
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.ops.quantize import QuantizedTensor, quantized_bytes
from seldon_core_tpu_torch.parallel.sharding import sharding_report
from seldon_core_tpu_torch.parallel.topology import Topology
from seldon_core_tpu_torch.servers.torchserver import TorchServer

MODELS = {"mlp": (dict(features=[16, 16], num_classes=3), [4]),
          "vit-tiny": (dict(num_classes=5), [16, 16, 3])}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
INT8_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _live(variables, seed):
    rng = np.random.default_rng(seed)
    return {"params": jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.05, np.shape(a))).astype(np.float32),
        variables["params"])}


def write_ckpt(path, name, dtype, seed=0, kwargs=None, **cfg_extra):
    """A JAX-written checkpoint of ``name`` with live weights (``kwargs``
    over the model's test kwargs); config.json extended with ``cfg_extra``
    (quantize, param_dtype)."""
    shape = MODELS[name][1]
    kwargs = dict(MODELS[name][0], dtype=dtype, **(kwargs or {}))
    model = jax_get_model(name, **kwargs)
    variables = _live(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *shape))), seed + 1)
    jax_export(str(path), name, variables, kwargs=kwargs, input_shape=shape, use_orbax=False)
    if cfg_extra:
        cfg_path = path / "config.json"
        cfg = json.loads(cfg_path.read_text())
        cfg.update(cfg_extra)
        cfg_path.write_text(json.dumps(cfg))
    return str(path), variables


def images(name, n=3, seed=5):
    return np.random.default_rng(seed).standard_normal((n, *MODELS[name][1])).astype(np.float32)


def check(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    bound = tol * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > bound
    assert np.all((got.argmax(-1) == want.argmax(-1))[clear])


def serve_both(path, x, **knobs):
    jserver = JAXServer(model_uri=path, **knobs)
    server = TorchServer(model_uri=path, device="cpu", **knobs)
    return server.predict(x, []), jserver.predict(x, []), server


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jaxserver(tmp_path, name, dtype):
    path, _ = write_ckpt(tmp_path / "ckpt", name, dtype)
    x = images(name)
    got, want, server = serve_both(path, x)
    check(got, want, TOL[dtype])
    assert server.input_dtype == np.float32
    # a bucket-padded batch (3 -> 4) gives the same rows as one input alone
    np.testing.assert_allclose(server.predict(x[:1], []), got[:1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_int8_matches_jaxserver(tmp_path, name, dtype):
    path, _ = write_ckpt(tmp_path / "ckpt", name, dtype)
    x = images(name)
    got, want, server = serve_both(path, x, quantize="int8")
    check(got, want, INT8_TOL[dtype])
    module = server._module
    quantized = {n for n, m in module.named_modules() if isinstance(m, QuantizedTensor)}
    assert quantized and all(p.dim() < 2 for p in module.parameters())
    if name == "vit-tiny":
        # the 3-D and 4-D leaves JAX quantizes too
        assert {"cls", "pos_embed", "patch_embed.kernel", "head"} <= quantized
    fresh = get_model(name, device="cpu", input_shape=MODELS[name][1],
                      **dict(MODELS[name][0], dtype=dtype))
    assert quantized_bytes(module) < quantized_bytes(fresh)


@pytest.mark.parametrize("dtype,param_dtype,quantize", [
    ("bfloat16", "auto", ""), ("float32", "bfloat16", ""), ("float32", "auto", ""),
    ("bfloat16", "auto", "int8"), ("float32", "bfloat16", "int8")])
def test_param_dtype_matches_jaxserver(tmp_path, dtype, param_dtype, quantize):
    """The cast first, then int8 (the cast dtype becomes ``orig_dtype``);
    ``param_dtype`` from config.json, as ``JAXServer`` reads it."""
    path, _ = write_ckpt(tmp_path / "ckpt", "vit-tiny", dtype, param_dtype=param_dtype)
    x = images("vit-tiny")
    got, want, server = serve_both(path, x, quantize=quantize)
    lossy = param_dtype == "bfloat16" or dtype == "bfloat16"
    check(got, want, (INT8_TOL if quantize else TOL)["bfloat16" if lossy else "float32"])
    leaves = server._module.leaves()
    cast = torch.bfloat16 if lossy else torch.float32
    assert leaves["ln_final.scale"].dtype == cast
    if quantize:
        assert leaves["head"].orig_dtype == cast


def test_unsupported_quantize_errors_as_jaxserver(tmp_path):
    path, _ = write_ckpt(tmp_path / "ckpt", "mlp", "float32")
    with pytest.raises(JaxError) as jerr:
        JAXServer(model_uri=path, quantize="int4").load()
    with pytest.raises(SeldonError) as err:
        TorchServer(model_uri=path, quantize="int4", device="cpu").load()
    assert str(err.value) == str(jerr.value) == "unsupported quantize='int4' (int8 only)"
    assert err.value.status_code == jerr.value.status_code == 500


def test_input_sized_model_needs_input_shape(tmp_path):
    path, _ = write_ckpt(tmp_path / "ckpt", "mlp", "float32")
    cfg = json.loads((tmp_path / "ckpt" / "config.json").read_text())
    del cfg["input_shape"]
    (tmp_path / "ckpt" / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(SeldonError, match="input_shape") as err:
        TorchServer(model_uri=path, device="cpu").load()
    assert err.value.status_code == 500


def _spec(s):
    """A spec without its trailing replicated dims (JAX's ``P()`` form)."""
    s = list(s)
    while s and s[-1] is None:
        s.pop()
    return tuple(s)


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_vit_over_a_mesh_equals_jax_specs_and_unsharded(tmp_path, eight_devices, quantize):
    """{data 4, model 2}: every leaf's spec is the JAX package's
    (``tests/test_models.py::test_vit_shards_over_model_axis``), the heads
    and mlp shard over 'model' under ``strict_sharding``, and the sharded
    logits equal the unsharded forward's (float32 compute)."""
    # 4 classes: GSPMD cannot place a head of 5 over 'model' 2
    path, _ = write_ckpt(tmp_path / "ckpt", "vit-tiny", "float32", kwargs=dict(num_classes=4))
    model = jax_get_model("vit-tiny", num_classes=4)
    jmesh = jax_make_mesh({"data": 4, "model": 2}, eight_devices)
    full = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = {"params": full["params"]}
    if quantize:
        params = jq.quantize_params(params)
    _, jsharded = jax_shard_apply(lambda v, x: model.apply(v, x), model, params, jmesh,
                                  example_input=jax.ShapeDtypeStruct((1, 16, 16, 3), jnp.float32),
                                  strict=True)
    want_specs = {}
    for path_keys, leaf in jax.tree_util.tree_flatten_with_path(
            jsharded, is_leaf=lambda v: isinstance(v, jq.QuantizedTensor))[0]:
        name = ".".join(k.key for k in path_keys[1:])
        arr = leaf.q if isinstance(leaf, jq.QuantizedTensor) else leaf
        want_specs[name] = _spec(arr.sharding.spec)
    topo = Topology(devices=["cpu"] * 8)
    server = TorchServer(model_uri=path, mesh=topo.mesh({"data": 4, "model": 2}),
                         strict_sharding=True, quantize=quantize, device="cpu")
    x = images("vit-tiny", n=8)
    got = server.predict(x, [])
    sharded = server._module
    assert {n: _spec(s) for n, s in sharded.rank_trees.specs.items()} == want_specs
    assert "model" in sharding_report(sharded.rank_trees)["axes"]
    assert sharded.rank_trees.specs["attn_0.wqkv"] == (None, "model")
    plain = TorchServer(model_uri=path, quantize=quantize, device="cpu")
    np.testing.assert_allclose(got, plain.predict(x, []), atol=1e-5 * np.abs(got).max(), rtol=0)
    assert all(b % 4 == 0 for b in server.batch_buckets)


def test_mlp_over_model_axis_replicates_as_jax_does(tmp_path):
    """The MLP declares no logical axes in either package: over a 'model'
    axis it replicates, and ``strict_sharding`` raises."""
    path, _ = write_ckpt(tmp_path / "ckpt", "mlp", "float32")
    topo = Topology(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="every param leaf is replicated"):
        TorchServer(model_uri=path, tensor_parallel=2, topology=topo, strict_sharding=True,
                    device="cpu").load()
    x = images("mlp", n=4)
    got = TorchServer(model_uri=path, tensor_parallel=2, topology=topo, device="cpu")
    np.testing.assert_allclose(got.predict(x, []),
                               TorchServer(model_uri=path, device="cpu").predict(x, []),
                               atol=1e-6, rtol=0)
