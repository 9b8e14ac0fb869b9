"""The port's parallel package (``seldon_core_tpu_torch/parallel``) against
the JAX package's, on the CPU: JAX over its 8 virtual devices
(``tests/conftest.py``), the port over co-located ranks (``["cpu"] * 8``).

- ``coordinator_config``, ``make_mesh`` (the ``-1`` inference and every
  error), ``partition_for_disaggregation`` and the disaggregated split give the JAX package's results and messages on the
  same inputs (devices compared by their index in the device list);
- ``Topology``: repeated devices are distinct ranks, sub-views, the
  declared axes, ``detect()`` without a card raises;
- the port's logical-axis table equals ``logical_axis_tree`` leaf by leaf,
  dense and MoE; ``shard_params``' per-leaf specs equal JAX's
  ``NamedSharding`` specs (int8 ``q`` / ``scale`` and an 'expert' axis
  included), each rank's shard equals the shard JAX places on the device
  at the same mesh position (exact), and ``sharding_report`` /
  ``strict`` agree with JAX's;
- the collectives: all-reduce in float32 in rank order, all-gather, and the
  'seq' softmax merge equal to one softmax over every key (float32, 1e-6);
- the refusals that remain name ROADMAP Queue A 9b: distinct-device
  meshes (before any weight moves), LoRA and speculation over a mesh, the
  batcher under 'seq' / 'data'; disaggregation with a mesh keeps the JAX
  package's error (ring attention, which this list named until it was
  ported, is held to JAX's in ``tests/test_torch_ring_attention.py``).
"""

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.parallel import mesh as jmesh
from seldon_core_tpu.parallel import multihost as jmulti
from seldon_core_tpu.parallel import sharding as jsharding
from seldon_core_tpu_torch.parallel import collectives
from seldon_core_tpu_torch.parallel import mesh as pmesh
from seldon_core_tpu_torch.parallel import multihost as pmulti
from seldon_core_tpu_torch.parallel import sharding as psharding
from seldon_core_tpu_torch.parallel.topology import (DECLARED_AXES, Topology, get_topology,
                                                     set_topology)

TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
            max_seq_len=128, dtype="float32", tie_embeddings=False)
MOE = dict(TINY, n_experts=4, n_experts_per_token=2)


def _cpu(n):
    return Topology(devices=["cpu"] * n)


def _layout(mesh_devices, devices):
    """The mesh's device array as indices into ``devices`` (by identity)."""
    ids = {id(d): i for i, d in enumerate(devices)}
    return np.vectorize(lambda d: ids[id(d)], otypes=[int])(np.asarray(mesh_devices,
                                                                       dtype=object))


# ------------------------------------------------------------ multihost
@pytest.mark.parametrize("env", [
    {},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"},
    {"COORDINATOR_ADDRESS": "h:9", "WORLD_SIZE": "2", "RANK": "1"},
    {"COORDINATOR_ADDRESS": "h:9", "NUM_PROCESSES": "3", "PROCESS_ID": "0", "RANK": "7"},
    {"JAX_COORDINATOR_ADDRESS": "h:9", "WORLD_SIZE": "2"},
    {"JAX_COORDINATOR_ADDRESS": "", "WORLD_SIZE": "2", "RANK": "0"},
], ids=["empty", "jax", "launcher", "precedence", "missing-id", "empty-addr"])
def test_coordinator_config_equals_jax(env):
    def run(fn):
        try:
            return ("ok", fn(dict(env)))
        except ValueError as e:
            return ("err", str(e))

    assert run(pmulti.coordinator_config) == run(jmulti.coordinator_config)


# ----------------------------------------------------------------- mesh
MESH_CASES = [
    {"data": -1, "model": 2}, {"data": 2, "seq": 2, "model": 2}, {"data": 1, "seq": 4, "model": 2},
    {"model": 8}, {"data": -1, "expert": 2, "model": 2}, {"data": 4, "model": -1},
    {"data": -1, "model": -1}, {"data": 3, "model": -1}, {"data": 2, "model": 2},
]


@pytest.mark.parametrize("axes", MESH_CASES, ids=lambda a: ",".join(f"{k}{v}" for k, v in
                                                                     a.items()))
def test_make_mesh_equals_jax(axes, eight_devices):
    jdevs, pdevs = eight_devices[:8], list(_cpu(8).devices)

    def run(make, devs):
        try:
            m = make(dict(axes), devs)
            return ("ok", dict(m.shape), m.axis_names, _layout(m.devices, devs).tolist())
        except ValueError as e:
            return ("err", str(e))

    assert run(pmesh.make_mesh, pdevs) == run(jmesh.make_mesh, jdevs)


def test_mesh_coords_groups_and_colocation():
    m = _cpu(8).mesh({"data": 2, "seq": 2, "model": 2})
    assert m.coords(5) == {"data": 1, "seq": 0, "model": 1}
    assert m.groups(("model",)) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.groups(("seq",)) == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert m.groups(("model", "expert")) == m.groups(("model",))
    assert m.axis_size("expert") == 1
    m.require_colocated("cpu")
    with pytest.raises(NotImplementedError, match="Queue A 9b"):
        Topology(devices=["cpu", "meta"]).mesh({"model": 2}).require_colocated()
    with pytest.raises(NotImplementedError, match="Queue A 9b"):
        m.require_colocated("meta")


def test_topology_ranks_views_and_axes(monkeypatch):
    dev = torch.device("cpu")
    topo = Topology(devices=[dev] * 4)
    assert topo.device_count == 4 and len({id(d) for d in topo.devices}) == 4
    assert all(d == dev for d in topo.devices)
    sub = topo.sub_topology(topo.devices[2:])
    assert sub.device_count == 2 and sub.devices == topo.devices[2:]
    assert sub.local_devices == topo.devices[2:]
    with pytest.raises(ValueError, match="not in this topology"):
        topo.sub_topology([torch.device("cpu")])
    with pytest.raises(ValueError, match="undeclared mesh axis"):
        topo.mesh({"tensor": 4})
    assert set(DECLARED_AXES) == {"data", "model", "seq", "expert", "pipe"}
    assert dict(topo.serving_mesh(2).shape) == {"data": 2, "model": 2}
    assert (topo.process_index, topo.process_count) == (0, 1)
    prev = set_topology(topo)
    try:
        assert get_topology() is topo
        assert dict(pmesh.make_mesh({"data": -1, "model": 4}).shape) == {"data": 1, "model": 4}
    finally:
        set_topology(prev)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Topology.detect()


def test_partition_for_disaggregation_equals_jax(eight_devices):
    """The contiguous tail split and its errors, on JAX's devices (which
    have no physical slices) and on the port's ranks."""
    pdevs, jdevs = list(_cpu(8).devices), eight_devices[:8]
    for n in (4, 3, 1, 7):
        j = jmulti.partition_for_disaggregation(jdevs, n)
        p = pmulti.partition_for_disaggregation(pdevs, n)
        assert ([_layout(part, pdevs).tolist() for part in p]
                == [_layout(part, jdevs).tolist() for part in j])
    for n in (8, 0):
        msgs = []
        for fn, devs in ((jmulti.partition_for_disaggregation, jdevs),
                         (pmulti.partition_for_disaggregation, pdevs)):
            with pytest.raises(ValueError) as ei:
                fn(devs, n)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_disaggregated_mesh_splits_and_validates(eight_devices):
    """The port of tests/test_disagg.py's split checks, beside JAX's."""
    pdevs = list(_cpu(8).devices)
    jdevs = eight_devices[:8]
    for args in [(2,), (1, 3), (3, 0)]:
        j = jmesh.disaggregated_mesh(*args, devices=jdevs)
        p = pmesh.disaggregated_mesh(*args, devices=pdevs)
        assert (_layout(p.prefill_devices, pdevs).tolist(),
                _layout(p.decode_devices, pdevs).tolist()) == \
               (_layout(j.prefill_devices, jdevs).tolist(),
                _layout(j.decode_devices, jdevs).tolist())
        assert dict(p.decode.shape) == dict(j.decode.shape)
    p3 = pmesh.disaggregated_mesh(pdevs[6:], pdevs[:2])
    assert p3.prefill_devices == pdevs[6:]
    m = pmesh.disaggregated_mesh(2, devices=pdevs)
    assert pdevs[0] in m.decode_devices and pdevs[-1] in m.prefill_devices
    for make in (lambda: pmesh.DisaggregatedMesh(pdevs[:2], pdevs[1:3]),
                 lambda: pmesh.DisaggregatedMesh([], pdevs[:2]),
                 lambda: pmesh.disaggregated_mesh(8, devices=pdevs)):
        with pytest.raises(ValueError) as pe:
            make()
        jmake = {0: lambda: jmesh.DisaggregatedMesh(jdevs[:2], jdevs[1:3]),
                 1: lambda: jmesh.DisaggregatedMesh([], jdevs[:2]),
                 2: lambda: jmesh.disaggregated_mesh(8, devices=jdevs)}
        assert any(str(pe.value) == _msg(f) for f in jmake.values())
    # the port's one-card split: the workers share the decode device
    shared = pmesh.DisaggregatedMesh(pdevs[:1] * 2, pdevs[:1], shared=True)
    assert len(shared.prefill_devices) == 2
    topo = _cpu(8)
    dm = topo.disaggregated(2)
    assert dm.prefill_topology.device_count == 2 and dm.decode_topology.device_count == 6


def _msg(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------- sharding
def _jax_model(kw, quant=False):
    from seldon_core_tpu.models import get_model as jget

    m = jget("transformer", **kw)
    params = jax.jit(m.init)(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"]
    if quant:
        from seldon_core_tpu.ops.quantize import quantize_params

        params = quantize_params(params)
    return m, params


def _port_model(params, kw, quant=False):
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.models.convert import params_from_jax

    m = get_model("transformer", device="cpu", **kw)
    if quant:
        m.quantize_()
    tree = jax.tree_util.tree_map(np.asarray, params)
    params_from_jax({"params": tree}, m)
    return m


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("kw", [TINY, MOE], ids=["dense", "moe"])
def test_logical_axis_table_equals_jax(kw):
    from seldon_core_tpu.models import get_model as jget
    from seldon_core_tpu_torch.models import get_model

    jtree = jsharding.logical_axis_tree(jget("transformer", **kw),
                                        jax.ShapeDtypeStruct((1, 8), np.int32))
    from jax.sharding import PartitionSpec

    leaves = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    want = {".".join(k.key for k in path): tuple(spec) for path, spec in leaves}
    got = psharding.logical_axis_tree(get_model("transformer", device="meta", **kw))
    assert got == want


def _spec(s, ndim):
    s = tuple(s)
    return s + (None,) * (ndim - len(s))


@pytest.mark.parametrize("kw,axes,quant", [
    (TINY, {"data": 4, "model": 2}, False),
    (TINY, {"data": 1, "seq": 4, "model": 2}, True),
    (MOE, {"data": 2, "expert": 2, "model": 2}, False),
    (MOE, {"data": 1, "expert": 4, "model": 2}, True),
], ids=["dense-tp2", "int8-seq4-tp2", "moe-expert2", "moe-int8-expert4"])
def test_shard_params_equals_jax(kw, axes, quant, eight_devices):
    jm, jparams = _jax_model(kw, quant)
    jmesh_ = jmesh.make_mesh(axes, eight_devices[:8])
    jl = jsharding.logical_axis_tree(jm, jax.ShapeDtypeStruct((1, 8), np.int32))
    jsh = jsharding.shard_params(jparams, jmesh_, jl)
    port = _port_model(jparams, kw, quant)
    pmesh_ = _cpu(8).mesh(axes)
    hd = kw["dim"] // kw["n_heads"]
    trees = psharding.shard_params(port.leaves(), pmesh_, port.logical_axes(),
                                   units={"heads": hd, "kv_heads": hd})
    from seldon_core_tpu.ops.quantize import QuantizedTensor as JQ

    jflat = _flat(jax.tree_util.tree_map(lambda x: x, jsh, is_leaf=lambda x: isinstance(x, JQ)))
    assert set(jflat) == set(trees.specs)
    jdev_rank = {d.id: r for r, d in enumerate(np.asarray(jmesh_.devices).reshape(-1))}
    for name, leaf in jflat.items():
        arrays = [("q", leaf.q, trees.specs[name]),
                  ("scale", leaf.scale, trees.specs[name][-1:])] if isinstance(leaf, JQ) \
            else [("", leaf, trees.specs[name])]
        for part, arr, pspec in arrays:
            assert _spec(arr.sharding.spec, arr.ndim) == pspec, (name, part)
            for shard in arr.addressable_shards:
                r = jdev_rank[shard.device.id]
                mine = trees[r][name]
                mine = getattr(mine, part) if part else mine
                assert mine.is_contiguous() and mine.data_ptr() % 16 == 0
                np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data),
                                              err_msg=f"{name}.{part} rank {r}")
    rep = psharding.sharding_report(trees)
    jrep = jsharding.sharding_report(jsh)
    assert (rep["sharded"], rep["replicated"], rep["axes"]) == \
           (jrep["sharded"], jrep["replicated"], jrep["axes"])


def test_strict_raises_where_jax_does(eight_devices):
    """A model with no logical axes (a ResNet) on a mesh with a 'model'
    axis: replicated, and ``strict`` raises JAX's error; a transformer on
    the same mesh shards and passes."""
    from seldon_core_tpu.models import get_model as jget
    from seldon_core_tpu_torch.models import get_model

    jr = jget("resnet18", num_classes=4)
    jvars = jax.jit(jr.init)(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    jm = jmesh.make_mesh({"data": 4, "model": 2}, eight_devices[:8])
    with pytest.raises(ValueError) as je:
        jsharding.shard_apply(lambda p, x: jr.apply(p, x), jr, jvars, jm, strict=True,
                              example_input=jax.ShapeDtypeStruct((1, 32, 32, 3), np.float32))
    pr = get_model("resnet18", num_classes=4, device="cpu")
    pm = _cpu(8).mesh({"data": 4, "model": 2})
    with pytest.raises(ValueError) as pe:
        psharding.shard_apply(lambda m, x: m(x), pr, pm, strict=True)
    head = "but every param leaf is replicated"
    assert head in str(je.value) and head in str(pe.value)
    assert str(pe.value).split("(report")[0] == str(je.value).split("(report")[0]
    run, _ = psharding.shard_apply(lambda m, x: m(x), pr, pm, strict=False)
    port = get_model("transformer", device="cpu", **TINY)
    port.init_params(torch.Generator().manual_seed(0))
    _, sharded = psharding.shard_apply(lambda m, x: m(x)[0], port, pm, strict=True)
    assert "model" in psharding.sharding_report(sharded.rank_trees)["axes"]


# ---------------------------------------------------------- collectives
def test_collectives_sum_in_float32_in_rank_order():
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 5, generator=g).to(torch.bfloat16) for _ in range(4)]
    out = collectives.all_reduce(parts)
    want = (((parts[0].float() + parts[1].float()) + parts[2].float()) + parts[3].float())
    assert all(o is out[0] for o in out) and out[0].dtype == torch.bfloat16
    assert torch.equal(out[0], want.to(torch.bfloat16))
    gathered = collectives.all_gather([p.float() for p in parts], dim=-1)
    assert torch.equal(gathered[2], torch.cat([p.float() for p in parts], dim=-1))
    with pytest.raises(NotImplementedError, match="Queue A 9b"):
        collectives.all_reduce([torch.zeros(1), torch.zeros(1, device="meta")])


@pytest.mark.parametrize("masked", ["none", "one-range", "all"])
def test_softmax_merge_equals_one_softmax(masked):
    """Tolerance: float32 exp/sum reassociation, 1e-6 absolute on values of
    order 1."""
    g = torch.Generator().manual_seed(1)
    b, h, q, k, hd = 2, 3, 4, 12, 8
    logits = torch.randn(b, h, q, k, generator=g)
    v = torch.randn(b, k, h, hd, generator=g)
    low = torch.finfo(torch.float32).min
    if masked == "one-range":
        logits[..., 4:8] = low
    elif masked == "all":
        logits[...] = low
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    parts = [collectives.softmax_partial(logits[..., i:i + 4], v[:, i:i + 4])
             for i in range(0, k, 4)]
    got = collectives.softmax_merge(parts, torch.float32)[0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------- refusals
COMMON = dict(model="transformer", model_kwargs=TINY, max_new_tokens=4, eos_id=-1,
              len_buckets=(16,), batch_buckets=(1, 2), init_random=True)


def test_distinct_device_mesh_raises_before_weights_move(monkeypatch):
    from seldon_core_tpu_torch.models import registry
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    built = []
    real = registry.get_model
    monkeypatch.setattr(registry, "get_model", lambda *a, **k: built.append(a) or real(*a, **k))
    two = Topology(devices=["cpu", "meta"])
    for kw in (dict(mesh=two.mesh({"model": 2})), dict(tensor_parallel=2, topology=two)):
        s = LLMServer(device="cpu", **COMMON, **kw)
        with pytest.raises(NotImplementedError, match="two-card meshes, ROADMAP Queue A 9b"):
            s.load()
    assert built == []
    # ranks that share a device, but not the server's
    s = LLMServer(device="cpu", mesh=Topology(devices=["meta"] * 2).mesh({"model": 2}), **COMMON)
    with pytest.raises(NotImplementedError, match="Queue A 9b"):
        s.load()


@pytest.mark.parametrize("kw,err,match", [
    (dict(disaggregation="remote_prefill"), ValueError, "does not yet compose"),
], ids=["disagg"])
def test_mesh_refusals_name_queue_9b(kw, err, match):
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    with pytest.raises(err, match=match):
        LLMServer(device="cpu", tensor_parallel=2, topology=_cpu(2), **COMMON, **kw).load()


def test_config_mesh_points_to_shard():
    """A mesh reaches the port's model through ``Transformer.shard`` after
    the weights are in, never through the config."""
    from seldon_core_tpu_torch.models import get_model

    with pytest.raises(ValueError, match=r"Transformer.shard\(mesh\)"):
        get_model("transformer", device="cpu", **dict(TINY, mesh=_cpu(2).mesh({"model": 2})))
