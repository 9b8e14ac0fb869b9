"""Parameter sharding over a mesh by logical axis names.

Port of ``seldon_core_tpu/parallel/sharding.py``. The JAX package's models
carry flax *logical* axis names on their params; a rule table maps them
onto mesh axes and GSPMD places each leaf. The port has no flax: a model
that shards declares its table itself (``Transformer.logical_axes()``:
the names the JAX package's transformer declares, leaf by leaf), and
``shard_params`` cuts every leaf into one rank-local tensor a mesh rank,
each materialized contiguous (a fresh allocation, so 16-byte aligned: the
kernels' TMA descriptors and 16-byte loads need it, and a column slice of a
``[K, N]`` weight is a strided view).

The rules are the JAX package's, with GSPMD's divisibility: a dim whose
mesh axis does not divide it (counted in ``units``: whole heads for the
head axes) is replicated, as ``_cache_shardings``' ``axis()`` does. Ranks
that hold the same shard on one device share one tensor.

Int8 leaves (``ops/quantize.QuantizedTensor``) follow the JAX package's
rule: ``q`` takes the weight's spec and ``scale`` [C] the spec's LAST axis,
so a column shard cuts the scale with its columns and a row shard keeps
it whole.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

logger = logging.getLogger(__name__)

# logical axis -> mesh axis (None = replicated). Megatron-style layout:
# hidden/ffn/head dims shard over 'model'; batch over 'data'; sequence over
# 'seq' (long-context); experts over 'expert'.
DEFAULT_LOGICAL_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "data"),
    ("seq", None),
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("expert", "expert"),
)

Spec = Tuple[Optional[str], ...]


def _rules_for_mesh(mesh, rules) -> list:
    """Drop rules whose mesh axis doesn't exist on this mesh."""
    available = set(mesh.axis_names)
    return [(logical, physical if physical in available else None)
            for logical, physical in rules]


def logical_to_mesh_axes(logical: Sequence[Optional[str]], rules) -> Spec:
    """flax's ``logical_to_mesh_axes``: each logical name becomes the mesh
    axis of its first rule (None when no rule names it); a mesh axis is
    used once, by its first dim."""
    table: Dict[str, Optional[str]] = {}
    for name, axis in rules:
        table.setdefault(name, axis)
    out: List[Optional[str]] = []
    for name in logical:
        axis = table.get(name) if name is not None else None
        out.append(axis if axis not in out else None)
    return tuple(out)


def logical_axis_tree(module) -> Optional[Dict[str, Tuple[str, ...]]]:
    """The module's ``{leaf name: logical axes}`` table (its
    ``logical_axes()``), or None for a model that declares none (a ResNet),
    which then replicates."""
    fn = getattr(module, "logical_axes", None)
    return fn() if callable(fn) else None


def _is_q(x) -> bool:
    from seldon_core_tpu_torch.ops.quantize import QuantizedTensor

    return isinstance(x, QuantizedTensor)


def leaf_spec(leaf, logical: Optional[Sequence[str]], mesh, rules,
              units: Optional[Dict[str, int]] = None) -> Spec:
    """The mesh spec of one float leaf (of a quantized leaf: its ``q``):
    the rule table's axis for each dim, None where the axis does not divide
    the dim counted in ``units`` (``{logical name: elements a unit}``)."""
    if logical is None:
        return ()
    shape = tuple(leaf.shape)
    spec = list(logical_to_mesh_axes(logical, _rules_for_mesh(mesh, rules)))
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        unit = (units or {}).get(logical[i], 1)
        size = mesh.axis_size(axis)
        if shape[i] % unit or (shape[i] // unit) % size:
            spec[i] = None
    return tuple(spec)


class RankTrees(list):
    """``shard_params``' result: one ``{leaf name: tensor or
    QuantizedTensor}`` a mesh rank (rank order), plus ``specs`` ({leaf name:
    the q / float leaf's spec}) and the ``mesh``."""

    def __init__(self, trees, specs: Dict[str, Spec], mesh):
        super().__init__(trees)
        self.specs = specs
        self.mesh = mesh


def _cut(t: torch.Tensor, spec: Spec, coords: Dict[str, int], mesh) -> Tuple[torch.Tensor, tuple]:
    """(the rank's slice of ``t`` under ``spec`` as a view, its shard key)."""
    key = []
    for dim, axis in enumerate(spec):
        if axis is None or mesh.axis_size(axis) == 1:
            key.append(None)
            continue
        n = mesh.axis_size(axis)
        step = t.shape[dim] // n
        i = coords[axis]
        t = t.narrow(dim, i * step, step)
        key.append(i)
    return t, tuple(key)


def _materialize(view: torch.Tensor, device) -> torch.Tensor:
    out = torch.empty(view.shape, dtype=view.dtype, device=device)
    out.copy_(view)
    return out


@torch.no_grad()
def shard_params(params: Dict[str, Any], mesh, logical_specs: Optional[Dict[str, Sequence]],
                 rules=DEFAULT_LOGICAL_RULES, units: Optional[Dict[str, int]] = None
                 ) -> RankTrees:
    """Cut the port param tree ``params`` ({leaf name: tensor or
    QuantizedTensor}) over ``mesh``: one rank-local tree a rank, every leaf
    a contiguous tensor on the rank's device. Leaves without a spec (or all
    of them when ``logical_specs`` is None) are replicated."""
    from seldon_core_tpu_torch.ops.quantize import QuantizedTensor

    rules = tuple(rules) if rules is not None else DEFAULT_LOGICAL_RULES
    specs: Dict[str, Spec] = {}
    for name, leaf in params.items():
        logical = (logical_specs or {}).get(name)
        spec = leaf_spec(leaf, logical, mesh, rules, units)
        specs[name] = spec or (None,) * len(leaf.shape)
    shared: Dict[tuple, Any] = {}
    trees = []
    for r, dev in enumerate(mesh.rank_devices()):
        coords = mesh.coords(r)
        tree = {}
        for name, leaf in params.items():
            spec = specs[name]
            if _is_q(leaf):
                q, kq = _cut(leaf.q, spec, coords, mesh)
                scale, ks = _cut(leaf.scale, spec[-1:], coords, mesh)
                key = (name, kq, ks, str(dev))
                if key not in shared:
                    shared[key] = QuantizedTensor(_materialize(q, dev), _materialize(scale, dev),
                                                  leaf.orig_dtype)
            else:
                view, k = _cut(leaf, spec, coords, mesh)
                key = (name, k, str(dev))
                if key not in shared:
                    shared[key] = _materialize(view, dev)
            tree[name] = shared[key]
        trees.append(tree)
    return RankTrees(trees, specs, mesh)


def sharding_report(sharded: RankTrees) -> dict:
    """How many array leaves shard over an axis of size > 1 and how many are
    replicated, and which mesh axes carry shards; a quantized leaf counts
    its ``q`` and its ``scale``. The guard against a silent replication
    fallback."""
    mesh = sharded.mesh
    report = {"sharded": 0, "replicated": 0, "other": 0, "axes": set()}
    leaves = sharded[0] if len(sharded) else {}

    def visit(spec: Spec) -> None:
        axes = {a for a in spec if a is not None and mesh.axis_size(a) > 1}
        if axes:
            report["sharded"] += 1
            report["axes"] |= axes
        else:
            report["replicated"] += 1

    for name, leaf in leaves.items():
        spec = sharded.specs[name]
        visit(spec)
        if _is_q(leaf):
            visit(spec[-1:])
    return report


def check_param_axes(sharded: RankTrees, batch_axis: str = "data", strict: bool = False) -> None:
    """``shard_apply``'s guard: with a parameter axis of size > 1 (any axis
    but ``batch_axis``) and no leaf sharded over it, raise ``ValueError``
    under ``strict``, else warn — the JAX package's message."""
    mesh = sharded.mesh
    param_axes = {a for a in mesh.axis_names if a != batch_axis and mesh.axis_size(a) > 1}
    if not param_axes:
        return
    report = sharding_report(sharded)
    if not (report["axes"] & param_axes):
        msg = (
            f"mesh has parameter axes {sorted(param_axes)} but every param "
            f"leaf is replicated (report: sharded={report['sharded']} "
            f"replicated={report['replicated']}) — the logical-axis spec "
            "did not align with the param tree"
        )
        if strict:
            raise ValueError(msg)
        logger.warning(msg)


class DataSplit(nn.Module):
    """A replicated model over a mesh: the batch splits into one contiguous
    block of rows a ``batch_axis`` index (``torch.tensor_split``: the
    server's buckets make them even), each block runs the model on its
    rank (the model's own kernels at the block's shapes), and the outputs
    concatenate in order. Ranks that differ only along other axes would
    compute the same block from the same replicated weights; the controller
    runs one of them."""

    def __init__(self, module: nn.Module, mesh, apply_fn: Callable, batch_axis: str = "data"):
        super().__init__()
        self.module = module
        self.mesh = mesh
        self.apply_fn = apply_fn
        self.batch_axis = batch_axis

    def forward(self, x, **kwargs):
        n = self.mesh.axis_size(self.batch_axis)
        if n == 1:
            return self.apply_fn(self.module, x, **kwargs)
        outs = [self.apply_fn(self.module, part, **kwargs)
                for part in torch.tensor_split(x, n, dim=0) if part.shape[0]]
        return torch.cat(outs, dim=0)


def shard_apply(apply_fn: Callable, module: nn.Module, mesh, rules=None,
                batch_axis: str = "data", strict: bool = False):
    """``(run, sharded)`` for mesh execution: ``run(x)`` is
    ``apply_fn(module, x)`` with the batch split over ``batch_axis``.

    - a module that declares logical axes (``logical_axes()``) and can run
      sharded (``shard(mesh, rules)``: the transformer's rank loop) runs
      that; its params shard by the rule table;
    - any other module (a ResNet) replicates and runs ``DataSplit``;
    - ``strict=True`` raises ``ValueError`` when the mesh has a parameter
      axis (size > 1, not ``batch_axis``) over which no leaf shards: the
      replication fallback fired on a mesh meant to partition the model.
    """
    mesh.require_colocated()
    rules = tuple(rules) if rules is not None else DEFAULT_LOGICAL_RULES
    logical = logical_axis_tree(module)
    if logical is not None and callable(getattr(module, "shard", None)):
        sharded = module.shard(mesh, rules)
        check_param_axes(sharded.rank_trees, batch_axis, strict)
        return (lambda x, **kw: apply_fn(sharded, x, **kw)), sharded
    # replicated: every rank holds the module's own leaves, no copy made
    params = dict(module.named_parameters())
    specs = {n: (None,) * p.dim() for n, p in params.items()}
    check_param_axes(RankTrees([params] * mesh.size, specs, mesh), batch_axis, strict)
    return DataSplit(module, mesh, apply_fn, batch_axis), module


__all__ = ["DEFAULT_LOGICAL_RULES", "DataSplit", "RankTrees", "check_param_axes", "leaf_spec",
           "logical_axis_tree", "logical_to_mesh_axes", "shard_apply", "shard_params",
           "sharding_report"]
