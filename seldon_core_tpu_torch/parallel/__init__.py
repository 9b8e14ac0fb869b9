"""Meshes, sharding and the multi-host bootstrap: the port of
``seldon_core_tpu/parallel`` (topology, mesh, multihost, sharding), the
explicit collectives of the single-controller rank loop (``collectives``),
and training over a co-located mesh (``train``: the sharded train step,
AdamW / Adam, checkpoints; ``pipeline``: the GPipe schedule over 'pipe';
ring attention is ``ops/ring_attention.py``). Ranks on distinct devices
wait for ROADMAP Queue A 9b; ``compat`` (JAX version shims for
``shard_map`` / ``axis_size``) has nothing to port."""

from seldon_core_tpu_torch.parallel.mesh import Mesh, make_mesh
from seldon_core_tpu_torch.parallel.sharding import (
    DEFAULT_LOGICAL_RULES,
    shard_apply,
    shard_params,
)
from seldon_core_tpu_torch.parallel.topology import (
    DECLARED_AXES,
    Topology,
    get_topology,
    set_topology,
)

__all__ = [
    "DECLARED_AXES",
    "DEFAULT_LOGICAL_RULES",
    "Mesh",
    "Topology",
    "get_topology",
    "make_mesh",
    "set_topology",
    "shard_apply",
    "shard_params",
]
