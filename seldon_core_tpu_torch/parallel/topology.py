"""First-class topology: the one place device/mesh/host facts live.

Port of ``seldon_core_tpu/parallel/topology.py``. ``Topology`` is the
declared device world that the servers, the batcher and the disaggregation
split consume instead of re-deriving it: the axis-name registry
(:data:`DECLARED_AXES`), the devices with their host/process layout, and
slice views (:meth:`Topology.sub_topology`).

What changes with the framework:

- :meth:`Topology.detect` reads ``torch.cuda.device_count()`` and, when a
  ``torch.distributed`` process group is initialized, its rank and world
  size (the JAX version reads ``jax.devices()``). Without a card it raises:
  the port never falls back to the CPU on its own.
- A ``Topology(devices=[...])`` built by the caller may repeat a device.
  Each entry is a rank of its own (a *virtual* device, told apart by
  identity as JAX tells its devices apart) that shares the device with the
  entries equal to it. This is the port's counterpart of
  ``--xla_force_host_platform_device_count``: the tests build meshes over
  ``["cpu"] * 8`` and the card's smoke run over ``["cuda:0"] * 2``.
- A GPU has no slices: there is no ``slice_map``, no ``slice_index``
  probe and no hybrid DCN / ICI mesh (``parallel/multihost.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import torch

from seldon_core_tpu_torch.parallel import mesh as _mesh

#: The only legal mesh axis names; :meth:`Topology.mesh` raises on others.
DECLARED_AXES: Dict[str, str] = {
    "data": "data-parallel replicas; DCN-tolerant (one sync per step)",
    "model": "tensor parallelism (GSPMD); ICI-only, innermost",
    "seq": "sequence parallelism for long context; ICI-only",
    "expert": "expert parallelism for MoE layers",
    "pipe": "pipeline stages; DCN-tolerant point-to-point handoff",
}


def _as_device(d) -> torch.device:
    """A fresh ``torch.device`` for each entry, so entries that name the
    same device stay distinct objects (distinct ranks)."""
    return torch.device(str(d)) if isinstance(d, torch.device) else torch.device(d)


@dataclass(frozen=True)
class Topology:
    """Immutable snapshot of the device world one process serves from:
    ``devices`` in enumeration order (``torch.device`` entries; a device may
    repeat, one rank an entry), ``local_devices`` those this process
    drives, and the process index and count."""

    devices: Tuple
    local_devices: Tuple = ()
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        devices = tuple(d if isinstance(d, torch.device) and not _shared(d, self.devices)
                        else _as_device(d) for d in self.devices)
        object.__setattr__(self, "devices", devices)
        if not self.local_devices:
            object.__setattr__(self, "local_devices", devices)
        else:
            ids = {id(d) for d in devices}
            local = tuple(self.local_devices)
            if not all(id(d) in ids for d in local):
                raise ValueError("local_devices must be entries of devices")
            object.__setattr__(self, "local_devices", local)

    @classmethod
    def detect(cls) -> "Topology":
        """The process topology from the CUDA runtime: one entry a card this
        process sees, and the ``torch.distributed`` rank / world when a
        process group is initialized. Raises without a card."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "Topology.detect(): torch sees no CUDA device — pass topology=Topology("
                "devices=[...]) explicitly (e.g. ['cpu'] * 8 for CPU ranks)")
        index, count = 0, 1
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            index, count = dist.get_rank(), dist.get_world_size()
        return cls(devices=tuple(torch.device("cuda", i) for i in range(n)),
                   process_index=index, process_count=count)

    def sub_topology(self, devices: Sequence) -> "Topology":
        """A view restricted to ``devices`` (entries of this topology, by
        identity): a disaggregated slice, a replica's shard."""
        devices = tuple(devices)
        unknown = set(map(id, devices)) - set(map(id, self.devices))
        if unknown:
            raise ValueError(
                f"sub_topology devices not in this topology's world "
                f"({len(unknown)} of {len(devices)} unknown)")
        local = set(map(id, self.local_devices))
        return replace(self, devices=devices,
                       local_devices=tuple(d for d in devices if id(d) in local) or devices)

    @property
    def device_count(self) -> int:
        return len(self.devices)

    def _check_axes(self, names) -> None:
        unknown = [a for a in names if a not in DECLARED_AXES]
        if unknown:
            raise ValueError(
                f"undeclared mesh axis name(s) {unknown!r}: every axis "
                f"must be registered in parallel/topology.py "
                f"DECLARED_AXES (have: {', '.join(DECLARED_AXES)})")

    def mesh(self, axes: Dict[str, int]) -> "_mesh.Mesh":
        """``make_mesh`` over this topology's devices, axis names checked
        against the declared registry."""
        self._check_axes(axes)
        return _mesh.make_mesh(axes, self.devices)

    def serving_mesh(self, model_parallel: int = 1) -> "_mesh.Mesh":
        return self.mesh({"data": -1, "model": model_parallel})

    def disaggregated(self, prefill_devices=1, decode_devices=0) -> "_mesh.DisaggregatedMesh":
        """Disaggregated prefill/decode split of this world, each slice with
        a ``Topology`` view of its own devices."""
        dm = _mesh.disaggregated_mesh(prefill_devices, decode_devices, devices=self.devices)
        dm.attach_topology(self)
        return dm

    def __repr__(self) -> str:
        return (f"Topology(devices={self.device_count}, "
                f"process={self.process_index}/{self.process_count})")


def _shared(d: torch.device, devices) -> bool:
    """True when the object ``d`` appears more than once in ``devices``:
    each repeat becomes a fresh object (a rank of its own)."""
    return sum(1 for x in devices if x is d) > 1


_TOPO_LOCK = threading.Lock()
_PROCESS_TOPOLOGY: Optional[Topology] = None


def get_topology() -> Topology:
    """The process topology, detected on first use (raises without a card);
    tests and co-located meshes install their own with :func:`set_topology`."""
    global _PROCESS_TOPOLOGY
    with _TOPO_LOCK:
        if _PROCESS_TOPOLOGY is None:
            _PROCESS_TOPOLOGY = Topology.detect()
        return _PROCESS_TOPOLOGY


def set_topology(topo: Optional[Topology]) -> Optional[Topology]:
    """Install (or with None, reset) the process topology; returns the
    previous value so callers can restore it."""
    global _PROCESS_TOPOLOGY
    with _TOPO_LOCK:
        prev = _PROCESS_TOPOLOGY
        _PROCESS_TOPOLOGY = topo
        return prev


def build_serving_mesh(device, mesh=None, topology: Optional[Topology] = None,
                       tensor_parallel: int = 1, sequence_parallel: Optional[int] = None):
    """The mesh a server serves on, built at load() before any weight moves:
    ``mesh`` as given; else, when a parallel degree is above 1, ``{"data":
    -1, "model": tp}`` over ``topology`` (default: the process topology),
    or ``{"data": -1, "seq": sp, "model": tp}`` when ``sequence_parallel``
    is given (``LLMServer``), with the JAX servers' divisibility error. Its
    ranks must share ``device`` (two-card meshes: ROADMAP Queue A 9b).
    Returns (mesh or None, topology)."""
    from seldon_core_tpu_torch.contracts.payload import SeldonError

    tp, sp = max(int(tensor_parallel), 1), max(int(sequence_parallel or 1), 1)
    if mesh is None and tp * sp > 1:
        topology = topology or get_topology()
        n = topology.device_count
        if n % (tp * sp):
            what = (f"tensor_parallel={tp}" if sequence_parallel is None
                    else f"tensor_parallel={tp} * sequence_parallel={sp}")
            raise SeldonError(f"{what} does not divide {n} available devices", status_code=500)
        mesh = (topology.serving_mesh(model_parallel=tp) if sequence_parallel is None
                else topology.mesh({"data": -1, "seq": sp, "model": tp}))
    if mesh is not None:
        mesh.require_colocated(device)
    return mesh, topology


__all__ = ["DECLARED_AXES", "Topology", "build_serving_mesh", "get_topology", "set_topology"]
