"""Device meshes: the scaling substrate.

Port of ``seldon_core_tpu/parallel/mesh.py``. A ``Mesh`` names its axes
('data' replicas, 'model' tensor parallelism, 'seq' sequence parallelism,
'expert', 'pipe') and holds a ``torch.device`` array of their shape; each
entry is a rank, and a rank's coordinates are read by axis name
(:meth:`Mesh.coords`). Where the JAX package hands the mesh to GSPMD, the
port runs it as a single controller: one process and one thread drive
every rank in a loop, each rank's kernels at its shard's shapes, and the
sums GSPMD inserts are the explicit collectives of
``parallel/collectives.py``.

A mesh whose entries all name one device is *co-located* (its ranks share
the device, as ``--xla_force_host_platform_device_count`` lets the JAX
package's tests share the host). That is the only kind the port runs: a
mesh over distinct devices needs a transport between them, which waits for
two-card meshes (ROADMAP Queue A 9b); ``Mesh.require_colocated`` raises
for it before any weight moves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TWO_CARD = "two-card meshes, ROADMAP Queue A 9b"


def same_device(a, b) -> bool:
    """Device equality with an index-less "cuda" read as the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if (a.index is None or b.index is None) else 0
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def _object_array(devices: Sequence) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr


class Mesh:
    """Named axes over an array of devices (``torch.device`` entries, one
    rank an entry, row-major: the last axis varies fastest). ``shape`` is
    ``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims needs {devices.ndim} axis names, "
                             f"got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis names {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` (1 for an axis the mesh does not have)."""
        return self.shape.get(name, 1)

    def rank_devices(self) -> List[torch.device]:
        """Every rank's device, rank order (row-major over the axes)."""
        return list(self.devices.reshape(-1))

    def coords(self, rank: int) -> Dict[str, int]:
        """``{axis: index}`` of ``rank``."""
        idx = np.unravel_index(int(rank), self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The ranks partitioned by every coordinate except ``axes``: each
        group lists the ranks that differ only along ``axes``, in rank order
        (the order a collective over ``axes`` adds them in)."""
        axes = [a for a in axes if a in self.axis_names]
        by_rest: Dict[Tuple, List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            by_rest.setdefault(tuple(c[a] for a in self.axis_names if a not in axes),
                               []).append(r)
        return list(by_rest.values())

    def require_colocated(self, device=None) -> None:
        """Raise ``NotImplementedError`` for ranks on distinct devices (or
        not on ``device``, when given): the port runs co-located meshes
        only, until two-card meshes."""
        devs = self.rank_devices()
        ref = devs[0] if device is None else device
        bad = [str(d) for d in devs if not same_device(d, ref)]
        if bad:
            raise NotImplementedError(
                f"a mesh over distinct devices ({sorted(set(map(str, devs)))}) needs a "
                f"transport between them, which arrives with {TWO_CARD}; this port runs "
                f"meshes whose ranks share one device"
                + (f" (the server's {ref})" if device is not None else ""))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh with the given {axis_name: size}. Sizes of -1 are inferred
    from the device count (at most one -1). Axis order is preserved; ICI-heavy
    axes ('model', 'seq') should come last so neighboring devices serve them."""
    if devices is None:
        from seldon_core_tpu_torch.parallel.topology import get_topology

        devices = list(get_topology().devices)
    else:
        devices = list(devices)
    n = len(devices)
    sizes = dict(axes)
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {unknown}")
    known = math.prod(v for v in sizes.values() if v != -1)
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by fixed axes product {known}")
        sizes[unknown[0]] = n // known
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"Mesh axes {sizes} need {total} devices, have {n}")
    mesh_devices = _object_array(devices).reshape(*sizes.values())
    return Mesh(mesh_devices, tuple(sizes.keys()))


def serving_mesh(model_parallel: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Standard serving mesh: ('data', 'model') with tp innermost."""
    return make_mesh({"data": -1, "model": model_parallel}, devices)


class DisaggregatedMesh:
    """A serving world split into a PREFILL slice and a DECODE slice
    (DistServe/Splitwise): ``runtime/disagg.py``'s prefill workers run on the
    first, the batcher decodes on the second. Each role carries its own
    sub-mesh. Devices are ``torch.device`` entries.

    ``shared=False`` (the JAX package's rule) refuses a device object in
    both roles. The port's one-card disaggregation (``shared=True``, what
    the batcher builds when no split is given) puts the prefill workers on
    the decode device itself, one worker a prefill entry: a prefill list
    may repeat a device."""

    def __init__(self, prefill_devices: Sequence, decode_devices: Sequence,
                 shared: bool = False):
        self.prefill_devices = [d if isinstance(d, torch.device) else torch.device(d)
                                for d in prefill_devices]
        self.decode_devices = [d if isinstance(d, torch.device) else torch.device(d)
                               for d in decode_devices]
        self.prefill_topology = None  # set by attach_topology
        self.decode_topology = None
        if not self.prefill_devices or not self.decode_devices:
            raise ValueError(
                f"disaggregated mesh needs >=1 device per role, got "
                f"{len(self.prefill_devices)} prefill / "
                f"{len(self.decode_devices)} decode")
        overlap = set(map(id, self.prefill_devices)) & set(map(id, self.decode_devices))
        if overlap and not shared:
            raise ValueError(
                "prefill and decode slices overlap: a shared device would "
                "re-couple the prefill burst to decode latency — the exact "
                "interference disaggregation exists to remove")
        self.prefill = serving_mesh(devices=self.prefill_devices)
        self.decode = serving_mesh(devices=self.decode_devices)

    def attach_topology(self, topo) -> "DisaggregatedMesh":
        """Give each slice a Topology view of its own devices."""
        self.prefill_topology = topo.sub_topology(self.prefill_devices)
        self.decode_topology = topo.sub_topology(self.decode_devices)
        return self

    def __repr__(self) -> str:
        return (f"DisaggregatedMesh(prefill={len(self.prefill_devices)}, "
                f"decode={len(self.decode_devices)})")


def disaggregated_mesh(prefill_devices=1, decode_devices=0,
                       devices: Optional[Sequence] = None) -> DisaggregatedMesh:
    """Split the device world into a prefill slice and a decode slice.

    ``prefill_devices`` / ``decode_devices`` are either explicit device
    sequences or counts. With counts, the prefill slice takes devices from
    the END of the enumeration and decode from the front (0 = all the
    rest; ``multihost.partition_for_disaggregation``)."""
    if not isinstance(prefill_devices, int) and not isinstance(decode_devices, int):
        return DisaggregatedMesh(prefill_devices, decode_devices)

    from seldon_core_tpu_torch.parallel.multihost import partition_for_disaggregation

    if devices is None:
        from seldon_core_tpu_torch.parallel.topology import get_topology

        devices = list(get_topology().devices)
    else:
        devices = list(devices)
    if not isinstance(prefill_devices, int):
        pre = list(prefill_devices)
        taken = set(map(id, pre))
        rest = [d for d in devices if id(d) not in taken]
        n_dec = int(decode_devices) or len(rest)
        return DisaggregatedMesh(pre, rest[:n_dec])
    if not isinstance(decode_devices, int):
        dec = list(decode_devices)
        taken = set(map(id, dec))
        rest = [d for d in devices if id(d) not in taken]
        n_pre = int(prefill_devices) or len(rest)
        return DisaggregatedMesh(rest[-n_pre:], dec)
    n_pre = int(prefill_devices) or 1
    if n_pre >= len(devices):
        raise ValueError(
            f"prefill_devices={n_pre} leaves no decode devices out of "
            f"{len(devices)}")
    pre, dec = partition_for_disaggregation(devices, n_pre)
    if decode_devices:
        dec = dec[: int(decode_devices)]
    return DisaggregatedMesh(pre, dec)


__all__ = ["DisaggregatedMesh", "Mesh", "TWO_CARD", "disaggregated_mesh", "make_mesh",
           "same_device", "serving_mesh"]
