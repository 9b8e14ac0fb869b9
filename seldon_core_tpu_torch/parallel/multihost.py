"""The multi-host environment and the disaggregation split.

Port of ``seldon_core_tpu/parallel/multihost.py``'s host-side rules:
``coordinator_config`` reads the environment names the JAX package reads,
with the same errors and the same triple, and
``partition_for_disaggregation`` splits a device list into its prefill and
decode slices.

What is not here: joining the world (``initialize``), the hybrid DCN / ICI
mesh and the slice-aware split. The port runs co-located meshes only, so
no code would use a process group yet, and a GPU exposes no physical
slices; the process group comes with two-card meshes and their NCCL
transport (ROADMAP Queue A 9b). The split is therefore the JAX package's
contiguous tail split, what it does when the devices have no slices.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence


def coordinator_config(env: Optional[Dict[str, str]] = None) -> Optional[Dict[str, object]]:
    """Resolve the distributed-init triple from the environment, or None for
    single-host. Accepts the standard JAX env (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) and the common launcher spellings
    (COORDINATOR_ADDRESS, NUM_PROCESSES/WORLD_SIZE, PROCESS_ID/RANK)."""
    env = env if env is not None else dict(os.environ)

    def pick(*names: str) -> Optional[str]:
        for n in names:
            v = env.get(n)
            if v:
                return v
        return None

    addr = pick("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    if not addr:
        return None
    n = pick("JAX_NUM_PROCESSES", "NUM_PROCESSES", "WORLD_SIZE")
    pid = pick("JAX_PROCESS_ID", "PROCESS_ID", "RANK")
    if n is None or pid is None:
        raise ValueError(
            "coordinator address set but process count/id missing: need "
            "JAX_NUM_PROCESSES (or WORLD_SIZE) and JAX_PROCESS_ID (or RANK)"
        )
    return {
        "coordinator_address": addr,
        "num_processes": int(n),
        "process_id": int(pid),
    }


def partition_for_disaggregation(devices: Sequence, prefill_count: int):
    """Split ``devices`` into (prefill, decode) slices for disaggregated
    serving: the prefill slice is the contiguous tail of ``prefill_count``
    devices, the decode slice the rest."""
    devices = list(devices)
    n = int(prefill_count)
    if not (0 < n < len(devices)):
        raise ValueError(
            f"prefill_count={n} must leave >=1 decode device out of "
            f"{len(devices)}")
    return devices[-n:], devices[:-n]


__all__ = ["coordinator_config", "partition_for_disaggregation"]
