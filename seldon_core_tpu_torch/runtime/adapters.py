"""Batched LoRA adapters: many tenants' low-rank deltas in one pool of
device tensors, applied inside the shared decode, prefill-chunk and verify
programs. The port of ``seldon_core_tpu/runtime/adapters.py``, with its
names and rules:

- **row 0 is the identity.** Its factors are zeros and its scale 0, so
  untenanted traffic runs the same program with an exact-zero delta
  (``q + ((x @ 0) @ 0) * 0`` is ``q`` bitwise): one program serves base
  and adapted traffic.
- **q, o and the FFN projections only, never K or V**
  (``ADAPTED_PROJECTIONS``): the KV written from a hidden state is the base
  model's for every tenant, so one paged pool holds every tenant's cache.
  An adapter carrying k/v factors is refused at load.
- **one rank a pool** (the gather is dense).
- **refcounted rows.** A request pins its adapter from submit
  (``resolve_and_pin``) until its slot is released (``unpin``); ``evict``
  refuses while pinned, and a reload of a pinned adapter raises.

What changes with the framework: the pool's addresses are CAPTURED. The
JAX package swaps in fresh pool arrays at every load, so a step already
dispatched keeps reading valid arrays. The port's batcher replays CUDA
graphs that hold the pool's addresses, so the pool is one set of tensors,
allocated once (``A [N, L, d_in, r]`` and ``B [N, L, r, d_out]`` per
projection in the compute dtype, ``scale [N]`` float32), and ``load`` /
``evict`` write a row IN PLACE. That is safe because a row being written
is one no live slot gathers: a pinned adapter is neither reloaded nor
evicted, a free row is gathered by no slot, and a released slot's id goes
back to 0. The write is ordered before the first dispatch that can gather
the row: ``load`` synchronises its stream before the name resolves, so no
request can pin the row until its values are on the device.

Over a mesh (``models/sharded.py``) the pool stays one set of tensors on
the server's device: each rank reads views of it (B's columns of a
column-parallel projection, A's rows of a row-parallel one), so a row
written in place reaches every rank's captured graphs, and the pins are
the pool's as without a mesh.

Every public method takes ``self._lock``: loads and evicts come from
transport threads, pins from ``submit`` and the batcher's loop, ``stats``
from scrapes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["AdapterRegistry", "ADAPTED_PROJECTIONS", "FORBIDDEN_PROJECTIONS",
           "IDENTITY_ADAPTER_ID", "DEFAULT_LORA_RANK", "projection_dims"]

# The adapted projections, by base-weight name: attention q and o plus the
# three SwiGLU FFN matrices. K and V are deliberately absent (module
# docstring); load() rejects factors for them by name.
ADAPTED_PROJECTIONS = ("wq", "wo", "w1", "w2", "w3")
FORBIDDEN_PROJECTIONS = ("wk", "wv")

IDENTITY_ADAPTER_ID = 0
DEFAULT_LORA_RANK = 8


def projection_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) per adapted projection of a TransformerConfig: the one
    place the pool's shapes come from."""
    attn = cfg.n_heads * cfg.head_dim
    return {
        "wq": (cfg.dim, attn),
        "wo": (attn, cfg.dim),
        "w1": (cfg.dim, cfg.ffn_dim),
        "w2": (cfg.ffn_dim, cfg.dim),
        "w3": (cfg.dim, cfg.ffn_dim),
    }


class _AdapterMeta:
    __slots__ = ("name", "row", "alpha", "pins")

    def __init__(self, name: str, row: int, alpha: float):
        self.name = name
        self.row = row
        self.alpha = alpha
        self.pins = 0  # live requests referencing this adapter


class AdapterRegistry:
    """``cfg`` is the model's TransformerConfig (the pool's shapes derive
    from it), ``rank`` the pool's one rank, ``max_adapters`` its row count
    INCLUDING the identity row 0, ``dtype`` the factors' dtype (default the
    compute dtype) and ``device`` where the pool lives."""

    def __init__(self, cfg, rank: int, max_adapters: int = 8, dtype: Optional[Any] = None,
                 device: Optional[Any] = None):
        from seldon_core_tpu_torch.device import resolve_device
        from seldon_core_tpu_torch.models.transformer import to_torch_dtype

        if rank < 1:
            raise ValueError(f"lora_rank={rank} must be >= 1")
        if max_adapters < 2:
            raise ValueError(
                f"lora_max_adapters={max_adapters} must be >= 2 (row 0 is "
                f"the reserved identity adapter)")
        self.cfg = cfg
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.n_layers = int(cfg.n_layers)
        self.dtype = to_torch_dtype(dtype if dtype is not None else cfg.dtype)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._dims = projection_dims(cfg)
        N, L, r = self.max_adapters, self.n_layers, self.rank
        pool: Dict[str, Any] = {}
        for proj, (din, dout) in self._dims.items():
            pool[proj] = (torch.zeros((N, L, din, r), dtype=self.dtype, device=self.device),
                          torch.zeros((N, L, r, dout), dtype=self.dtype, device=self.device))
        pool["scale"] = torch.zeros((N,), dtype=torch.float32, device=self.device)
        self._pool = pool
        self._by_name: Dict[str, _AdapterMeta] = {}
        self._by_row: Dict[int, _AdapterMeta] = {}
        self._free_rows: List[int] = list(range(self.max_adapters - 1, 0, -1))
        self.evictions_total = 0
        self.loads_total = 0
        self._pool_bytes = sum(t.numel() * t.element_size() for t in self._leaves())

    def _leaves(self) -> List[torch.Tensor]:
        return [t for v in self._pool.values() for t in (v if isinstance(v, tuple) else (v,))]

    # ------------------------------------------------------------------
    # validation (shared by load / load_uri)
    # ------------------------------------------------------------------
    def _validate(self, name: str, weights: Dict[str, Any], rank: int):
        if not name:
            raise ValueError("adapter name must be non-empty (row 0 is the "
                             "reserved identity adapter)")
        if rank != self.rank:
            raise ValueError(
                f"adapter {name!r} rank {rank} != pool rank {self.rank}: "
                f"one dense pool holds one rank (size the pool for the "
                f"largest adapter and zero-pad smaller ones offline)")
        for proj in weights:
            base = proj.lower()
            if base in FORBIDDEN_PROJECTIONS or base.startswith(("wk", "wv")):
                raise ValueError(
                    f"adapter {name!r} carries factors for {proj!r}: k/v "
                    f"projections are never adapted — adapting them would "
                    f"fork the KV cache per tenant and break cross-tenant "
                    f"page/prefix sharing (the KV-purity invariant)")
            if base not in self._dims:
                raise ValueError(
                    f"adapter {name!r} names unknown projection {proj!r}: "
                    f"expected a subset of {ADAPTED_PROJECTIONS}")
        L, r = self.n_layers, self.rank
        for proj, (a, b) in weights.items():
            din, dout = self._dims[proj]
            a = np.asarray(a)
            b = np.asarray(b)
            if a.shape != (L, din, r) or b.shape != (L, r, dout):
                raise ValueError(
                    f"adapter {name!r} {proj} factors have shapes "
                    f"{a.shape}/{b.shape}; expected A {(L, din, r)} and "
                    f"B {(L, r, dout)} for this model config")

    def _sync(self) -> None:
        """Order the row writes before anything the caller does next: the
        name resolves only after its values are on the device."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------------------
    # load / evict
    # ------------------------------------------------------------------
    def load(self, name: str, weights: Dict[str, Any], alpha: Optional[float] = None,
             rank: Optional[int] = None) -> int:
        """Load (or replace) adapter ``name`` from in-memory factors ``{proj:
        (A [L, d_in, r], B [L, r, d_out])}``, a subset of
        ADAPTED_PROJECTIONS (missing projections contribute zero delta),
        into its pool row in place. Returns the adapter id (the row).
        Replacing a PINNED adapter raises: a live slot's gather must never
        change under it."""
        alpha = float(alpha if alpha is not None else self.rank)
        self._validate(name, weights, int(rank or self.rank))
        with self._lock:
            meta = self._by_name.get(name)
            if meta is not None and meta.pins > 0:
                raise ValueError(
                    f"adapter {name!r} is pinned by {meta.pins} live "
                    f"slot(s); a reload would change an in-flight "
                    f"request's weights mid-generation")
            if meta is None:
                if not self._free_rows:
                    raise ValueError(
                        f"adapter pool full ({self.max_adapters - 1} rows "
                        f"+ identity); evict an unpinned adapter first")
                meta = _AdapterMeta(name, self._free_rows.pop(), alpha)
                self._by_name[name] = meta
                self._by_row[meta.row] = meta
            meta.alpha = alpha
            row = meta.row
            for proj in self._dims:
                A, B = self._pool[proj]
                if proj in weights:
                    for dst, src in zip((A, B), weights[proj]):
                        host = torch.from_numpy(np.asarray(src, np.float32)).to(self.dtype)
                        dst[row].copy_(host)
                else:
                    A[row].zero_()
                    B[row].zero_()
            self._pool["scale"][row] = alpha / self.rank
            self._sync()
            self.loads_total += 1
            logger.info("loaded adapter %r into pool row %d (alpha=%s)", name, row, alpha)
            return row

    def load_uri(self, name: str, uri: str) -> int:
        """Fetch an adapter artifact through the storage layer and load it:
        a directory holding ``adapter.json`` ({"rank": r, "alpha": a}) and
        ``weights.npz`` with ``<proj>.A`` / ``<proj>.B`` arrays."""
        from seldon_core_tpu_torch import storage

        path = storage.download(uri)
        with open(os.path.join(path, "adapter.json")) as f:
            meta = json.load(f)
        blob = np.load(os.path.join(path, "weights.npz"))
        weights: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for key in blob.files:
            proj, _, part = key.rpartition(".")
            if part not in ("A", "B"):
                raise ValueError(
                    f"adapter {name!r} weights.npz key {key!r} must end in "
                    f".A or .B")
            a, b = weights.get(proj, (None, None))
            if part == "A":
                weights[proj] = (blob[key], b)
            else:
                weights[proj] = (a, blob[key])
        for proj, (a, b) in weights.items():
            if a is None or b is None:
                raise ValueError(
                    f"adapter {name!r} projection {proj!r} needs both "
                    f"{proj}.A and {proj}.B in weights.npz")
        return self.load(name, weights, alpha=meta.get("alpha"),
                         rank=int(meta.get("rank", self.rank)))

    def evict(self, name: str) -> bool:
        """Free adapter ``name``'s pool row for reuse. Returns False, and
        frees NOTHING, while any live request pins it. The row is zeroed in
        place, so a stale id gathered by mistake reads as the identity,
        never as another tenant's weights."""
        with self._lock:
            meta = self._by_name.get(name)
            if meta is None:
                return False
            if meta.pins > 0:
                return False
            del self._by_name[name]
            del self._by_row[meta.row]
            for proj in self._dims:
                A, B = self._pool[proj]
                A[meta.row].zero_()
                B[meta.row].zero_()
            self._pool["scale"][meta.row] = 0.0
            self._sync()
            self._free_rows.append(meta.row)
            self.evictions_total += 1
            logger.info("evicted adapter %r (pool row %d freed)", name, meta.row)
            return True

    # ------------------------------------------------------------------
    # serving-path surface
    # ------------------------------------------------------------------
    def resolve(self, name: Optional[str]) -> int:
        """Adapter id for ``name`` (None/"" = the identity adapter). Raises
        KeyError on an unknown name: the transport maps it to a 400, never
        a silent base-model fallback."""
        if not name:
            return IDENTITY_ADAPTER_ID
        with self._lock:
            meta = self._by_name.get(name)
            if meta is None:
                raise KeyError(
                    f"unknown adapter {name!r}: load it first "
                    f"(loaded: {sorted(self._by_name)})")
            return meta.row

    def resolve_and_pin(self, name: Optional[str]) -> int:
        """``resolve`` + ``pin`` under ONE lock hold, the admission path's
        entry point: the name either maps to its live row, pinned before the
        lock drops (no evict can slip in between), or raises KeyError."""
        if not name:
            return IDENTITY_ADAPTER_ID
        with self._lock:
            meta = self._by_name.get(name)
            if meta is None:
                raise KeyError(
                    f"unknown adapter {name!r}: load it first "
                    f"(loaded: {sorted(self._by_name)})")
            meta.pins += 1
            return meta.row

    def pin(self, adapter_id: int) -> None:
        """One more live reference to ``adapter_id``. Identity pins are
        no-ops; pinning a freed row raises."""
        if adapter_id == IDENTITY_ADAPTER_ID:
            return
        with self._lock:
            meta = self._by_row.get(adapter_id)
            if meta is None:
                raise KeyError(f"adapter id {adapter_id} is not loaded")
            meta.pins += 1

    def unpin(self, adapter_id: int) -> None:
        if adapter_id == IDENTITY_ADAPTER_ID:
            return
        with self._lock:
            meta = self._by_row.get(adapter_id)
            if meta is None or meta.pins <= 0:
                raise ValueError(
                    f"unbalanced unpin of adapter id {adapter_id}")
            meta.pins -= 1

    def pool(self) -> Dict[str, Any]:
        """The pool ({proj: (A, B), "scale": [N]}): the same tensors for
        the registry's life, written in place (module docstring)."""
        return self._pool

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._by_name)

    def refs_of(self, name: str) -> int:
        with self._lock:
            meta = self._by_name.get(name)
            return 0 if meta is None else meta.pins

    def stats(self) -> Dict[str, Any]:
        """One consistent snapshot for ``llm_stats`` -> /metrics
        (``seldon_llm_adapter_{loaded,evictions_total,pool_bytes}``)."""
        with self._lock:
            return {
                "adapter_loaded": len(self._by_name),
                "adapter_capacity": self.max_adapters - 1,
                "adapter_evictions_total": self.evictions_total,
                "adapter_loads_total": self.loads_total,
                "adapter_pool_bytes": self._pool_bytes,
                "adapter_rank": self.rank,
                "adapter_pins": {m.name: m.pins for m in self._by_name.values()},
            }
