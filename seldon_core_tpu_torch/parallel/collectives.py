"""The collectives GSPMD inserts, made explicit for the port's rank loop.

The JAX package leaves the sums of a sharded program to XLA (``psum`` /
``all_gather`` over ICI). The port's single controller drives every rank
of a co-located mesh itself (``parallel/mesh.py``), and these functions
are the sums it inserts: each takes one tensor a rank (a list in the
group's rank order) and returns one a rank.

- ``all_reduce``: the partial sums added in float32, in rank order, then
  cast once (int8 row shards hand it float32 partials): the same order
  every call, so a replay is bit-equal to its eager program, and no bf16
  rounding between partials;
- ``all_gather``: the shards concatenated along a dim (vocab-sharded
  logits, the router's expert-sharded logits);
- ``softmax_merge``: attention over a ``'seq'``-sharded cache, each rank's
  (max, sum, acc) combined by log-sum-exp.

The ranks of a co-located mesh share one device, so each collective runs
on that device as ordinary tensor work on the current stream: nothing is
read back to the host, and a CUDA graph captures it with the step. Ranks
on distinct devices never get here: the server's mesh check
(``Mesh.require_colocated``) raises first, naming two-card meshes (ROADMAP
Queue A 9b).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from seldon_core_tpu_torch.parallel.mesh import TWO_CARD, same_device


def _one_device(parts: Sequence[torch.Tensor]) -> None:
    dev = parts[0].device
    if not all(same_device(p.device, dev) for p in parts[1:]):
        raise NotImplementedError(f"a collective over ranks on distinct devices arrives with "
                                  f"{TWO_CARD}")


def all_reduce(parts: Sequence[torch.Tensor], dtype=None) -> List[torch.Tensor]:
    """The sum of one partial a rank, added in float32 in rank order and
    cast to ``dtype`` (default: the partials'); every rank gets the sum
    (ranks on one device share the one tensor)."""
    _one_device(parts)
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    out = acc.to(dtype or parts[0].dtype)
    return [out] * len(parts)


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1) -> List[torch.Tensor]:
    """The shards concatenated along ``dim`` in rank order; every rank gets
    the whole."""
    _one_device(parts)
    out = torch.cat(list(parts), dim=dim)
    return [out] * len(parts)


def softmax_partial(logits: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's share of a softmax-weighted sum over its keys: ``logits``
    [b, h, q, k] float32 (masked entries at ``finfo(float32).min``), ``v``
    [b, k, h, hd]. Returns (max [b, h, q], sum [b, h, q], acc [b, q, h, hd]),
    all float32: ``acc = exp(logits - max) @ v``."""
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def softmax_merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                  dtype: torch.dtype) -> List[torch.Tensor]:
    """Combine each rank's (max, sum, acc) of ``softmax_partial`` by
    log-sum-exp: ``sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M) l_j`` with M
    the largest max, in float32, cast to ``dtype``; every rank gets the
    result. A row every rank masked entirely reads as the mean of the
    values, as the unsharded softmax over ``finfo.min`` logits gives."""
    _one_device([p[2] for p in parts])
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    num = den = None
    for m, l, acc in parts:
        w = torch.exp(m - big)                     # [b, h, q]
        term = acc * w.transpose(1, 2)[..., None]  # [b, q, h, hd]
        num = term if num is None else num + term
        den = w * l if den is None else den + w * l
    out = (num / den.transpose(1, 2)[..., None]).to(dtype)
    return [out] * len(parts)


__all__ = ["all_gather", "all_reduce", "softmax_merge", "softmax_partial"]
