"""Ring attention: exact attention over sequence-sharded Q/K/V.

Port of ``seldon_core_tpu/ops/ring_attention.py`` (no Pallas kernel there:
einsums inside ``shard_map``, the K/V blocks rotated by ``ppermute``). Each
'seq' rank holds one block of positions; it attends its queries to one K/V
block at a time while the blocks travel the ring, and accumulates the
softmax online (running max and denominator), so the result is exact.

On a co-located mesh (``parallel/mesh.py``: every rank on one device) a
hop of the ring is a read of the neighbour's tensor, so the rotation is
rank-order indexing. The JAX package's perm ``(i -> i + 1)`` means that at
step ``t`` rank ``i`` holds block ``(i - t) mod n``; the port accumulates
in that order, since another order rounds differently. Its gradient is
autograd's through the same loop.

Numerics, as the JAX package's: the logits in float32 (the product in the
inputs' dtype, then scaled in float32), masked at ``finfo(float32).min``;
``p`` zero where a logit is at that value and the correction zero while a
row's running max still is; ``p``, the denominator and the accumulator in
float32, the denominator at least ``finfo(float32).tiny`` (a row with
nothing to attend reads zeros), the output cast once to q's dtype.

Layout: q [b, s, h, d]; k, v [b, s, hk, d] with h % hk == 0 (GQA: only the
unrepeated K/V travel the ring; q is grouped [b, s, hk, g, d]); positions
[b, s] absolute (causality across blocks is known through them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

NEG_INF = torch.finfo(torch.float32).min
TINY = torch.finfo(torch.float32).tiny


def _block_attention(q, k_blk, v_blk, q_pos, kv_pos, m, l, acc, scale: float, causal: bool):
    """One online-softmax step of local q [b, sq, hk, g, d] against one K/V
    block [b, sk, hk, d] (positions q_pos [b, sq], kv_pos [b, sk]); m, l
    [b, hk, g, sq] the running max and denominator, acc [b, sq, hk, g, d]
    the running numerator. Returns the new (m, l, acc)."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k_blk).float() * scale
    if causal:
        mask = kv_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
        logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    p = torch.where(logits <= NEG_INF, 0.0, p)
    corr = torch.where(m <= NEG_INF, 0.0, torch.exp(m - m_new))
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
        "bhgqk,bkhd->bqhgd", p, v_blk.float())
    return m_new, l_new, acc_new


def _ring_attention_local(q, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], q_pos,
                          kv_pos: Sequence[torch.Tensor], i: int, causal: bool) -> torch.Tensor:
    """Rank ``i``'s body (the JAX package's per-device function): its
    queries q [b, sq, h, d] against the ring's K/V blocks, the one of rank
    ``(i - t) mod n`` at step ``t``, accumulated online; the output in q's
    dtype. One block (n = 1) is plain attention over it."""
    n = len(ks)
    b, sq, h, d = q.shape
    hk = ks[i].shape[2]
    g = h // hk
    qg = q.reshape(b, sq, hk, g, d)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, hk, g, sq), NEG_INF, **f32)
    l = torch.zeros((b, hk, g, sq), **f32)
    acc = torch.zeros((b, sq, hk, g, d), **f32)
    for t in range(n):
        j = (i - t) % n
        m, l, acc = _block_attention(qg, ks[j], vs[j], q_pos, kv_pos[j], m, l, acc, d ** -0.5,
                                     causal)
    denom = torch.clamp(l, min=TINY).permute(0, 3, 1, 2)[..., None]
    return (acc / denom).reshape(b, sq, h, d).to(q.dtype)


def ring_attention_ranks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], q_pos: Sequence[torch.Tensor],
                         kv_pos: Sequence[torch.Tensor], causal: bool = True
                         ) -> List[torch.Tensor]:
    """The ring over one 'seq' group: one block a rank, in rank order, each
    rank's ``_ring_attention_local``. Returns each rank's output [b, sq, h,
    d] in its q's dtype."""
    return [_ring_attention_local(qs[i], ks, vs, q_pos[i], kv_pos, i, causal)
            for i in range(len(qs))]


def _split(t: torch.Tensor, dim: int, n: int, i: int, what: str) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"ring_attention: {what} of {t.shape[dim]} does not split over {n} "
                         f"ranks")
    step = t.shape[dim] // n
    return t.narrow(dim, i * step, step)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor, mesh=None,
                   seq_axis: str = "seq", batch_axis: Optional[str] = "data",
                   head_axis: Optional[str] = "model", causal: bool = True) -> torch.Tensor:
    """Exact attention of q [b, s, h, d] over k, v [b, s, hk, d] on
    ``mesh``: rows over ``batch_axis``, positions over ``seq_axis``, heads
    (query and KV alike) over ``head_axis``, each where the mesh has the
    axis; every 'seq' group runs ``ring_attention_ranks`` and the blocks are
    put back in place. Without a mesh, or on one without ``seq_axis``, it is
    one block of full attention, so callers keep one code path. The mesh
    must be co-located (``Mesh.require_colocated``)."""
    if mesh is None or seq_axis not in mesh.axis_names:
        return ring_attention_ranks([q], [k], [v], [q_positions], [kv_positions], causal)[0]
    mesh.require_colocated()
    ba = batch_axis if batch_axis in mesh.axis_names else None
    ha = head_axis if head_axis in mesh.axis_names else None
    nb, nh, ns = (mesh.axis_size(a) if a else 1 for a in (ba, ha, seq_axis))
    placed = {}
    for group in mesh.groups((seq_axis,)):
        blocks, keys = [], []
        for r in group:
            c = mesh.coords(r)
            bi, hi, si = (c[a] if a else 0 for a in (ba, ha, seq_axis))
            qr, kr, vr, qp, kp = q, k, v, q_positions, kv_positions
            if nb > 1:
                qr, kr, vr, qp, kp = (_split(t, 0, nb, bi, "batch") for t in (qr, kr, vr, qp, kp))
            if nh > 1:
                qr, kr, vr = (_split(t, 2, nh, hi, "heads") for t in (qr, kr, vr))
            qr, kr, vr, qp, kp = (_split(t, 1, ns, si, "sequence") for t in (qr, kr, vr, qp, kp))
            blocks.append((qr, kr, vr, qp, kp))
            keys.append((bi, hi, si))
        if keys[0] in placed:   # ranks that differ along another axis compute the same
            continue
        placed.update(zip(keys, ring_attention_ranks(*zip(*blocks), causal=causal)))
    return torch.cat([torch.cat([torch.cat([placed[bi, hi, si] for si in range(ns)], dim=1)
                                 for hi in range(nh)], dim=2) for bi in range(nb)], dim=0)


__all__ = ["NEG_INF", "ring_attention", "ring_attention_ranks"]
