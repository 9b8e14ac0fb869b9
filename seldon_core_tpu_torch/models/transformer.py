"""Decoder-only transformer (Llama family) in PyTorch.

Port of ``seldon_core_tpu/models/transformer.py``. The weight layout is the
JAX package's: every projection is stored ``[in, out]`` and applied as
``x @ w``, parameters are stored in float32 (flax's default) and cast to the
compute dtype at each use, and module/parameter names follow the flax tree
(``layer_0.attention.wq``), so ``models/convert.py`` maps a JAX checkpoint
onto ``state_dict`` keys one to one.

What changes with the framework:

- KV caches are updated IN PLACE. The JAX package donated the cache buffers
  to each jitted step so XLA aliased them; here the write sites index-assign
  into the cache tensors and return the same tuples.
- The paged decode read (``s == 1`` with block tables) goes through
  ``ops/paged_attention.py``: the hand-written CUDA kernel on a card, its
  plain PyTorch version on the CPU. So does the speculative verify
  (``verify=True``: s = K+1 columns a sequence), its columns folded into
  rows of one call. A prefill chunk (``s > 1``) is the plain masked
  matmul + softmax over the gathered view, as the JAX package leaves it to
  XLA.
- The dense batcher's slot pool (``SlotCaches``) ends each row in a trash
  column: PyTorch has no dropping scatter, so a per-sequence write the JAX
  package drops (``mode="drop"``: past the row, or a PAD_POS column) lands
  there with position PAD_POS (``write_dense``).
- ``fused_norm=True`` routes each block's residual add + ffn RMSNorm through
  ``ops/fused_norm.py`` (a CUDA C++ kernel on a card, ``csrc/fused_norm.cu``).
- int8 KV caches (``kv_cache_dtype="int8"``) are the JAX package's 5-tuple
  (k_q, k_scale, v_q, v_scale, pos): quantize on write, dequantize in the
  model dtype on the plain read; the paged decode read dequantizes in
  float32 inside the kernel.
- Weight-only int8 (``Transformer.quantize_``): every projection and the
  lm_head become ``ops/quantize.QuantizedTensor`` modules and go through
  ``quantized_matmul`` — the W8A16 GEMM kernel on a card — where the JAX
  package left the dequantizing matmul to XLA's fusion.
- Batched LoRA (``adapters`` + ``adapter_ids``, the pool of
  ``runtime/adapters.py``): ``lora_delta`` gathers each sequence's factors
  and runs a ``torch.bmm`` pair, as the JAX package's einsum pair (no Pallas
  kernel there either). The delta is added after the base product (K4 for
  an int8 weight), in the compute dtype, on q, o and the FFN projections.
- MoE FFNs (``n_experts > 0``, ``MoEFFN``): the JAX package's dense
  formulation, every expert over every token. Its einsums become one
  batched product a projection over the expert axis (cuBLAS) for float
  weights, and one int8 GEMM launch an expert a projection for int8 ones.

A mesh (``parallel/mesh.py``) shards the filled model through
``Transformer.shard`` (``models/sharded.py``: every rank's heads, ffn
columns, vocab and experts, run by one controller; the table of logical
axes is ``Transformer.logical_axes``).

Training: the parameters are built with ``requires_grad=False``, so serving
holds no gradient state; ``parallel/train.py`` turns them on. The
cache-less forward returns float32 logits at every position, as the JAX
package's ``module.apply(params, tokens)``; with ``attention_impl="ring"``
it attends through ``ops/ring_attention.py`` (one block unsharded; the ring
over a 'seq' mesh in ``models/sharded.py``). A call that passes a KV cache
reads the cache as before, whichever ``attention_impl`` is set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.registry import register_model
from seldon_core_tpu_torch.ops import int8_matmul as k4
from seldon_core_tpu_torch.ops.quantize import (QuantizedTensor, _is_quantizable,
                                                dequantize_array, quantize_array,
                                                quantize_into_, quantized_matmul)

# Sentinel position for empty/padded cache slots and padded prompt tokens:
# larger than any real position, so causal masks (key_pos <= query_pos)
# exclude them; small enough that rotary angles stay finite.
PAD_POS = 1 << 28

KV_CACHE_DTYPES = ("bf16", "int8")
KV_CACHE_LAYOUTS = ("dense", "paged")

# Reserved page ids in every paged pool. NULL_PAGE backs unallocated
# block-table tail entries: its position row is PAD_POS forever (writes
# through a NULL entry are redirected), so gathering it always reads as
# "masked, never attended". TRASH_PAGE absorbs garbage writes — inactive
# batcher slots ride along in the fixed-shape decode step, and their stale
# writes must land somewhere no live block table points.
NULL_PAGE = 0
TRASH_PAGE = 1
RESERVED_PAGES = 2

_KV_QMAX = 127

_DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "f32": torch.float32,
    "float16": torch.float16, "f16": torch.float16,
}


def to_torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype for a dtype name ("bfloat16", "float32", ...) or dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype))
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def normalize_kv_cache_dtype(value) -> str:
    """Canonical kv_cache_dtype ("bf16" or "int8"); raises ValueError on
    anything else so misconfiguration fails at load() time."""
    v = str(value or "bf16").strip().lower()
    if v in ("bf16", "bfloat16", "model", "default"):
        return "bf16"
    if v == "int8":
        return "int8"
    raise ValueError(
        f"unknown kv_cache_dtype {value!r}: expected one of {KV_CACHE_DTYPES}"
    )


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last (head_dim) axis:
    x [..., hd] float -> (q int8 [..., hd], scale float32 [...]). One scale
    per head per position; zero vectors get scale 1 (dequantize to exact
    zeros). ``torch.round`` rounds half to even, as ``jnp.round`` does, so
    the codes are bit-equal to the JAX package's. Written in few ops: on
    the card each is a launch on the decode step's host-bound path."""
    x32 = x.float()
    amax = torch.linalg.vector_norm(x32, ord=float("inf"), dim=-1)   # max |x|
    scale = torch.where(amax > 0, amax / _KV_QMAX, 1.0)
    q = (x32 / scale[..., None]).round_().clamp_(-128, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of quantize_kv in ``dtype``: both operands cast, then
    multiplied, as the JAX package does."""
    return q.to(dtype) * scale[..., None].to(dtype)


def normalize_kv_cache_layout(value) -> str:
    """Canonical kv_cache_layout ("dense" or "paged"); raises ValueError on
    anything else so misconfiguration fails at load() time."""
    v = str(value or "paged").strip().lower()
    if v in ("paged", "page", "block"):
        return "paged"
    if v in ("dense", "slot", "flat"):
        return "dense"
    raise ValueError(
        f"unknown kv_cache_layout {value!r}: expected one of {KV_CACHE_LAYOUTS}"
    )


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    # Llama-3.x frequency rescaling: tuple of (key, value) pairs with
    # factor / low_freq_factor / high_freq_factor /
    # original_max_position_embeddings; None = plain RoPE.
    rope_scaling: Any = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Llama-2 uses an untied lm_head; tie only for small/test configs.
    tie_embeddings: bool = False
    n_experts: int = 0
    n_experts_per_token: int = 2
    attention_impl: str = "full"
    kv_cache_dtype: str = "bf16"
    # Fuse each block's residual-add + ffn RMSNorm into one kernel pass
    # (ops/fused_norm.py).
    fused_norm: bool = False
    mesh: Any = None
    # a rank-local config's head width (its n_heads is the rank's share);
    # 0 = dim // n_heads
    attn_head_dim: int = 0
    # a rank-local config: int8 row-parallel products (wo, w2, the experts'
    # w2 and their combine) write float32 partials, which the sharded
    # model's all-reduce sums in float32 before the one rounding
    f32_partials: bool = False

    @property
    def head_dim(self) -> int:
        return self.attn_head_dim or self.dim // self.n_heads


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (norm * weight).to(x.dtype)


def _llama3_scaled_freqs(freqs: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Llama-3.1 frequency rescaling: low-frequency bands divide by
    ``factor``, high-frequency bands pass through, the middle band
    interpolates."""
    factor = float(scaling["factor"])
    lo = float(scaling["low_freq_factor"])
    hi = float(scaling["high_freq_factor"])
    old_len = float(scaling["original_max_position_embeddings"])

    wavelen = 2.0 * math.pi / freqs
    scaled = torch.where(wavelen > old_len / lo, freqs / factor, freqs)
    smooth = (old_len / wavelen - lo) / (hi - lo)
    smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
    is_medium = (wavelen >= old_len / hi) & (wavelen <= old_len / lo)
    return torch.where(is_medium, smoothed, scaled)


def rotary_embedding(
    positions: torch.Tensor, head_dim: int, theta: float, rope_scaling=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given absolute positions: [..., seq, head_dim/2]."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exponents)
    if rope_scaling:
        freqs = _llama3_scaled_freqs(freqs, dict(rope_scaling))
    angles = positions.float()[..., None] * freqs  # [..., seq, hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [batch, seq, heads, head_dim]; cos/sin: [batch, seq, head_dim/2]."""
    cos = cos[:, :, None, :]  # broadcast over heads
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def _param(shape: Sequence[int], dtype: torch.dtype, device) -> nn.Parameter:
    """Uninitialized parameter: values come from ``Transformer.init_params``
    (random) or ``load_state_dict`` (converted weights)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param((dim,), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def paged_write_targets(block_tables: torch.Tensor, positions: torch.Tensor,
                        page_size: int, stride: int = 1,
                        offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) pool coordinates for writing each token's KV.

    ``block_tables``: [b, n_pages] page ids; ``positions``: [b, s] absolute
    token positions (PAD_POS for padding). Tokens whose position falls past
    the table, or whose table entry is NULL_PAGE, are redirected to
    TRASH_PAGE: the null page's PAD_POS position row is an invariant no
    write may break. ``stride`` / ``offset``: the table of one 'seq' rank
    (``models/sharded.py``), whose entry i is the sequence's page ``offset
    + i * stride``; a token on another rank's page goes to TRASH_PAGE.
    Returns int64 index tensors."""
    p = positions.long()
    bt = block_tables.long()
    n_pages = bt.shape[1]
    page_idx = torch.div(p, page_size, rounding_mode="floor")
    valid = p >= 0
    if stride > 1:
        valid = valid & (torch.remainder(page_idx, stride) == offset)
        page_idx = torch.div(page_idx, stride, rounding_mode="floor")
    valid = valid & (page_idx < n_pages)
    entry = torch.gather(bt, 1, page_idx.clamp(0, n_pages - 1))
    entry = torch.where(valid & (entry != NULL_PAGE), entry,
                        torch.full_like(entry, TRASH_PAGE))
    return entry, torch.remainder(p, page_size)


def gather_paged_view(cache, block_tables: torch.Tensor, dtype: torch.dtype):
    """Gather a paged pool back into the per-sequence logical view:
    (k_all, v_all, pos_view) of [b, n_pages*page_size, kvh, hd] / [b, L].

    The one copy of the block-table read semantics: the attention read below
    and ``ops/paged_attention.py``'s plain version (the CUDA kernel's parity
    oracle) both address the pool through this gather. An int8 pool
    (5-tuple) is dequantized here in ``dtype``, as the JAX package does, so
    the view feeds the same read as the dense layout's."""
    bt = block_tables.long()
    b = bt.shape[0]
    ps = cache[0].shape[1]
    L = bt.shape[1] * ps
    kvh, hd = cache[0].shape[2], cache[0].shape[3]
    if len(cache) == 5:
        kq_pool, ks_pool, vq_pool, vs_pool, pos_pool = cache
        k_all = dequantize_kv(kq_pool[bt].reshape(b, L, kvh, hd),
                              ks_pool[bt].reshape(b, L, kvh), dtype)
        v_all = dequantize_kv(vq_pool[bt].reshape(b, L, kvh, hd),
                              vs_pool[bt].reshape(b, L, kvh), dtype)
    else:
        k_pool, v_pool, pos_pool = cache
        k_all = k_pool[bt].reshape(b, L, kvh, hd)
        v_all = v_pool[bt].reshape(b, L, kvh, hd)
    return k_all, v_all, pos_pool[bt].reshape(b, L)


def dense_view(cache, dtype):
    """(k_all, v_all) of a dense cache: the buffers themselves, or an int8
    cache dequantized in ``dtype``."""
    if len(cache) == 5:
        kq, ks, vq, vs, _ = cache
        return dequantize_kv(kq, ks, dtype), dequantize_kv(vq, vs, dtype)
    return cache[0], cache[1]


def matmul(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in ``dtype``, the one product every projection and the
    lm_head go through: a float weight is cast to ``dtype``; a
    ``QuantizedTensor`` goes through ``quantized_matmul`` (the int8 GEMM
    kernel on a card, float32 accumulation, output in ``dtype``)."""
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w, dtype)
    return x.to(dtype) @ w.to(dtype)


def tied_int8_logits_ref(x: torch.Tensor, emb: QuantizedTensor) -> torch.Tensor:
    """Plain version of a tied head over int8 embeddings ``emb`` [vocab,
    dim] (scale [dim], on K of the head): float32 ``x.float() @
    dequantize(emb).float().t()``."""
    return x.float() @ dequantize_array(emb).float().t()


def tied_int8_logits(x: torch.Tensor, emb: QuantizedTensor, head_t) -> torch.Tensor:
    """float32 logits of a tied head over int8 embeddings. The head is
    ``[dim, vocab]`` with its scale on K, which K4 (one scale a column of
    N) does not take, so the card reads ``head_t``: the transposed int8
    codes [dim, vocab] and a scale of ones [vocab] (``Transformer.
    prepare_head_``), with the K scale folded into the activations. ``x *
    scale`` in float32 is split into a bf16 head and the bf16 rounding of
    its remainder, both as rows of one K4 launch (2M rows, float32 out),
    and the two halves summed: the products keep about 16 bits of the
    float32 ``x * scale``, inside K4's float32 summation tolerance of the
    plain version. CPU tensors take ``tied_int8_logits_ref``."""
    if x.device.type == "cpu":
        return tied_int8_logits_ref(x, emb)
    if head_t is None:
        raise RuntimeError("a tied int8 head on the card reads the transposed copy "
                           "Transformer.prepare_head_() makes once the weights are in")
    lead = x.shape[:-1]
    xs = x.reshape(-1, x.shape[-1]).float() * emb.scale.float()
    hi = xs.to(torch.bfloat16)
    lo = (xs - hi.float()).to(torch.bfloat16)
    m = hi.shape[0]
    out = k4.int8_matmul(torch.cat([hi, lo]), head_t[0], head_t[1], torch.float32)
    return (out[:m] + out[m:]).reshape(*lead, -1)


def _partial_dtype(cfg: TransformerConfig, w) -> torch.dtype:
    """The dtype a row-parallel product (``wo``, ``w2``) writes: float32 for
    an int8 weight of a rank-local config with ``f32_partials`` (K4 writes
    float32 at no extra cost), else the compute dtype."""
    return torch.float32 if cfg.f32_partials and isinstance(w, QuantizedTensor) else cfg.dtype


def attention_logits(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first half of ``masked_attention``: the masked float32 logits
    [b, h, s, L] and ``v_all`` with its heads repeated up to the query
    heads (a sharded cache's ranks stop here and merge their ranges,
    ``models/sharded.py``)."""
    dt = q.dtype
    h, hd = q.shape[2], q.shape[3]
    kvh = k_all.shape[2]
    if kvh != h:
        rep = h // kvh
        k_all = torch.repeat_interleave(k_all, rep, dim=2)
        v_all = torch.repeat_interleave(v_all, rep, dim=2)
    scale = hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_all.to(dt)) * scale
    logits = logits.float()
    return logits.masked_fill(~mask[:, None, :, :], torch.finfo(torch.float32).min), v_all


def masked_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The plain attention read every layout shares: q [b, s, h, hd],
    k_all/v_all [b, L, kvh, hd], mask [b, s, L] (True = attend). GQA repeats
    each kv head up to its group of query heads; logits are scaled in the
    model dtype, masked with ``finfo(float32).min`` (never -inf, so a row
    with nothing to attend stays finite), softmaxed in float32 and cast back
    — the op order of the JAX package's einsum chain."""
    dt = q.dtype
    logits, v_all = attention_logits(q, k_all, v_all, mask)
    probs = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_all.to(dt))


def cache_values(cache, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor) -> tuple:
    """What each buffer of ``cache`` stores for this call's tokens: (k, v,
    positions), or for the int8 layout K and V quantized on write (per
    head, per position) with their scales."""
    if len(cache) == 5:
        (kq, vq), (ks, vs) = quantize_kv(torch.stack((k, v)))
        return (kq, ks, vq, vs, positions)
    return (k, v, positions)


class SlotCaches(list):
    """Dense caches whose rows end in a trash column: the batcher's dense
    slot pool (``init_slot_caches``: one layer tuple a layer, ``[slots,
    width + 1, ...]``) and its row views (``Transformer.slot_rows``). A row
    holds positions ``[0, width)`` in its first ``width`` columns; a
    per-sequence write (``write_dense`` with a tensor ``cache_index``) of a
    token outside them lands in column ``width`` with position PAD_POS,
    where the JAX package drops it (``mode="drop"``): a free slot that
    steps past its row, or a verify's PAD_POS column, writes nothing a
    query attends."""

    def __init__(self, layers, width: int):
        super().__init__(layers)
        self.width = int(width)


def _per_sequence_columns(idx: torch.Tensor, lo: int, n: int, total: int) -> torch.Tensor:
    """Local columns of the absolute cache slots ``idx`` in a buffer that
    holds slots ``[lo, lo + n)`` in its first ``n`` columns and a trash
    column ``n``: a slot outside that range or outside ``[0, total)`` goes
    to the trash column."""
    at = idx - lo
    keep = (idx >= 0) & (idx < total) & (at >= 0) & (at < n)
    return torch.where(keep, at, n)


def write_dense(cache, values, cache_index, lo: int = 0, total: Optional[int] = None,
                trash: bool = False) -> None:
    """Write ``values`` (``cache_values``) into a dense cache in place (the
    JAX package donated the cache to the step). ``cache_index`` is an int
    (the same offset for the whole batch, clamped as
    ``lax.dynamic_update_slice`` clamps; a prefill) or a [b] tensor
    (per-sequence: with s == 1 each row's write offset, a decode; with s >
    1 each token is written at its own position, a speculative verify, as
    the JAX package's scatter does). ``lo`` / ``total``: the cache holds
    positions [lo, lo + its length) of a cache of ``total`` positions (a
    'seq' rank's range, ``models/sharded.py``); the tokens whose slot falls
    outside it are not written.

    ``trash``: the buffer's last column is a trash column (a
    ``SlotCaches`` pool, each 'seq' rank's buffer its own): it holds the
    positions before it, and a per-sequence token outside them, or outside
    ``[0, total)``, is written there with position PAD_POS, in one scatter.
    Without one, a per-sequence write of s > 1 tokens writes column by
    column, each token clamped into the range and written only where it
    belongs there (a clamped token writes back what it read), which keeps
    the JAX package's dropping scatter without a trash column."""
    span = cache[-1].shape[1]
    n = span - 1 if trash else span
    total = n if total is None else int(total)
    b, s = values[-1].shape[:2]
    if not torch.is_tensor(cache_index) or cache_index.dim() == 0:
        start = max(0, min(int(cache_index), total - s))
        a, e = max(start, lo), min(start + s, lo + n)
        for buf, val in zip(cache, values):
            if (a, e) == (start, start + s):
                buf[:, a - lo:e - lo] = val.to(buf.dtype)
            elif a < e:
                buf[:, a - lo:e - lo] = val[:, a - start:e - start].to(buf.dtype)
        return
    idx = cache_index.long()[:, None] if s == 1 else values[-1].long()
    bidx = torch.arange(b, device=idx.device)[:, None].expand(b, s)
    if trash:
        at = _per_sequence_columns(idx, lo, n, total)
        drop = at == n
        for buf, val in zip(cache, values[:-1]):
            buf[bidx, at] = val.to(buf.dtype)
        cache[-1][bidx, at] = torch.where(drop, PAD_POS, values[-1].to(cache[-1].dtype))
        return
    if s == 1 and (lo, total) == (0, span):
        for buf, val in zip(cache, values):
            buf[bidx[:, 0], idx[:, 0]] = val[:, 0].to(buf.dtype)
        return
    at = idx - lo
    inside = (idx >= 0) & (idx < total) & (at >= 0) & (at < span)
    at = at.clamp(0, span - 1)
    rows = bidx[:, 0]
    for j in range(s):
        for buf, val in zip(cache, values):
            new = val[:, j].to(buf.dtype)
            keep = inside[:, j].view(-1, *([1] * (new.dim() - 1)))
            buf[rows, at[:, j]] = torch.where(keep, new, buf[rows, at[:, j]])


def lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               adapter_ids: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Batched low-rank delta of one adapted projection: gather each
    sequence's factors from the adapter pool by its ``adapter_ids`` entry,
    then ``(x @ A[id]) @ B[id] * scale[id]`` (the JAX package's
    ``lora_delta``, its einsum pair as ``torch.bmm``).

    x: [b, s, d_in]; A: [n_adapters, d_in, r]; B: [n_adapters, r, d_out];
    adapter_ids: [b] int; scale: [n_adapters] float32 (alpha / rank). Row
    0 is the identity (zero factors, zero scale), so an unadapted sequence
    gets an exact-zero delta from the same program, and ``base + delta``
    is ``base`` bitwise. Returns [b, s, d_out] in x's dtype. Nothing is
    read back to the host: the same call is what a CUDA graph captures."""
    dt = x.dtype
    ids = adapter_ids.long()
    a = A.index_select(0, ids).to(dt)                  # [b, d_in, r]   (the gather)
    b = B.index_select(0, ids).to(dt)                  # [b, r, d_out]
    s = scale.index_select(0, ids).to(dt)              # [b]
    return torch.bmm(torch.bmm(x, a), b) * s[:, None, None]


def _adapted(y: torch.Tensor, x: torch.Tensor, proj: str, adapters, adapter_ids):
    """``y`` (the base product ``x @ w``) plus ``proj``'s LoRA delta when
    ``adapters`` (one layer's slice of the pool) is given."""
    if adapters is None:
        return y
    A, B = adapters[proj]
    return y + lora_delta(x, A, B, adapter_ids, adapters["scale"])


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = _param((cfg.dim, cfg.n_heads * hd), param_dtype, device)
        self.wk = _param((cfg.dim, cfg.n_kv_heads * hd), param_dtype, device)
        self.wv = _param((cfg.dim, cfg.n_kv_heads * hd), param_dtype, device)
        self.wo = _param((cfg.n_heads * hd, cfg.dim), param_dtype, device)

    def forward(self, x, positions, cache=None, cache_index=None,
                block_tables=None, adapters=None, adapter_ids=None, paged_rows=None,
                trash=False):
        """x: [b, s, d]. With cache=(k_cache, v_cache, pos_cache) of
        [b, max_len, kvh, hd] / [b, max_len], writes this call's K/V at
        ``cache_index`` (an int: same offset for the whole batch — prefill;
        or a [b] tensor: per-sequence, a decode's offsets with s == 1, a
        verify's tokens each at its position with s > 1) and
        returns (out, cache) with the cache tensors updated in place.
        pos_cache holds each slot's absolute position (PAD_POS when empty),
        so causal masking is exact under right-padding. The int8 layout
        (k_q, k_scale, v_q, v_scale, pos_cache), with float32 [b, max_len,
        kvh] scales, quantizes this call's K/V on write and attends the
        values dequantized in the model dtype.

        With ``block_tables`` ([b, n_pages] int32) the cache tuple is a
        PAGED pool — [pages, page_size, kvh, hd] buffers shared by every
        sequence. Each token writes at the pool coordinate its block table
        maps its position to; ``cache_index`` is ignored. Decode (s == 1)
        reads through ``ops.paged_attention``; a prefill chunk gathers the
        logical view and runs the plain read. ``paged_rows`` (the verify's
        folded (tables [b*s, n_pages], positions [b*s, 1]),
        ``Transformer.forward(verify=True)``) reads every column through
        ``ops.paged_attention`` as a row of its own.

        ``adapters`` (this layer's slice of the LoRA pool, {proj: (A [N,
        d_in, r], B [N, r, d_out]), "scale": [N]}) with ``adapter_ids``
        [b] adds each sequence's delta to q (after ``wq``) and to the
        output (after ``wo``), never to k or v: the KV written is the base
        model's for every adapter.

        ``trash``: the dense cache's rows end in a trash column
        (``SlotCaches``, ``write_dense``).

        Without a cache: full causal attention (``attention_impl="ring"``:
        through ``ops.ring_attention``), returns (out, (k, v))."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        dt = cfg.dtype
        q, k, v = self.project(x, positions, adapters, adapter_ids)
        if cache is not None:
            values = cache_values(cache, k, v, positions)
        if cache is not None and block_tables is not None:
            ps = cache[0].shape[1]
            entry, off = paged_write_targets(block_tables, positions, ps)
            # In place: the JAX package donated the pool to the jitted step;
            # here the scatter writes straight into the shared pool tensors.
            for buf, val in zip(cache, values):
                buf[entry, off] = val.to(buf.dtype)
            new_cache = cache
            if paged_rows is not None:
                # the verify: each of the s columns a query row of its own,
                # with its sequence's table and its own position, so K1
                # masks "pos <= column position" exactly as the gathered read
                from seldon_core_tpu_torch.ops.paged_attention import paged_attention

                tables, qpos = paged_rows
                out = paged_attention(q.reshape(b * s, 1, cfg.n_heads, hd), new_cache, tables,
                                      qpos).reshape(b, s, cfg.n_heads, hd)
            elif s == 1:
                from seldon_core_tpu_torch.ops.paged_attention import paged_attention

                out = paged_attention(q, new_cache, block_tables, positions)
            else:
                k_all, v_all, pos_view = gather_paged_view(new_cache, block_tables, dt)
                mask = pos_view[:, None, :] <= positions[:, :, None]
                out = masked_attention(q, k_all, v_all, mask)
        elif cache is not None:
            write_dense(cache, values, cache_index, trash=trash)
            new_cache = cache
            # pos_cache marks empty slots with PAD_POS, so one predicate
            # covers causality, the unfilled suffix and right-padding.
            mask = cache[-1][:, None, :] <= positions[:, :, None]
            out = masked_attention(q, *dense_view(cache, dt), mask)
        elif cfg.attention_impl == "ring":
            from seldon_core_tpu_torch.ops.ring_attention import ring_attention

            # the cache-less forward (training): GQA-aware, the unrepeated
            # K/V ride the ring; one block here, the ring itself over a
            # 'seq' mesh (models/sharded.py)
            out = ring_attention(q, k.to(dt), v.to(dt), positions, positions)
            new_cache = (k, v)
        else:
            mask = positions[:, None, :] <= positions[:, :, None]
            out = masked_attention(q, k, v, mask)
            new_cache = (k, v)
        return self.output(out.reshape(b, s, cfg.n_heads * hd), adapters, adapter_ids), new_cache

    def project(self, x, positions, adapters=None, adapter_ids=None):
        """(q [b, s, h, hd], k, v [b, s, kvh, hd]) of ``x``: the three
        projections (the LoRA delta on q only), rotary applied to q and k."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, dt = cfg.head_dim, cfg.dtype
        q = _adapted(matmul(x, self.wq, dt), x, "wq", adapters,
                     adapter_ids).reshape(b, s, cfg.n_heads, hd)
        k = matmul(x, self.wk, dt).reshape(b, s, cfg.n_kv_heads, hd)
        v = matmul(x, self.wv, dt).reshape(b, s, cfg.n_kv_heads, hd)
        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta, cfg.rope_scaling)
        return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v

    def output(self, out, adapters=None, adapter_ids=None):
        """``wo`` over the attention output [b, s, h * hd] (float32
        partials for an int8 row shard, ``f32_partials``)."""
        return _adapted(matmul(out, self.wo, _partial_dtype(self.cfg, self.wo)), out, "wo",
                        adapters, adapter_ids)


class DenseFFN(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.w1 = _param((cfg.dim, cfg.ffn_dim), param_dtype, device)
        self.w2 = _param((cfg.ffn_dim, cfg.dim), param_dtype, device)
        self.w3 = _param((cfg.dim, cfg.ffn_dim), param_dtype, device)

    def forward(self, x, adapters=None, adapter_ids=None):
        dt = self.cfg.dtype
        up = _adapted(matmul(x, self.w1, dt), x, "w1", adapters, adapter_ids)
        gate = _adapted(matmul(x, self.w3, dt), x, "w3", adapters, adapter_ids)
        h = F.silu(up) * gate
        return _adapted(matmul(h, self.w2, _partial_dtype(self.cfg, self.w2)), h, "w2", adapters,
                        adapter_ids)


def route(gate_logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of ``gate_logits`` [..., e] float32: (dense gates
    [..., e] float32, the chosen experts [..., k]). The k largest logits
    in ``jax.lax.top_k``'s order: floats in their total order (-0 below
    +0) and of equal values the lower index first, a stable descending
    sort of the logits' bits as ordered integers (``torch.topk`` gives no
    order for ties); then a softmax over them, scattered into gates that
    are zero elsewhere. No host read and no shape that depends on the data,
    so a CUDA graph captures it."""
    bits = gate_logits.float().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)      # monotone in the float's total order
    topi = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    topv = gate_logits.gather(-1, topi)
    gates = torch.zeros_like(gate_logits).scatter_(-1, topi, torch.softmax(topv, dim=-1))
    return gates, topi


class MoEFFN(nn.Module):
    """Top-k token-choice mixture of experts, the JAX package's ``MoEFFN``:
    ``router`` [dim, e], ``w1`` / ``w3`` [e, dim, ffn], ``w2`` [e, ffn,
    dim]. Dense over experts, as there: every expert computes every token,
    and each output is ``sum_e gate_e * w2[e](silu(w1[e] x) * w3[e] x)``
    with gates zero outside the token's top k.

    The router's logits are ``x.float() @ router.float()`` (an int8 router
    dequantized in its ``orig_dtype`` first, as ``dequantize_params`` gives
    it; it never reaches the int8 GEMM, whose x is bf16 and whose N = e is
    too narrow for it), routed by ``route``. The experts run in the compute
    dtype: float weights as one batched product a projection over the
    expert axis (``torch.matmul``, cuBLAS on a card); int8 weights as one
    int8 GEMM a projection an expert (``ops/int8_matmul``: ``q[e]`` of the
    contiguous [e, K, N] codes is a contiguous [K, N] view, ``scale`` the
    one [N] vector of the leaf, per output column across experts). The
    experts' outputs y [e, tokens, dim] are rounded to the compute dtype,
    then summed over e weighted by the gates in that dtype as one
    contraction (``einsum``: float32 accumulation, one rounding), the JAX
    package's last einsum."""

    def __init__(self, cfg: TransformerConfig, *, param_dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.n_experts
        self.router = _param((cfg.dim, e), param_dtype, device)
        self.w1 = _param((e, cfg.dim, cfg.ffn_dim), param_dtype, device)
        self.w2 = _param((e, cfg.ffn_dim, cfg.dim), param_dtype, device)
        self.w3 = _param((e, cfg.dim, cfg.ffn_dim), param_dtype, device)

    def gates(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dense gates [..., e] float32, chosen experts [..., k]) of ``x``."""
        router = self.router
        if isinstance(router, QuantizedTensor):
            router = dequantize_array(router)
        k = min(self.cfg.n_experts_per_token, self.cfg.n_experts)
        return route(x.float() @ router.float(), k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.combine(x, self.gates(x)[0])

    def combine(self, x: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
        """The experts' sum weighted by dense ``gates`` [..., e] (zero
        outside each token's top k); a rank of a sharded model passes its
        experts' columns of the gates."""
        cfg = self.cfg
        dt = cfg.dtype
        x2 = x.reshape(-1, cfg.dim).to(dt)
        w1, w2, w3 = self.w1, self.w2, self.w3
        out_dt = _partial_dtype(cfg, w2)
        if isinstance(w1, QuantizedTensor):
            ys = []
            for i in range(cfg.n_experts):
                h = (F.silu(k4.int8_matmul(x2, w1.q[i], w1.scale, dt))
                     * k4.int8_matmul(x2, w3.q[i], w3.scale, dt))
                ys.append(k4.int8_matmul(h, w2.q[i], w2.scale, out_dt))
            y = torch.stack(ys)                                            # [e, T, dim]
        else:
            h = F.silu(torch.matmul(x2, w1.to(dt))) * torch.matmul(x2, w3.to(dt))
            y = torch.matmul(h, w2.to(dt))                                 # [e, T, dim]
        out = torch.einsum("etd,te->td", y, gates.reshape(-1, cfg.n_experts).to(out_dt))
        return out.reshape(x.shape)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(param_dtype=param_dtype, device=device)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.attention = Attention(cfg, **kw)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        # the flax names: "moe" (MoEFFN) or "ffn" (DenseFFN)
        if cfg.n_experts > 0:
            self.moe = MoEFFN(cfg, **kw)
        else:
            self.ffn = DenseFFN(cfg, **kw)

    def forward(self, x, positions, cache=None, cache_index=None,
                block_tables=None, paged_rows=None, adapters=None, adapter_ids=None,
                trash=False):
        cfg = self.cfg
        h, new_cache = self.attention(self.attention_norm(x), positions, cache,
                                      cache_index, block_tables, adapters=adapters,
                                      adapter_ids=adapter_ids, paged_rows=paged_rows,
                                      trash=trash)
        if cfg.fused_norm:
            # residual-add + RMSNorm in one pass over the activation
            from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm

            x, ffn_in = fused_residual_rmsnorm(x, h, self.ffn_norm.weight, cfg.norm_eps)
        else:
            x = x + h
            ffn_in = self.ffn_norm(x)
        if cfg.n_experts > 0:
            return x + self.moe(ffn_in), new_cache
        return x + self.ffn(ffn_in, adapters, adapter_ids), new_cache


class Transformer(nn.Module):
    """Llama-family decoder. Build with ``param_dtype`` = storage dtype of
    every parameter (float32 by default, as flax stores them) on ``device``;
    fill with ``init_params`` or ``load_state_dict``; ``quantize_`` turns
    it into the weight-only int8 model."""

    def __init__(self, cfg: TransformerConfig, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(param_dtype=param_dtype, device=device)
        self.tok_embeddings = _param((cfg.vocab_size, cfg.dim), param_dtype, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", TransformerBlock(cfg, **kw))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.dim, cfg.vocab_size), param_dtype, device)
        # the float model's leaf order: init_params draws in it whether or
        # not a leaf has been quantized since
        self._leaf_names = tuple(name for name, _ in self.named_parameters())

    def layers(self) -> List[TransformerBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def logical_axes(self) -> Dict[str, Tuple[str, ...]]:
        """``{leaf name: logical axes}``: the names the JAX package's
        transformer declares on each param (``param_with_axes``), which
        ``parallel/sharding.py`` maps onto a mesh."""
        table = {"tok_embeddings": ("vocab", "embed"), "norm.weight": ("embed",)}
        if not self.cfg.tie_embeddings:
            table["lm_head"] = ("embed", "vocab")
        ffn = ({"moe.router": ("embed", "expert"), "moe.w1": ("expert", "embed", "mlp"),
                "moe.w2": ("expert", "mlp", "embed"), "moe.w3": ("expert", "embed", "mlp")}
               if self.cfg.n_experts > 0 else
               {"ffn.w1": ("embed", "mlp"), "ffn.w2": ("mlp", "embed"),
                "ffn.w3": ("embed", "mlp")})
        per_layer = {"attention_norm.weight": ("embed",), "ffn_norm.weight": ("embed",),
                     "attention.wq": ("embed", "heads"), "attention.wk": ("embed", "kv_heads"),
                     "attention.wv": ("embed", "kv_heads"), "attention.wo": ("heads", "embed"),
                     **ffn}
        for i in range(self.cfg.n_layers):
            table.update({f"layer_{i}.{k}": v for k, v in per_layer.items()})
        return table

    def leaves(self) -> Dict[str, Any]:
        """``{leaf name: tensor or QuantizedTensor}`` of every weight, in
        the float model's leaf order: the tree ``parallel/sharding.py``
        cuts."""
        return {name: getattr(*self._owner(name)) for name in self._leaf_names}

    def shard(self, mesh, rules=None) -> "Any":
        """This filled model over ``mesh`` (``models/sharded.py``): the
        leaves cut by the rule table, one rank-local model a rank."""
        from seldon_core_tpu_torch.models.sharded import ShardedTransformer

        return ShardedTransformer(self, mesh, rules)

    # The caches this model reads. A sharded model (``models/sharded.py``)
    # answers the same four calls with one set a rank, so the servers and
    # the batcher ask the model and never the config.
    def init_caches(self, lead: Tuple[int, int], kv_cache_dtype: Optional[str] = None,
                    device=None, paged: bool = False):
        """Fresh caches: ``init_paged_kv_caches`` of ``lead`` = (pages,
        page_size) when ``paged``, else ``init_kv_caches`` of (rows,
        positions)."""
        init = init_paged_kv_caches if paged else init_kv_caches
        return init(self.cfg, *lead, kv_cache_dtype, device=device)

    @staticmethod
    def cache_share(lead: Tuple[int, int]) -> Tuple[int, int]:
        """The (rows, positions) of a dense cache of ``lead`` that each of
        this model's cache tuples holds: all of it."""
        return tuple(lead)

    @staticmethod
    def wrap_caches(layers: List[tuple], lead: Tuple[int, int]):
        """``layers`` (one tuple a layer, at ``cache_share(lead)``) as the
        caches the forward takes."""
        return layers

    @staticmethod
    def cache_lead(caches) -> Tuple[int, ...]:
        """The (rows, positions) or (pages, page_size) ``caches`` cover; a
        ``SlotCaches`` pool's positions are its ``width``, its trash column
        not counted."""
        lead = tuple(caches[0][-1].shape)
        width = getattr(caches, "width", None)
        return lead if width is None else (lead[0], width)

    def init_slot_caches(self, slots: int, width: int, kv_cache_dtype: Optional[str] = None,
                         device=None) -> SlotCaches:
        """The batcher's dense slot pool: ``slots`` rows of ``width``
        positions and a trash column each (``SlotCaches``), empty."""
        return SlotCaches(self.init_caches((slots, int(width) + 1), kv_cache_dtype,
                                           device=device), width)

    @staticmethod
    def slot_rows(caches, slot: int) -> SlotCaches:
        """Row ``slot`` of a slot pool as a pool of one row (views: a
        write through them is a write into the pool)."""
        return SlotCaches([tuple(t[slot:slot + 1] for t in layer) for layer in caches],
                          caches.width)

    @staticmethod
    def slot_columns(caches, positions: torch.Tensor):
        """[(layer tuples, rows, columns)]: where the positions
        ``positions`` [slots, c] of a slot pool's rows lie, for code that
        writes the pool directly (the verify's reject repair): here every
        row of the one pool, a position outside ``[0, width)`` at the trash
        column."""
        w = caches.width
        return [(caches, slice(None), _per_sequence_columns(positions.long(), 0, w, w))]

    @staticmethod
    def pool_ranks(caches, pages: torch.Tensor):
        """[(layer tuples, page ids)]: where the pool's pages ``pages`` (an
        int tensor of any shape) lie, for code that writes the pool directly
        (a page reset, a copy-on-write copy, the verify's reject repair):
        here the one pool at the same ids."""
        return [(caches, pages)]

    def param_tree(self) -> Dict[str, Any]:
        """The float parameters as flax's nested ``params`` dict of tensors
        (the layout ``export_checkpoint`` writes and ``params_from_jax``
        reads); a quantized model has no float tree and raises."""
        tree: Dict[str, Any] = {}
        for name in self._leaf_names:
            owner, leaf = self._owner(name)
            t = getattr(owner, leaf)
            if isinstance(t, QuantizedTensor):
                raise TypeError(f"{name} is quantized: export the float model")
            node = tree
            for part in name.split(".")[:-1]:
                node = node.setdefault(part, {})
            node[leaf] = t
        return tree

    def _owner(self, name: str):
        """(module holding leaf ``name``, the leaf's attribute name)."""
        path, _, leaf = name.rpartition(".")
        return (self.get_submodule(path) if path else self), leaf

    @torch.no_grad()
    def quantize_(self) -> "Transformer":
        """Weight-only int8, in place (``ops/quantize.py``): every float
        parameter of two or more dims becomes a ``QuantizedTensor`` module
        at the same name, holding ``q`` and ``scale`` buffers and the leaf's
        storage dtype as ``orig_dtype``; each float leaf is freed as soon as
        its int8 copy exists. The norm weights stay float. On the meta
        device it builds the int8 layout and allocates nothing."""
        names = [n for n, p in self.named_parameters() if _is_quantizable(p)]
        for name in names:
            owner, leaf = self._owner(name)
            qt = quantize_array(getattr(owner, leaf))
            delattr(owner, leaf)
            owner.add_module(leaf, qt)
        return self

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random init with flax's distributions, drawn leaf by leaf in
        float32 from ``generator`` and cast into each parameter's storage
        dtype (so a bf16-stored 7B model never holds a float32 copy of
        more than one leaf): normal(0.02) for the embedding and lm_head,
        ones for norm weights, lecun-normal (truncated normal, std
        1/sqrt(fan_in)) for every projection, fan_in the product of every
        dim but the last (flax's: e * dim for an expert leaf [e, dim,
        ffn]). A leaf already quantized
        (``quantize_`` on the meta device, then ``to_empty``) is drawn the
        same way and quantized straight into its int8 buffers, so the float
        tree never exists and the result equals ``init_params`` followed by
        ``quantize_``. The same seed gives the same weights on the same
        device type; a JAX checkpoint crosses over through
        ``models/convert.py`` instead."""
        for name in self._leaf_names:
            owner, leaf = self._owner(name)
            t = getattr(owner, leaf)
            if leaf == "weight":
                t.fill_(1.0)
                continue
            quantized = isinstance(t, QuantizedTensor)
            w = torch.empty(t.shape, dtype=torch.float32,
                            device=t.q.device if quantized else t.device)
            if leaf in ("tok_embeddings", "lm_head"):
                w.normal_(0.0, 0.02, generator=generator)
            else:
                # flax variance_scaling(1, "fan_in", "truncated_normal"):
                # a [-2, 2] truncated unit normal times sqrt(1/fan_in)/0.8796
                std = (1.0 / math.prod(t.shape[:-1])) ** 0.5 / 0.87962566103423978
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                w.mul_(std)
            if quantized:
                quantize_into_(t, w)
            else:
                t.copy_(w)
            del w  # freed before the next leaf is drawn: one float32 leaf at a time

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding rows of ``tokens`` in the compute dtype. int8
        embeddings gather their int8 rows and dequantize them in
        ``orig_dtype`` before the cast, which is ``emb.astype(dt)[tokens]``
        of the dequantized table, row by row."""
        emb = self.tok_embeddings
        if isinstance(emb, QuantizedTensor):
            rows = emb.q[tokens.long()].to(emb.orig_dtype) * emb.scale.to(emb.orig_dtype)
            return rows.to(self.cfg.dtype)
        return F.embedding(tokens.long(), emb).to(self.cfg.dtype)

    @torch.no_grad()
    def prepare_head_(self) -> "Transformer":
        """A tied head over int8 embeddings: make the transposed int8 copy
        its card route reads (``tied_int8_logits``), once the weights are
        in (``LLMServer.load``). A plain attribute, not a buffer: the
        state dict stays the weights'. Anything else: nothing to do."""
        emb = self.tok_embeddings
        if self.cfg.tie_embeddings and isinstance(emb, QuantizedTensor):
            self._head_t = (emb.q.t().contiguous(),
                            torch.ones(emb.q.shape[0], dtype=torch.float32, device=emb.q.device))
        return self

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits ``x.float() @ head``; a tied head over int8
        embeddings through ``tied_int8_logits``."""
        if not self.cfg.tie_embeddings:
            return matmul(x, self.lm_head, torch.float32)
        emb = self.tok_embeddings
        if isinstance(emb, QuantizedTensor):
            return tied_int8_logits(x, emb, getattr(self, "_head_t", None))
        return x.float() @ emb.float().t()

    def forward(self, tokens, positions=None, caches=None, cache_index=None,
                block_tables=None, adapters=None, adapter_ids=None, verify=False):
        """tokens: [b, s] int. Returns (logits [b, s, vocab] float32,
        new_caches). ``block_tables`` ([b, n_pages] int32, shared by every
        layer) switches the caches to the paged-pool layout — see
        Attention. Cache tensors are updated in place.

        ``verify=True`` (paged only) marks the call as a speculative verify:
        each sequence's s columns are consecutive positions, the first
        real, those past its draft cap PAD_POS. The attention then reads
        through ``ops.paged_attention`` with the columns folded into b*s
        rows (the tables repeated per column), where a prefill chunk
        (``verify=False``, s > 1) gathers the whole view. A PAD_POS column
        writes as PAD_POS (the TRASH page) but attends at its sequence's
        last real position, so the kernel, which walks a table up to the
        query's page, does not walk the whole table for it; its output is
        never read.

        ``adapters`` (the LoRA pool of ``runtime/adapters.py``: {proj: (A
        [N, L, d_in, r], B [N, L, r, d_out]), "scale": [N]}) with
        ``adapter_ids`` ([b] int, 0 = the identity) adds each sequence's
        low-rank delta on the q, o and FFN projections: each layer slices
        its own factors out of the pool (``lora_delta``)."""
        if adapters is not None and adapter_ids is None:
            raise ValueError("adapters need adapter_ids (one id per "
                             "sequence; 0 = identity)")
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        paged_rows = None
        if verify:
            if block_tables is None or caches is None:
                raise ValueError("verify=True reads a paged pool: pass caches and block_tables")
            real = positions != PAD_POS
            last = torch.where(real, positions, torch.zeros_like(positions)).amax(
                dim=1, keepdim=True)
            qpos = torch.where(real, positions, last)
            paged_rows = (block_tables.repeat_interleave(s, dim=0), qpos.reshape(b * s, 1))
        trash = getattr(caches, "width", None) is not None   # a SlotCaches pool
        x = self._embed(tokens)
        new_caches = []
        for i, layer in enumerate(self.layers()):
            layer_cache = caches[i] if caches is not None else None
            layer_adapters = None
            if adapters is not None:
                # this layer's factors: [N, L, ...] -> [N, ...] (views)
                layer_adapters = {proj: (ab[0][:, i], ab[1][:, i])
                                  for proj, ab in adapters.items() if proj != "scale"}
                layer_adapters["scale"] = adapters["scale"]
            x, nc = layer(x, positions, layer_cache, cache_index, block_tables, paged_rows,
                          layer_adapters, adapter_ids, trash)
            new_caches.append(nc)
        return self._logits(self.norm(x)), new_caches


def _cache_layers(cfg: TransformerConfig, lead: Tuple[int, int], kv_cache_dtype, device):
    """One cache tuple per layer with leading dims ``lead``: the (k, v, pos)
    triple in the model dtype, or with kv_cache_dtype="int8" the (k_q,
    k_scale, v_q, v_scale, pos) 5-tuple — int8 values plus float32 [*lead,
    kvh] per-head per-position scales; in the state ``reset_kv_caches``
    sets."""
    dev = resolve_device(device)
    shape = (*lead, cfg.n_kv_heads, cfg.head_dim)
    int8 = normalize_kv_cache_dtype(kv_cache_dtype or cfg.kv_cache_dtype) == "int8"

    def layer():
        pos = torch.empty(lead, dtype=torch.int32, device=dev)
        if int8:
            scale_shape = (*lead, cfg.n_kv_heads)
            return (torch.empty(shape, dtype=torch.int8, device=dev),
                    torch.empty(scale_shape, dtype=torch.float32, device=dev),
                    torch.empty(shape, dtype=torch.int8, device=dev),
                    torch.empty(scale_shape, dtype=torch.float32, device=dev), pos)
        return (torch.empty(shape, dtype=cfg.dtype, device=dev),
                torch.empty(shape, dtype=cfg.dtype, device=dev), pos)

    caches = [layer() for _ in range(cfg.n_layers)]
    reset_kv_caches(caches)
    return caches


def reset_kv_caches(caches) -> None:
    """Set caches, in place, to their empty state: K and V zero (int8
    values too), int8 scales 1 so that empty slots dequantize to exact
    zeros, positions PAD_POS (never attended)."""
    for layer in caches:
        if len(layer) == 5:
            k, k_scale, v, v_scale, pos = layer
            k_scale.fill_(1.0)
            v_scale.fill_(1.0)
        else:
            k, v, pos = layer
        k.zero_()
        v.zero_()
        pos.fill_(PAD_POS)


def init_kv_caches(cfg: TransformerConfig, batch: int, max_len: int,
                   kv_cache_dtype: Optional[str] = None, *, device=None):
    """Dense KV caches, one per layer: [b, max_len, kvh, hd] buffers plus a
    [b, max_len] position map (see ``_cache_layers`` for the bf16 triple
    and the int8 5-tuple)."""
    return _cache_layers(cfg, (batch, max_len), kv_cache_dtype, device)


def init_paged_kv_caches(cfg: TransformerConfig, num_pages: int,
                         page_size: int, kv_cache_dtype: Optional[str] = None,
                         *, device=None):
    """Paged KV pools, one per layer, with leading dims [num_pages,
    page_size] — pages are shared by every sequence through per-sequence
    block tables. Pages 0 and 1 are reserved (NULL_PAGE / TRASH_PAGE)."""
    if num_pages <= RESERVED_PAGES:
        raise ValueError(
            f"paged KV pool needs > {RESERVED_PAGES} pages "
            f"(got {num_pages}; pages 0/1 are reserved)")
    return _cache_layers(cfg, (num_pages, page_size), kv_cache_dtype, device)


def kv_cache_bytes_per_token(cfg: TransformerConfig,
                             kv_cache_dtype: Optional[str] = None) -> int:
    """Device bytes one cached token position costs across all layers (K +
    V values, int8 scales when quantized, and the int32 position map)."""
    kvd = normalize_kv_cache_dtype(kv_cache_dtype or cfg.kv_cache_dtype)
    per_pos = cfg.n_kv_heads * cfg.head_dim
    if kvd == "int8":
        per_layer = 2 * (per_pos * 1 + cfg.n_kv_heads * 4)  # int8 + f32 scale
    else:
        per_layer = 2 * per_pos * torch.empty((), dtype=cfg.dtype).element_size()
    return cfg.n_layers * (per_layer + 4)  # + int32 pos slot


def _build(cfg: TransformerConfig, device, param_dtype) -> Transformer:
    if cfg.attention_impl not in ("full", "ring"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.mesh is not None:
        raise ValueError(
            "TransformerConfig(mesh=...): the port shards a filled model, "
            "Transformer.shard(mesh), which LLMServer(mesh=...) calls after loading")
    if param_dtype == "auto":  # store in the compute dtype (LLMServer's "auto")
        pdt = cfg.dtype
    else:
        pdt = to_torch_dtype(param_dtype) if param_dtype else torch.float32
    # "meta" builds the layout and allocates nothing (LLMServer quantizes
    # the layout before any weight exists)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    return Transformer(cfg, param_dtype=pdt, device=dev)


@register_model("transformer")
def make_transformer(device=None, param_dtype=None, **kwargs):
    """``device`` (default "cuda"; "meta" allocates nothing) and
    ``param_dtype`` (parameter storage: float32 by default, "auto" = the
    compute dtype) are build options; every other keyword is a
    TransformerConfig field."""
    dtype = kwargs.pop("dtype", "bfloat16")
    scaling = kwargs.pop("rope_scaling", None)
    if isinstance(scaling, dict):  # normalize to a hashable config field
        scaling = tuple(sorted(scaling.items()))
    kvd = normalize_kv_cache_dtype(kwargs.pop("kv_cache_dtype", "bf16"))
    cfg = TransformerConfig(dtype=to_torch_dtype(dtype), rope_scaling=scaling,
                            kv_cache_dtype=kvd, **kwargs)
    return _build(cfg, device, param_dtype)


@register_model("llama2-7b")
def make_llama2_7b(dtype: str = "bfloat16", device=None, param_dtype=None):
    cfg = TransformerConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        ffn_dim=11008, max_seq_len=4096, dtype=to_torch_dtype(dtype),
    )
    return _build(cfg, device, param_dtype)


@register_model("llama-tiny")
def make_llama_tiny(dtype: str = "float32", device=None, param_dtype=None, **kwargs):
    """Small config for tests."""
    cfg = TransformerConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=128, dtype=to_torch_dtype(dtype),
        tie_embeddings=True, **kwargs,
    )
    return _build(cfg, device, param_dtype)


__all__ = [
    "PAD_POS", "NULL_PAGE", "TRASH_PAGE", "RESERVED_PAGES",
    "TransformerConfig", "Transformer", "TransformerBlock", "Attention",
    "DenseFFN", "MoEFFN", "route", "RMSNorm", "rms_norm", "rotary_embedding", "apply_rotary",
    "paged_write_targets", "gather_paged_view", "dense_view", "attention_logits",
    "masked_attention", "cache_values", "write_dense", "SlotCaches",
    "matmul", "lora_delta", "quantize_kv", "dequantize_kv", "tied_int8_logits",
    "tied_int8_logits_ref",
    "init_kv_caches", "init_paged_kv_caches", "reset_kv_caches", "kv_cache_bytes_per_token",
    "normalize_kv_cache_dtype", "normalize_kv_cache_layout", "to_torch_dtype",
]
