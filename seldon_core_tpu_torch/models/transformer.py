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
  plain PyTorch version on the CPU. Prefill (``s > 1``) is the plain masked
  matmul + softmax, as the JAX package leaves it to XLA.
- ``fused_norm=True`` routes each block's residual add + ffn RMSNorm through
  ``ops/fused_norm.py`` (a Triton kernel on a card).
- int8 KV caches (``kv_cache_dtype="int8"``) are the JAX package's 5-tuple
  (k_q, k_scale, v_q, v_scale, pos): quantize on write, dequantize in the
  model dtype on the plain read; the paged decode read dequantizes in
  float32 inside the kernel.
- Weight-only int8 (``Transformer.quantize_``): every projection and the
  lm_head become ``ops/quantize.QuantizedTensor`` modules and go through
  ``quantized_matmul`` — the W8A16 GEMM kernel on a card — where the JAX
  package left the dequantizing matmul to XLA's fusion.

Configurations that belong to later slices raise ``NotImplementedError``
naming the slice: MoE FFNs, batched LoRA, ring attention and meshes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.registry import register_model
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

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


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
                        page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) pool coordinates for writing each token's KV.

    ``block_tables``: [b, n_pages] page ids; ``positions``: [b, s] absolute
    token positions (PAD_POS for padding). Tokens whose position falls past
    the table, or whose table entry is NULL_PAGE, are redirected to
    TRASH_PAGE: the null page's PAD_POS position row is an invariant no
    write may break. Returns int64 index tensors."""
    p = positions.long()
    bt = block_tables.long()
    n_pages = bt.shape[1]
    page_idx = torch.div(p, page_size, rounding_mode="floor")
    valid = (p >= 0) & (page_idx < n_pages)
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


def masked_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The plain attention read every layout shares: q [b, s, h, hd],
    k_all/v_all [b, L, kvh, hd], mask [b, s, L] (True = attend). GQA repeats
    each kv head up to its group of query heads; logits are scaled in the
    model dtype, masked with ``finfo(float32).min`` (never -inf, so a row
    with nothing to attend stays finite), softmaxed in float32 and cast back
    — the op order of the JAX package's einsum chain."""
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
    logits = logits.masked_fill(~mask[:, None, :, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_all.to(dt))


def _check_adapters(adapters) -> None:
    if adapters is not None:
        raise NotImplementedError(
            "batched LoRA adapters (lora_delta) arrive with the LoRA/tenants "
            "slice of the port")


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
                block_tables=None, adapters=None, adapter_ids=None):
        """x: [b, s, d]. With cache=(k_cache, v_cache, pos_cache) of
        [b, max_len, kvh, hd] / [b, max_len], writes this call's K/V at
        ``cache_index`` (an int: same offset for the whole batch — prefill;
        or a [b] tensor with s == 1: per-sequence offsets — decode) and
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
        logical view and runs the plain read.

        Without a cache: full causal attention, returns (out, (k, v))."""
        _check_adapters(adapters)
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        dt = cfg.dtype

        q = matmul(x, self.wq, dt).reshape(b, s, cfg.n_heads, hd)
        k = matmul(x, self.wk, dt).reshape(b, s, cfg.n_kv_heads, hd)
        v = matmul(x, self.wv, dt).reshape(b, s, cfg.n_kv_heads, hd)

        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta, cfg.rope_scaling)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

        if cache is not None:
            # what each cache buffer stores for this call's tokens: the int8
            # layout quantizes K and V on write (per head, per position)
            if len(cache) == 5:
                (kq, vq), (ks, vs) = quantize_kv(torch.stack((k, v)))
                values = (kq, ks, vq, vs, positions)
            else:
                values = (k, v, positions)
        if cache is not None and block_tables is not None:
            ps = cache[0].shape[1]
            entry, off = paged_write_targets(block_tables, positions, ps)
            # In place: the JAX package donated the pool to the jitted step;
            # here the scatter writes straight into the shared pool tensors.
            for buf, val in zip(cache, values):
                buf[entry, off] = val.to(buf.dtype)
            new_cache = cache
            if s == 1:
                from seldon_core_tpu_torch.ops.paged_attention import paged_attention

                out = paged_attention(q, new_cache, block_tables, positions)
            else:
                k_all, v_all, pos_view = gather_paged_view(new_cache, block_tables, dt)
                mask = pos_view[:, None, :] <= positions[:, :, None]
                out = masked_attention(q, k_all, v_all, mask)
        elif cache is not None:
            pos_cache = cache[-1]
            if not torch.is_tensor(cache_index) or cache_index.dim() == 0:
                # a scalar offset, clamped like lax.dynamic_update_slice
                i = max(0, min(int(cache_index), pos_cache.shape[1] - s))
                # In place (the JAX package donated the cache to the step).
                for buf, val in zip(cache, values):
                    buf[:, i:i + s] = val.to(buf.dtype)
            elif s == 1:
                # per-sequence write offsets (continuous batching), in place
                bidx = torch.arange(b, device=x.device)
                idx = cache_index.long()
                for buf, val in zip(cache, values):
                    buf[bidx, idx] = val[:, 0].to(buf.dtype)
            else:
                raise NotImplementedError(
                    "per-sequence multi-token dense writes (the speculative "
                    "verify step) arrive with the speculative-decoding slice")
            new_cache = cache
            # pos_cache marks empty slots with PAD_POS, so one predicate
            # covers causality, the unfilled suffix and right-padding.
            mask = pos_cache[:, None, :] <= positions[:, :, None]
            out = masked_attention(q, *dense_view(cache, dt), mask)
        else:
            mask = positions[:, None, :] <= positions[:, :, None]
            out = masked_attention(q, k, v, mask)
            new_cache = (k, v)
        out = out.reshape(b, s, cfg.n_heads * hd)
        return matmul(out, self.wo, dt), new_cache


class DenseFFN(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.w1 = _param((cfg.dim, cfg.ffn_dim), param_dtype, device)
        self.w2 = _param((cfg.ffn_dim, cfg.dim), param_dtype, device)
        self.w3 = _param((cfg.dim, cfg.ffn_dim), param_dtype, device)

    def forward(self, x):
        dt = self.cfg.dtype
        up = matmul(x, self.w1, dt)
        gate = matmul(x, self.w3, dt)
        return matmul(F.silu(up) * gate, self.w2, dt)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(param_dtype=param_dtype, device=device)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.attention = Attention(cfg, **kw)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.ffn = DenseFFN(cfg, **kw)

    def forward(self, x, positions, cache=None, cache_index=None,
                block_tables=None):
        cfg = self.cfg
        h, new_cache = self.attention(self.attention_norm(x), positions, cache,
                                      cache_index, block_tables)
        if cfg.fused_norm:
            # residual-add + RMSNorm in one pass over the activation
            from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm

            x, ffn_in = fused_residual_rmsnorm(x, h, self.ffn_norm.weight, cfg.norm_eps)
        else:
            x = x + h
            ffn_in = self.ffn_norm(x)
        return x + self.ffn(ffn_in), new_cache


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
        1/sqrt(fan_in)) for every projection. A leaf already quantized
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
                std = (1.0 / t.shape[0]) ** 0.5 / 0.87962566103423978
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

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits ``x.float() @ head``. A tied head over int8
        embeddings is ``[dim, vocab]`` with its scale on K (one per
        embedding column), which the int8 GEMM kernel (scale per output
        column) does not take: the CPU computes the plain product, a card
        raises."""
        if not self.cfg.tie_embeddings:
            return matmul(x, self.lm_head, torch.float32)
        emb = self.tok_embeddings
        if isinstance(emb, QuantizedTensor):
            if x.device.type != "cpu":
                raise NotImplementedError(
                    "a tied lm_head over int8 embeddings has its scale on K, which the "
                    "int8 GEMM kernel (scale per output column) does not take; serve an "
                    "untied model with quantize='int8' on the card")
            emb = dequantize_array(emb)
        return x.float() @ emb.float().t()

    def forward(self, tokens, positions=None, caches=None, cache_index=None,
                block_tables=None, adapters=None, adapter_ids=None):
        """tokens: [b, s] int. Returns (logits [b, s, vocab] float32,
        new_caches). ``block_tables`` ([b, n_pages] int32, shared by every
        layer) switches the caches to the paged-pool layout — see
        Attention. Cache tensors are updated in place."""
        _check_adapters(adapters)
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(tokens)
        new_caches = []
        for i, layer in enumerate(self.layers()):
            layer_cache = caches[i] if caches is not None else None
            x, nc = layer(x, positions, layer_cache, cache_index, block_tables)
            new_caches.append(nc)
        return self._logits(self.norm(x)), new_caches


def _cache_layers(cfg: TransformerConfig, lead: Tuple[int, int], kv_cache_dtype, device):
    """One cache tuple per layer with leading dims ``lead``: the (k, v, pos)
    triple in the model dtype, or with kv_cache_dtype="int8" the (k_q,
    k_scale, v_q, v_scale, pos) 5-tuple — int8 values plus float32 [*lead,
    kvh] per-head per-position scales, initialised to 1 so empty slots
    dequantize to exact zeros. Positions start at PAD_POS (never
    attended)."""
    dev = resolve_device(device)
    shape = (*lead, cfg.n_kv_heads, cfg.head_dim)
    int8 = normalize_kv_cache_dtype(kv_cache_dtype or cfg.kv_cache_dtype) == "int8"

    def layer():
        pos = torch.full(lead, PAD_POS, dtype=torch.int32, device=dev)
        if int8:
            scale_shape = (*lead, cfg.n_kv_heads)
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.ones(scale_shape, dtype=torch.float32, device=dev),
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.ones(scale_shape, dtype=torch.float32, device=dev), pos)
        return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
                torch.zeros(shape, dtype=cfg.dtype, device=dev), pos)

    return [layer() for _ in range(cfg.n_layers)]


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
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE FFNs (MoEFFN) arrive with the MoE slice of the port")
    if cfg.attention_impl == "ring":
        raise NotImplementedError(
            "attention_impl='ring' (sequence-parallel ring attention) "
            "arrives with the parallelism slice of the port")
    if cfg.attention_impl != "full":
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.mesh is not None:
        raise NotImplementedError(
            "meshes (tensor/sequence parallelism) arrive with the "
            "parallelism slice of the port")
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
    "DenseFFN", "RMSNorm", "rms_norm", "rotary_embedding", "apply_rotary",
    "paged_write_targets", "gather_paged_view", "dense_view", "masked_attention",
    "matmul", "quantize_kv", "dequantize_kv",
    "init_kv_caches", "init_paged_kv_caches", "kv_cache_bytes_per_token",
    "normalize_kv_cache_dtype", "normalize_kv_cache_layout", "to_torch_dtype",
]
