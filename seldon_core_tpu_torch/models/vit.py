"""Vision Transformer family: the port of ``seldon_core_tpu/models/vit.py``.

flax's names and layouts throughout: ``patch_embed`` (an HWIO conv kernel
and its bias), ``cls`` [1, 1, d], ``pos_embed`` [1, tokens + 1, d],
``ln1_i`` / ``attn_i`` (``wqkv`` [d, 3d], ``wo`` [d, d]) / ``ln2_i`` /
``mlp_i`` (``w1``, ``b1``, ``w2``, ``b2``), ``ln_final`` and ``head`` [d,
classes]. The numerics follow the flax module, not PyTorch's defaults:

- the patch embedding is one strided conv with SAME padding in the compute
  dtype, its bias added after (``F.conv2d``: cuDNN on the card, as XLA runs
  it in the JAX package);
- LayerNorm takes ε = 1e-6 and float32 statistics (``layers.layer_norm``);
- GELU is the tanh approximation (flax ``nn.gelu``);
- the attention is JAX's einsum chain, not SDPA: the logits rounded to the
  compute dtype, scaled by ``hd ** -0.5`` there, then a float32 softmax
  cast back;
- the head multiplies ``x[:, 0]`` in float32.

Int8 (``ops/quantize.quantize_params``, as ``JAXServer(quantize="int8")``
quantizes): every block's products and the head run on K4 under bf16
compute (the head's bf16 ``x[:, 0]`` is exact in float32, so K4 writes its
float32 logits); under float32 compute (``vit-tiny``) each product is the
dequantized weight and ``torch.matmul``. ``cls``, ``pos_embed`` and the
patch kernel are added or convolved, so they are dequantized first.

Over a mesh (``shard``): ``ShardedViT`` holds one rank-local tree a rank,
cut by the JAX package's logical axes (``logical_axes``: heads and mlp over
'model', the head's classes over 'model', the batch over 'data').
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.layers import (LayerNorm, init_live_, layer_norm, param,
                                                 param_tree)
from seldon_core_tpu_torch.models.registry import register_model
from seldon_core_tpu_torch.models.resnet_infer import conv, same_pads
from seldon_core_tpu_torch.models.transformer import to_torch_dtype
from seldon_core_tpu_torch.ops.quantize import float32_head, leaf, leaves, linear
from seldon_core_tpu_torch.parallel import collectives

Leaves = Dict[str, Any]


class _Attention(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.wqkv = param(dim, 3 * dim, device=device)
        self.wo = param(dim, dim, device=device)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.w1 = param(dim, hidden, device=device)
        self.b1 = param(hidden, device=device)
        self.w2 = param(hidden, dim, device=device)
        self.b2 = param(dim, device=device)


class _PatchEmbed(nn.Module):
    """flax ``nn.Conv`` parameters; ``kernel`` (p, p, channels, d) arrives
    with ``ViT.size_from_input``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.bias = param(dim, device=device)


def attention_core(qkv: torch.Tensor, n_heads: int, dtype) -> torch.Tensor:
    """[b, s, 3d] -> [b, s, d]: JAX's einsum chain over the heads."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    q, k, v = qkv.reshape(b, s, 3, n_heads, hd).unbind(2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    probs = torch.softmax(logits.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)


class ViT(nn.Module):
    """``forward(x)`` NHWC images -> float32 logits. ``input_shape`` (H, W,
    C) sizes ``patch_embed``'s kernel and ``pos_embed`` (flax sizes them
    from ``init``'s example input); without it ``size_from_input`` runs
    before the weights load."""

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12, n_heads: int = 12,
                 mlp_ratio: int = 4, num_classes: int = 1000, dtype="bfloat16",
                 input_shape: Optional[Sequence[int]] = None, device=None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} is not a multiple of n_heads {n_heads}")
        self.patch, self.dim, self.depth, self.n_heads = patch, dim, depth, n_heads
        self.num_classes = num_classes
        self.dtype = to_torch_dtype(dtype)
        self.patch_embed = _PatchEmbed(dim, device)
        self.cls = param(1, 1, dim, device=device)
        for i in range(depth):
            self.add_module(f"ln1_{i}", LayerNorm(dim, device))
            self.add_module(f"attn_{i}", _Attention(dim, device))
            self.add_module(f"ln2_{i}", LayerNorm(dim, device))
            self.add_module(f"mlp_{i}", _Mlp(dim, dim * mlp_ratio, device))
        self.ln_final = LayerNorm(dim, device)
        self.head = param(dim, num_classes, device=device)
        if input_shape is not None:
            self.size_from_input(input_shape)

    def size_from_input(self, input_shape: Sequence[int]) -> "ViT":
        """Create ``patch_embed.kernel`` and ``pos_embed`` for per-sample
        images of ``input_shape`` (H, W, C): SAME padding at stride
        ``patch`` gives ceil(H / p) x ceil(W / p) tokens, plus ``cls``."""
        h, w, c = (int(v) for v in input_shape)
        tokens = -(-h // self.patch) * -(-w // self.patch) + 1
        dev = self.cls.device
        want = {"patch_embed.kernel": (self.patch, self.patch, c, self.dim),
                "pos_embed": (1, tokens, self.dim)}
        have = {n: tuple(t.shape) for n, t in self.leaves().items() if n in want}
        if have:
            if have != want:
                raise ValueError(f"ViT sized for {have}, not the input {tuple(input_shape)}")
            return self
        self.patch_embed.kernel = param(*want["patch_embed.kernel"], device=dev)
        self.pos_embed = param(*want["pos_embed"], device=dev)
        return self

    # -- parameters -------------------------------------------------------
    def leaves(self) -> Leaves:
        """``{leaf name: tensor or QuantizedTensor}`` of every weight."""
        return leaves(self)

    def param_tree(self):
        return param_tree(self)

    def init_params(self, generator: Optional[torch.Generator] = None) -> "ViT":
        return init_live_(self, generator)

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """``{leaf name: logical axes}``: the flax module's ``params_axes``
        (``param_with_axes``); the patch conv and the LayerNorms declare
        none and replicate."""
        table = {"cls": (None, None, "embed"), "pos_embed": (None, None, "embed"),
                 "head": ("embed", "vocab")}
        for i in range(self.depth):
            table.update({f"attn_{i}.wqkv": ("embed", "heads"), f"attn_{i}.wo": ("heads", "embed"),
                          f"mlp_{i}.w1": ("embed", "mlp"), f"mlp_{i}.b1": ("mlp",),
                          f"mlp_{i}.w2": ("mlp", "embed"), f"mlp_{i}.b2": ("embed",)})
        return table

    def shard(self, mesh, rules=None) -> "ShardedViT":
        return ShardedViT(self, mesh, rules)

    # -- forward ----------------------------------------------------------
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train   # no train-only ops (no dropout), as in the flax module
        t = self.leaves()
        return vit_forward(t, self.config(), x, [t], {})

    def config(self) -> Dict[str, Any]:
        return dict(patch=self.patch, dim=self.dim, depth=self.depth, n_heads=self.n_heads,
                    dtype=self.dtype)


def _ln(t: Leaves, name: str, x: torch.Tensor, dtype) -> torch.Tensor:
    return layer_norm(x, t[f"{name}.scale"], t[f"{name}.bias"], dtype)


def _embed(t: Leaves, cfg, x: torch.Tensor) -> torch.Tensor:
    dt, p = cfg["dtype"], cfg["patch"]
    x = x.to(dt)
    kernel = leaf(t["patch_embed.kernel"], dt).permute(3, 2, 0, 1)   # HWIO -> OIHW
    x = conv(x, kernel, leaf(t["patch_embed.bias"], dt), p, same_pads(tuple(x.shape[1:3]), p, p))
    b, h, w, d = x.shape
    x = x.reshape(b, h * w, d)
    cls = leaf(t["cls"], dt).expand(b, 1, d)
    return torch.cat([cls, x], dim=1) + leaf(t["pos_embed"], dt)


def vit_forward(t: Leaves, cfg, x: torch.Tensor, ranks: Sequence[Leaves],
                specs: Dict[str, Tuple]) -> torch.Tensor:
    """The forward over leaves ``t`` (replicated ones read from it) and
    ``ranks`` (one tree a 'model' rank, in rank order; ``[t]`` unsharded):
    a leaf whose ``specs`` entry cuts its last dim over 'model' runs one
    column product a rank, gathered (``wqkv``, the head) or kept per rank
    into the matching row cut (``w1`` then ``w2``); a row cut's (``wo``,
    ``w2``) partials are summed in float32 in rank order (int8 ones
    written in float32 by K4)."""
    dt = cfg["dtype"]

    def cut(name, axis):
        s = specs.get(name, ())
        return len(ranks) > 1 and len(s) > 0 and s[axis] == "model"

    def row_product(h_parts, name):
        partials = [linear(hp, r[name], torch.float32) for hp, r in zip(h_parts, ranks)]
        return collectives.all_reduce(partials, dt)[0]

    x = _embed(t, cfg, x)
    for i in range(cfg["depth"]):
        a, m = f"attn_{i}", f"mlp_{i}"
        y = _ln(t, f"ln1_{i}", x, dt)
        if cut(f"{a}.wqkv", -1):
            qkv = collectives.all_gather([linear(y, r[f"{a}.wqkv"]) for r in ranks])[0]
        else:
            qkv = linear(y, t[f"{a}.wqkv"])
        out = attention_core(qkv, cfg["n_heads"], dt)
        if cut(f"{a}.wo", 0):
            x = x + row_product(out.chunk(len(ranks), dim=-1), f"{a}.wo")
        else:
            x = x + linear(out, t[f"{a}.wo"])
        y = _ln(t, f"ln2_{i}", x, dt)
        if cut(f"{m}.w1", -1) and cut(f"{m}.w2", 0):
            hs = [F.gelu(linear(y, r[f"{m}.w1"]) + leaf(r[f"{m}.b1"], dt), approximate="tanh")
                  for r in ranks]
            x = x + (row_product(hs, f"{m}.w2") + leaf(t[f"{m}.b2"], dt))
        else:
            h = F.gelu(linear(y, t[f"{m}.w1"]) + leaf(t[f"{m}.b1"], dt), approximate="tanh")
            x = x + (linear(h, t[f"{m}.w2"]) + leaf(t[f"{m}.b2"], dt))
    x = _ln(t, "ln_final", x, dt)[:, 0]
    if cut("head", -1):
        return collectives.all_gather([float32_head(x, r["head"]) for r in ranks])[0]
    return float32_head(x, t["head"])


class ShardedViT(nn.Module):
    """A filled ``ViT`` over a co-located mesh: ``shard_params`` cuts its
    leaves by the rule table (one rank-local tree a rank, ``rank_trees``),
    and ``forward`` runs each 'data' block of rows (``torch.tensor_split``:
    the server's buckets make them even) through ``vit_forward`` over that
    block's 'model' ranks. ``wqkv``'s column cut over 'model' is not a cut
    by heads (rank 0 holds all of q and part of k), so the ranks' qkv
    columns are gathered before the attention, which then runs once for
    the block, as GSPMD reshards after the product; ``wo``'s row cut then
    takes each rank's columns of the attention's output. Ranks that differ
    along another axis hold the same leaves; the controller runs one."""

    def __init__(self, model: ViT, mesh, rules=None):
        super().__init__()
        from seldon_core_tpu_torch.parallel.sharding import DEFAULT_LOGICAL_RULES, shard_params

        self.mesh = mesh
        self.cfg = model.config()
        self.dtype = model.dtype
        self.rank_trees = shard_params(model.leaves(), mesh, model.logical_axes(),
                                       rules if rules is not None else DEFAULT_LOGICAL_RULES)
        groups: Dict[int, list] = {}   # per 'data' index, its 'model' ranks' trees in order
        for r in range(mesh.size):
            c = mesh.coords(r)
            if all(v == 0 for a, v in c.items() if a not in ("data", "model")):
                groups.setdefault(c.get("data", 0), []).append(self.rank_trees[r])
        self._groups = [groups[d] for d in sorted(groups)]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train
        specs = self.rank_trees.specs
        outs = [vit_forward(trees[0], self.cfg, part, trees, specs)
                for part, trees in zip(torch.tensor_split(x, len(self._groups), dim=0),
                                       self._groups) if part.shape[0]]
        return torch.cat(outs, dim=0)


def _make(dims: Dict[str, int], num_classes, dtype, input_shape, device) -> ViT:
    dev = device if str(device) == "meta" else resolve_device(device)
    return ViT(**dims, num_classes=num_classes, dtype=dtype, input_shape=input_shape, device=dev)


@register_model("vit-b16")
def make_vit_b16(num_classes: int = 1000, dtype: str = "bfloat16", input_shape=None,
                 device=None):
    return _make({}, num_classes, dtype, input_shape, device)


@register_model("vit-tiny")
def make_vit_tiny(num_classes: int = 10, dtype: str = "float32", input_shape=None, device=None,
                  **kwargs):
    """Small config for tests."""
    return _make(dict(dict(patch=4, dim=32, depth=2, n_heads=2), **kwargs), num_classes, dtype,
                 input_shape, device)


__all__ = ["ShardedViT", "ViT", "attention_core", "vit_forward"]
