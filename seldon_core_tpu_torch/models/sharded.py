"""The transformer over a mesh: tensor, sequence, expert and data
parallelism run by one controller.

The JAX package shards its transformer with GSPMD: params placed by
logical axes (``parallel/sharding.py``), the dense KV cache by
``_cache_shardings``, and XLA inserts the collectives. The port runs a
co-located mesh (``parallel/mesh.py``: every rank on one device) from one
thread: ``ShardedTransformer`` holds one rank-local ``Transformer`` a mesh
rank, each with its own leaves (cut by ``shard_params``: contiguous
copies, ranks that hold the same shard share it), and its forward loops
over the ranks op by op, each rank's kernels at its shard's shapes, with
the sums of ``parallel/collectives.py`` between them:

- **'model'** (Megatron): each rank runs its ``h/tp`` query heads and
  their KV heads (``kvh/tp``, or where ``kvh % tp != 0`` the one KV head its
  query heads share: the q -> kv grouping is kept), and its ``ffn/tp``
  columns. ``wo`` and ``w2`` are row shards whose partial outputs are
  all-reduced (float32, rank order; int8 shards write their partials in
  float32, ``f32_partials``) before K2 adds the residual on every rank. The embedding is vocab-parallel (each rank looks up the ids in its
  range, zero elsewhere, then a sum); the logits are vocab shards gathered
  before sampling. A dim the axis does not divide stays whole (replicated).
- **'expert'**: MoE experts split over it (their ``mlp`` dim over
  'model'); the router's logits are gathered before ``route``, each rank
  weights its own experts, and the FFN output is summed over 'model' and
  'expert'.
- **'seq'**: a dense cache's positions split into ``sp`` contiguous ranges,
  one tensor a rank; each rank writes the tokens whose cache slot falls in
  its range and attends over its range, and the ranges' softmaxes merge by
  log-sum-exp. Activations are replicated over 'seq' (each rank computes
  them, as GSPMD does).
- **'data'**: rows split into contiguous blocks where the axis divides the
  batch, else every data rank runs every row.

Caches: the model makes its own (``init_caches``, the call
``Transformer`` answers with one set): a ``RankCaches``, a flat list of
one layer tuple a (rank, layer), rank-major, so code that walks "every
layer tuple" (a byte count) walks every rank's, plus the global ``lead``
(rows, positions) or (pages, page_size).

Paged pools (the batcher's): each (data, seq) rank pair owns a pool of its
own pages (its 'model' ranks hold their KV heads of it), and the pages
share ONE id space partitioned by pool: pool p = data * sp + seq holds the
global ids ``RESERVED_PAGES + p * cap ..`` (cap = a pool's pages less the
reserved ones), at local ids ``RESERVED_PAGES ..``; NULL_PAGE and
TRASH_PAGE are every pool's own. The batcher's block table names global
ids; a data rank's slots take pages of its pools only, and a sequence's
page j lies on seq rank ``j mod sp`` (round robin: page growth adds one
page to one rank). The forward cuts one table a rank from it
(``rank_tables``: the rank's rows, its columns ``seq::sp``, ids made
local, another pool's page TRASH_PAGE), and code that writes a pool
directly asks ``pool_ranks``. Under 'seq' each rank writes the tokens of
its pages and attends over them (a decode or a verify through K1's
partial mode, a chunk through the gathered view), and the ranks merge by
log-sum-exp. A batch 'data' does not divide (the one-row prefill chunk)
runs on every data rank, the others' writes land in their TRASH_PAGE,
and each row's logits come from the rank that owns its first page.

The dense batcher's slot pool (``init_slot_caches``): rows over 'data',
and under 'seq' each rank holds ``n = ceil(width / sp)`` positions and a
trash column of its own (a ``RankCaches`` with ``width``), so the global
length always splits and every rank drops its out-of-range writes there.
``slot_rows`` gives one slot's row on every rank (the one-row admission
prefill runs on every data rank: each reads and writes its peer's row on
the owning data rank, the same values, since the ranks share the device
and the data ranks the weights); ``slot_columns`` places positions for the
verify's reject repair.

LoRA (``adapters``, the pool of ``runtime/adapters.py``): each rank reads
views of the one pool, so a row written in place reaches every rank.
On a column-parallel projection (q, w1, w3) a rank adds ``x A B[:, its
columns]``; on a row-parallel one (o, w2) it adds ``x_r A[its rows] B``,
a share of the delta, so the delta enters the float32 all-reduce once.

Training (``train_blocks``, driven by ``parallel/train.py``): the
cache-less forward with rows over 'data' and positions over 'seq', each
rank holding its block of activations; attention gathers K/V over 'seq'
(``"full"``) or runs the ring (``"ring"``). One ``nn.Parameter`` a distinct
shard (ranks that hold the same tensor share it), so autograd sums a
replicated shard's partial gradients into one ``.grad``; ``leaf_shards``
maps each logical leaf to its shards.

Not here (ROADMAP Queue A 9b): ranks on distinct devices (their
transport).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from seldon_core_tpu_torch.models.transformer import (
    PAD_POS, RESERVED_PAGES, TRASH_PAGE, Transformer, TransformerConfig, attention_logits,
    cache_values, dense_view, gather_paged_view, init_kv_caches, init_paged_kv_caches,
    paged_write_targets, write_dense)
from seldon_core_tpu_torch.ops.quantize import QuantizedTensor, dequantize_array
from seldon_core_tpu_torch.parallel import collectives
from seldon_core_tpu_torch.parallel.sharding import DEFAULT_LOGICAL_RULES, shard_params


class RankCaches(list):
    """The caches of a sharded model: ``[rank * n_layers + layer]`` is that
    rank's layer tuple (rank-local shapes); ``lead`` is the global (rows,
    positions) a dense cache covers, (pages, page_size) for a pool.
    ``width``: a dense slot pool's positions (``init_slot_caches``), whose
    buffers each end in a trash column; None otherwise."""

    def __init__(self, layers, lead: Tuple[int, int], width: Optional[int] = None):
        super().__init__(layers)
        self.lead = tuple(int(x) for x in lead)
        self.width = None if width is None else int(width)


def _split(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


def head_layout(cfg: TransformerConfig, mesh) -> Tuple[int, int, bool, bool]:
    """(query heads a rank, KV heads a rank, heads split, KV heads split)
    under the default rules: the query heads split over 'model' where it
    divides them; the KV heads too, else each rank keeps the one KV head
    its query heads share (when they all share one), else every head stays
    whole."""
    tp = mesh.axis_size("model")
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    if not _split(h, tp):
        return h, kvh, False, False
    h_l = h // tp
    if _split(kvh, tp):
        return h_l, kvh // tp, True, True
    group = h // kvh
    if group % h_l:
        raise ValueError(
            f"tensor_parallel={tp} splits {h} query heads into {h_l} a rank, which do not "
            f"fall within one group of the {kvh} KV heads (group size {group}): choose a "
            f"tensor_parallel that divides the KV heads, or whose query share lies in one group")
    return h_l, 1, True, False


def _kv_start(cfg: TransformerConfig, mesh, coords: Dict[str, int]) -> int:
    """The first KV head rank ``coords`` holds."""
    h_l, kvh_l, split_h, split_kv = head_layout(cfg, mesh)
    m = coords.get("model", 0)
    if split_kv:
        return m * kvh_l
    if split_h:
        return (m * h_l) // (cfg.n_heads // cfg.n_kv_heads)
    return 0


def _select_columns(leaf, start: int, width: int):
    """Columns ``[start, start + width)`` of a [K, N] leaf as a contiguous
    copy (a quantized leaf's codes and scales alike)."""
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(leaf.q[:, start:start + width].contiguous(),
                               leaf.scale[start:start + width].contiguous(), leaf.orig_dtype)
    return leaf[:, start:start + width].contiguous()


class ShardedTransformer(nn.Module):
    """``model`` (a filled ``Transformer``: float, or quantized before
    sharding as the JAX package orders it) over ``mesh``; ``rules`` are the
    logical rules (default ``DEFAULT_LOGICAL_RULES``). Its ``cfg`` is the
    model's; its forward takes ``Transformer.forward``'s
    arguments with ``RankCaches`` for caches and returns the full logits."""

    def __init__(self, model: Transformer, mesh, rules=None):
        super().__init__()
        mesh.require_colocated()
        cfg = model.cfg
        self.mesh = mesh
        self.cfg = cfg
        hd = cfg.head_dim
        rules = tuple(rules) if rules is not None else DEFAULT_LOGICAL_RULES
        self.rank_trees = shard_params(model.leaves(), mesh, model.logical_axes(), rules,
                                       units={"heads": hd, "kv_heads": hd})
        specs = self.rank_trees.specs

        def cut(name: str, dim: int) -> bool:
            # the leaf's dim splits over axes of more than one rank
            axes = specs[name][dim]
            axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
            return math.prod(mesh.axis_size(a) for a in axes) > 1

        self.heads_split = cut("layer_0.attention.wq", 1)
        h_l, kvh_l, split_h, split_kv = head_layout(cfg, mesh)
        if self.heads_split != split_h or cut("layer_0.attention.wk", 1) != split_kv:
            raise ValueError("custom sharding rules that split the query and KV heads "
                             "differently from the default rules are not supported")
        self.vocab_split = cut("tok_embeddings", 0)
        self.mlp_split = cut(f"layer_0.{'moe' if cfg.n_experts else 'ffn'}.w2",
                             1 if cfg.n_experts else 0)
        self.expert_split = cfg.n_experts > 0 and cut("layer_0.moe.w1", 0)
        self.router_split = cfg.n_experts > 0 and cut("layer_0.moe.router", 1)
        tp, ep = mesh.axis_size("model"), mesh.axis_size("expert")
        local = dataclasses.replace(
            cfg, mesh=None, attn_head_dim=hd, n_heads=h_l, n_kv_heads=kvh_l,
            ffn_dim=cfg.ffn_dim // tp if self.mlp_split else cfg.ffn_dim,
            vocab_size=cfg.vocab_size // tp if self.vocab_split else cfg.vocab_size,
            n_experts=cfg.n_experts // ep if self.expert_split else cfg.n_experts,
            f32_partials=True)
        self.local_cfg = local
        ranks = []
        # the KV columns a rank selects where 'model' splits the query heads
        # but not the KV heads (ranks of one group share the selection),
        # and one Parameter a shard: ranks that hold the same tensor hold
        # the same Parameter, so a training step's partial gradients of a
        # replicated shard accumulate into one .grad
        self._kv_columns: Dict[int, int] = {}
        selected: Dict[Tuple[str, int], object] = {}
        shared: Dict[int, nn.Parameter] = {}
        for r, tree in enumerate(self.rank_trees):
            if not split_kv and split_h:
                start = self._kv_columns[r] = _kv_start(cfg, mesh, mesh.coords(r)) * hd
                tree = dict(tree)
                for i in range(cfg.n_layers):
                    for w in ("wk", "wv"):
                        name = f"layer_{i}.attention.{w}"
                        if (name, start) not in selected:
                            selected[name, start] = _select_columns(tree[name], start, hd)
                        tree[name] = selected[name, start]
            ranks.append(self._rank_module(local, tree, shared))
        self.ranks = nn.ModuleList(ranks)
        self.eval()

    @staticmethod
    def _rank_module(local: TransformerConfig, tree: Dict[str, object],
                     shared: Dict[int, nn.Parameter]) -> Transformer:
        """A rank-local ``Transformer`` whose leaves are ``tree``'s tensors
        (no copy: built on the meta device, then each leaf installed; a
        float leaf as the Parameter ``shared`` holds for that tensor)."""
        module = Transformer(local, device=torch.device("meta"))
        for name, t in tree.items():
            owner, leaf = module._owner(name)
            delattr(owner, leaf)
            if isinstance(t, QuantizedTensor):
                owner.add_module(leaf, t)
            else:
                if id(t) not in shared:
                    shared[id(t)] = nn.Parameter(t, requires_grad=False)
                owner.register_parameter(leaf, shared[id(t)])
        return module

    def leaf_shards(self) -> Dict[str, List[Tuple[nn.Parameter, Tuple[slice, ...]]]]:
        """``{leaf name: [(shard, its index in the logical leaf)]}``: each
        distinct float shard once, in rank order. The indices of a leaf's
        shards cover the logical leaf once, so a leaf gathers, scatters and
        counts (a gradient's norm) from them."""
        specs, hd = self.rank_trees.specs, self.cfg.head_dim
        out: Dict[str, List[Tuple[nn.Parameter, Tuple[slice, ...]]]] = {}
        seen = set()
        for r, module in enumerate(self.ranks):
            coords = self.mesh.coords(r)
            for name, t in module.leaves().items():
                if isinstance(t, QuantizedTensor) or id(t) in seen:
                    continue
                seen.add(id(t))
                index = []
                for dim, axis in enumerate(specs[name]):
                    n = t.shape[dim]
                    split = axis is not None and self.mesh.axis_size(axis) > 1
                    index.append(slice(coords[axis] * n, (coords[axis] + 1) * n) if split
                                 else slice(None))
                if r in self._kv_columns and name.endswith(("attention.wk", "attention.wv")):
                    start = self._kv_columns[r]
                    index[1] = slice(start, start + hd)
                out.setdefault(name, []).append((t, tuple(index)))
        return out

    # ------------------------------------------------------------------
    # The caches: ``Transformer``'s four calls, one set a rank
    def init_caches(self, lead: Tuple[int, int], kv_cache_dtype: Optional[str] = None,
                    device=None, paged: bool = False) -> RankCaches:
        """Each rank's layer tuples at its local shapes, in the empty state:
        its KV heads, and for a dense cache its ``cache_share`` of the
        (rows, positions) ``lead``; a paged pool of (pages, page_size)
        splits only its KV heads. ``device`` defaults to each rank's."""
        kv_cfg = dataclasses.replace(self.cfg, n_kv_heads=self.local_cfg.n_kv_heads,
                                     n_heads=self.local_cfg.n_kv_heads,
                                     attn_head_dim=self.cfg.head_dim)
        init = init_paged_kv_caches if paged else init_kv_caches
        local = self.pool_share(lead) if paged else self.cache_share(lead)
        out: List[tuple] = []
        for dev in self.mesh.rank_devices():
            out += init(kv_cfg, *local, kv_cache_dtype,
                        device=device if device is not None else dev)
        return RankCaches(out, lead)

    def page_pools(self) -> int:
        """The paged pools the mesh holds: one a (data, seq) rank pair."""
        return self.mesh.axis_size("data") * self.mesh.axis_size("seq")

    def pool_share(self, lead: Tuple[int, int]) -> Tuple[int, int]:
        """A rank's pool of the global (pages, page_size) ``lead``: the
        pages past the reserved ones split evenly over ``page_pools()``."""
        pages, ps = lead
        n = self.page_pools()
        if (pages - RESERVED_PAGES) % n:
            raise ValueError(f"a paged pool of {pages} pages does not split into {n} (data, seq) "
                             f"pools of equal size beyond the {RESERVED_PAGES} reserved pages")
        return (pages - RESERVED_PAGES) // n + RESERVED_PAGES, ps

    def _pool(self, r: int) -> int:
        c = self.mesh.coords(r)
        return c.get("data", 0) * self.mesh.axis_size("seq") + c.get("seq", 0)

    @staticmethod
    def _cap(caches) -> int:
        return caches[0][-1].shape[0] - RESERVED_PAGES

    def local_pages(self, r: int, pages: torch.Tensor, cap: int) -> torch.Tensor:
        """Rank ``r``'s ids of the global page ids ``pages`` (pools of
        ``cap`` pages past the reserved ones): its own pool's pages at local
        ids, NULL_PAGE and TRASH_PAGE as they are, any other pool's page
        TRASH_PAGE. One pool: ``pages`` itself."""
        if self.page_pools() == 1:
            return pages
        local = pages - self._pool(r) * cap
        mine = (local >= RESERVED_PAGES) & (local < RESERVED_PAGES + cap)
        return torch.where(mine, local,
                           torch.where(pages < RESERVED_PAGES, pages, TRASH_PAGE).to(pages.dtype))

    def pool_ranks(self, caches, pages: torch.Tensor):
        """[(layer tuples, page ids)] (``Transformer.pool_ranks``): every
        rank's layers with its ids of ``pages``; one pool: all of them at
        ``pages``."""
        if self.page_pools() == 1:
            return [(caches, pages)]
        L, cap = self.cfg.n_layers, self._cap(caches)
        return [(caches[r * L:(r + 1) * L], self.local_pages(r, pages, cap))
                for r in range(self.mesh.size)]

    def rank_tables(self, block_tables: torch.Tensor, caches, rows) -> List[torch.Tensor]:
        """Each rank's block table: its ``rows`` of the global table, under
        'seq' its columns ``seq::sp``, at its local ids (``local_pages``)."""
        sp, cap = self.mesh.axis_size("seq"), self._cap(caches)
        out = []
        for r, sl in enumerate(rows):
            t = block_tables[sl]
            if sp > 1:
                t = t[:, self.mesh.coords(r)["seq"]::sp]
            t = self.local_pages(r, t, cap)
            out.append(t if t.is_contiguous() else t.contiguous())
        return out

    def _owner_rows(self, block_tables: torch.Tensor, caches) -> torch.Tensor:
        """[b] the data rank owning each row: the one whose pools hold its
        first page."""
        first = block_tables[:, 0].long() - RESERVED_PAGES
        per_data = self._cap(caches) * self.mesh.axis_size("seq")
        return torch.div(first.clamp(min=0), per_data, rounding_mode="floor")

    def _rank_adapters(self, adapters) -> List[Optional[dict]]:
        """Each rank's views of the LoRA pool (module docstring): B's
        columns of a column-parallel projection, A's rows of a row-parallel
        one, where 'model' splits the base weight."""
        R = self.mesh.size
        if adapters is None:
            return [None] * R
        hd, tp = self.cfg.head_dim, self.mesh.axis_size("model")
        width = {"wq": hd * self.local_cfg.n_heads if self.heads_split else 0,
                 "wo": hd * self.local_cfg.n_heads if self.heads_split else 0,
                 "w1": self.local_cfg.ffn_dim if self.mlp_split else 0,
                 "w2": self.local_cfg.ffn_dim if self.mlp_split else 0}
        width["w3"] = width["w1"]
        out = []
        for r in range(R):
            m = self.mesh.coords(r).get("model", 0)
            view = {"scale": adapters["scale"]}
            for proj, ab in adapters.items():
                if proj == "scale":
                    continue
                A, B = ab
                w = width.get(proj, 0)
                if w and tp > 1 and proj in ("wo", "w2"):
                    A = A[:, :, m * w:(m + 1) * w]
                elif w and tp > 1:
                    B = B[..., m * w:(m + 1) * w]
                view[proj] = (A, B)
            out.append(view)
        return out

    @staticmethod
    def _layer_adapters(view: Optional[dict], i: int) -> Optional[dict]:
        if view is None:
            return None
        out = {proj: (ab[0][:, i], ab[1][:, i]) for proj, ab in view.items() if proj != "scale"}
        out["scale"] = view["scale"]
        return out

    def prepare_head_(self) -> "ShardedTransformer":
        """Every rank's ``Transformer.prepare_head_``."""
        for module in self.ranks:
            module.prepare_head_()
        return self

    def cache_share(self, lead: Tuple[int, int]) -> Tuple[int, int]:
        """A rank's share of a dense cache's (rows, positions): rows over
        'data' and positions over 'seq', each where the axis divides it."""
        rows, length = lead
        dp, sp = self.mesh.axis_size("data"), self.mesh.axis_size("seq")
        return (rows // dp if _split(rows, dp) else rows,
                length // sp if _split(length, sp) else length)

    @staticmethod
    def wrap_caches(layers: List[tuple], lead: Tuple[int, int]) -> RankCaches:
        """``layers`` (one tuple a (rank, layer), each at its
        ``cache_share``) as the ``RankCaches`` of the global ``lead``."""
        return RankCaches(layers, lead)

    @staticmethod
    def cache_lead(caches) -> Tuple[int, ...]:
        """The global (rows, positions) or (pages, page_size) ``caches``
        cover (a slot pool's positions: its ``width``)."""
        return caches.lead if caches.width is None else (caches.lead[0], caches.width)

    def init_slot_caches(self, slots: int, width: int, kv_cache_dtype: Optional[str] = None,
                         device=None) -> RankCaches:
        """The batcher's dense slot pool over the mesh (``Transformer.
        init_slot_caches``): rows over 'data', positions over 'seq'. Each
        'seq' rank holds ``n = ceil(width / sp)`` positions, ``[seq * n,
        (seq + 1) * n)``, and a trash column of its own after them, so the
        global length ``sp * (n + 1)`` always splits (``width + 1`` may not)
        and every rank drops its out-of-range writes into its own trash
        column, whose position stays PAD_POS."""
        width, sp = int(width), self.mesh.axis_size("seq")
        caches = self.init_caches((slots, sp * (-(-width // sp) + 1)), kv_cache_dtype, device)
        caches.width = width
        return caches

    def _row_blocks(self, rows: int) -> int:
        """Rows a 'data' rank holds of a cache of ``rows`` (all of them
        where 'data' does not divide it)."""
        dp = self.mesh.axis_size("data")
        return rows // dp if _split(rows, dp) else rows

    def slot_rows(self, caches: RankCaches, slot: int) -> RankCaches:
        """Row ``slot`` of a slot pool as a pool of one row, on every rank
        (``Transformer.slot_rows``): the row lives on one 'data' rank, and
        a one-row forward runs on every data rank (``_rows``), so each
        rank's entry is its (seq, model) peer's view of the row on the
        owning data rank. The ranks share one device and the data ranks
        the same weights, so the duplicate writes of the same values are
        harmless, and each rank reads what the owner holds."""
        L, per = self.cfg.n_layers, self._row_blocks(caches.lead[0])
        owner, local = divmod(int(slot), per)
        peers = {}
        for r in range(self.mesh.size):
            c = self.mesh.coords(r)
            peers[tuple(sorted(c.items()))] = r
        out: List[tuple] = []
        for r in range(self.mesh.size):
            c = dict(self.mesh.coords(r))
            if "data" in c:
                c["data"] = owner
            r0 = peers[tuple(sorted(c.items()))]
            out += [tuple(t[local:local + 1] for t in layer)
                    for layer in caches[r0 * L:(r0 + 1) * L]]
        return RankCaches(out, (1, caches.lead[1]), caches.width)

    def slot_columns(self, caches: RankCaches, positions: torch.Tensor):
        """[(layer tuples, rows, columns)] (``Transformer.slot_columns``):
        each rank's layers, its rows of ``positions`` [slots, c] and their
        local columns in its range, the rest at its trash column."""
        from seldon_core_tpu_torch.models.transformer import _per_sequence_columns

        L, w = self.cfg.n_layers, caches.width
        out = []
        for r in range(self.mesh.size):
            n = caches[r * L][-1].shape[1] - 1
            rows = self._rows(r, positions.shape[0])
            cols = _per_sequence_columns(positions[rows].long(),
                                         self.mesh.coords(r).get("seq", 0) * n, n, w)
            out.append((caches[r * L:(r + 1) * L], rows, cols))
        return out

    # ------------------------------------------------------------------
    def _reduce(self, parts: List[torch.Tensor], axes) -> List[torch.Tensor]:
        """All-reduce ``parts`` (one a rank) over the mesh ``axes`` into the
        compute dtype (no axis: each part cast)."""
        dt = self.cfg.dtype
        if not axes:
            return [p.to(dt) for p in parts]
        out = list(parts)
        for group in self.mesh.groups(axes):
            for r, t in zip(group, collectives.all_reduce([parts[r] for r in group], dt)):
                out[r] = t
        return out

    def _gather(self, parts: List[torch.Tensor], axes, dim: int = -1) -> List[torch.Tensor]:
        out = list(parts)
        for group in self.mesh.groups(axes):
            for r, t in zip(group, collectives.all_gather([parts[r] for r in group], dim)):
                out[r] = t
        return out

    def _rows(self, r: int, b: int) -> slice:
        dp = self.mesh.axis_size("data")
        if not _split(b, dp):
            return slice(None)
        d = self.mesh.coords(r).get("data", 0)
        return slice(d * (b // dp), (d + 1) * (b // dp))

    def _embed(self, r: int, tokens: torch.Tensor) -> torch.Tensor:
        """Rank ``r``'s embedding rows: its vocab range's rows, zero for
        ids outside it (vocab-parallel), or the whole lookup."""
        module = self.ranks[r]
        if not self.vocab_split:
            return module._embed(tokens)
        v_l = self.local_cfg.vocab_size
        ids = tokens.long() - self.mesh.coords(r).get("model", 0) * v_l
        inside = (ids >= 0) & (ids < v_l)
        rows = module._embed(ids.clamp(0, v_l - 1))
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    # ------------------------------------------------------------------
    def forward(self, tokens, positions=None, caches=None, cache_index=None,
                block_tables=None, adapters=None, adapter_ids=None, verify=False):
        """``Transformer.forward`` over the mesh: tokens [b, s]; ``caches``
        a ``RankCaches`` (updated in place), ``block_tables`` the global
        table of a paged pool (module docstring); returns (logits [b, s,
        vocab] float32, caches)."""
        if adapters is not None and adapter_ids is None:
            raise ValueError("adapters need adapter_ids (one id per sequence; 0 = identity)")
        mesh, L = self.mesh, self.cfg.n_layers
        R = mesh.size
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        if caches is not None and len(caches) != R * L:
            raise ValueError(f"sharded forward: {len(caches)} cache tuples for {R} ranks x "
                             f"{L} layers")
        if verify and (block_tables is None or caches is None):
            raise ValueError("verify=True reads a paged pool: pass caches and block_tables")
        sp = mesh.axis_size("seq")
        trash = getattr(caches, "width", None) is not None   # a slot pool
        seq_split = (caches is not None and block_tables is None and sp > 1
                     and caches[0][-1].shape[1] * sp == caches.lead[1])
        rows = [self._rows(r, b) for r in range(R)]
        tok = [tokens[sl] for sl in rows]
        pos = [positions[sl] for sl in rows]
        tables = ([None] * R if block_tables is None
                  else self.rank_tables(block_tables, caches, rows))
        folded = [None] * R
        if verify:
            # Transformer.forward's fold: each column a row of its own, a
            # PAD_POS column attending at its sequence's last real position
            real = positions != PAD_POS
            last = torch.where(real, positions, torch.zeros_like(positions)).amax(
                dim=1, keepdim=True)
            qpos = torch.where(real, positions, last)
            folded = [(tables[r].repeat_interleave(s, dim=0), qpos[rows[r]].reshape(-1, 1))
                      for r in range(R)]
        index = [cache_index[sl] if torch.is_tensor(cache_index) and cache_index.dim() == 1
                 else cache_index for sl in rows]
        ids = [None if adapter_ids is None else adapter_ids[sl] for sl in rows]
        views = self._rank_adapters(adapters)
        xs = [self._embed(r, tok[r]) for r in range(R)]
        if self.vocab_split:
            xs = self._reduce(xs, ("model",))
        for i in range(L):
            layers = [self.ranks[r].layers()[i] for r in range(R)]
            la = [self._layer_adapters(views[r], i) for r in range(R)]
            normed = [layers[r].attention_norm(xs[r]) for r in range(R)]
            if seq_split:
                hs = self._seq_attention(i, layers, normed, pos, caches, index, la, ids)
            elif block_tables is not None and sp > 1:
                hs = self._paged_seq_attention(i, layers, normed, pos, caches, tables, folded,
                                               la, ids)
            else:
                hs = [layers[r].attention(normed[r], pos[r],
                                          None if caches is None else caches[r * L + i],
                                          index[r], tables[r], adapters=la[r],
                                          adapter_ids=ids[r], paged_rows=folded[r],
                                          trash=trash)[0]
                      for r in range(R)]
            xs = self._finish_layer(layers, xs, hs, la, ids)
        logits = self._head(xs)
        firsts: Dict[Optional[int], int] = {}
        for r in range(R):
            firsts.setdefault(rows[r].start, r)
        if len(firsts) > 1:
            return torch.cat([logits[r] for _, r in sorted(firsts.items())], dim=0), caches
        dp = mesh.axis_size("data")
        if block_tables is None or dp == 1:
            return logits[0], caches
        # rows every data rank ran over its own pools: each row's logits
        # from the rank owning its pages
        owner = self._owner_rows(block_tables, caches)[:, None, None]
        out = logits[0]
        for r in range(R):
            d = mesh.coords(r).get("data", 0)
            if d and all(mesh.coords(q).get("data", 0) != d for q in range(r)):
                out = torch.where(owner == d, logits[r], out)
        return out, caches

    def _finish_layer(self, layers, xs: List[torch.Tensor], hs: List[torch.Tensor], la,
                      ids) -> List[torch.Tensor]:
        """A layer after each rank's attention output ``hs``: the sum over
        'model', K2's residual add + norm on every rank, the FFN (dense or
        MoE) and its sum over 'model' and 'expert', the residual add.
        Returns each rank's new activation."""
        cfg, R = self.cfg, self.mesh.size
        hs = self._reduce(hs, ("model",) if self.heads_split else ())
        xs, ffn_in = list(xs), []
        for r in range(R):
            if cfg.fused_norm:
                from seldon_core_tpu_torch.ops.fused_norm import fused_residual_rmsnorm

                xs[r], o = fused_residual_rmsnorm(xs[r], hs[r], layers[r].ffn_norm.weight,
                                                  cfg.norm_eps)
            else:
                xs[r] = xs[r] + hs[r]
                o = layers[r].ffn_norm(xs[r])
            ffn_in.append(o)
        if cfg.n_experts > 0:
            fs = self._moe(layers, ffn_in)
        else:
            fs = [layers[r].ffn(ffn_in[r], la[r], ids[r]) for r in range(R)]
        fs = self._reduce(fs, (("model",) if self.mlp_split else ())
                          + (("expert",) if self.expert_split else ()))
        return [xs[r] + fs[r] for r in range(R)]

    def _head(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's float32 logits over the whole vocabulary: the final
        norm, its head (a vocab shard, gathered over 'model')."""
        logits = [self.ranks[r]._logits(self.ranks[r].norm(xs[r])) for r in range(self.mesh.size)]
        return self._gather(logits, ("model",)) if self.vocab_split else logits

    # ------------------------------------------------------------------
    # The cache-less training forward
    def _cols(self, r: int, s: int) -> slice:
        sp = self.mesh.axis_size("seq")
        if sp == 1:
            return slice(0, s)
        if s % sp:
            raise ValueError(f"a training batch of {s} positions does not split over the "
                             f"{sp} 'seq' ranks")
        q = self.mesh.coords(r)["seq"]
        return slice(q * (s // sp), (q + 1) * (s // sp))

    def train_blocks(self, tokens: torch.Tensor) -> List[Tuple[slice, slice, torch.Tensor]]:
        """The cache-less forward of a training step (the counterpart of
        GSPMD under ``parallel/train.TRAIN_RULES``): rows over 'data' (where
        it divides the batch), positions over 'seq' (which must divide
        them): each rank embeds, projects and norms only its block of
        activations. Attention ``"full"`` gathers K, V and their positions
        over 'seq' before the masked read, as GSPMD inserts; ``"ring"`` runs
        ``ops/ring_attention.ring_attention_ranks`` over each 'seq' group.
        Heads, ffn columns, vocab and experts split over 'model' and
        'expert' as in ``forward``. Returns one (rows, positions, float32
        logits [rows, positions, vocab]) a distinct block of the batch, in
        rank order; ranks that differ along another axis compute the same
        block, and its first rank's logits stand for it."""
        from seldon_core_tpu_torch.ops.ring_attention import ring_attention_ranks
        from seldon_core_tpu_torch.models.transformer import masked_attention

        mesh, L, R = self.mesh, self.cfg.n_layers, self.mesh.size
        dt = self.local_cfg.dtype
        b, s = tokens.shape
        blocks = [(self._rows(r, b), self._cols(r, s)) for r in range(R)]
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        pos = [positions[sl] for sl in blocks]
        xs = [self._embed(r, tokens[blocks[r]]) for r in range(R)]
        if self.vocab_split:
            xs = self._reduce(xs, ("model",))
        none = [None] * R
        for i in range(L):
            layers = [self.ranks[r].layers()[i] for r in range(R)]
            qkv = [layers[r].attention.project(layers[r].attention_norm(xs[r]), pos[r])
                   for r in range(R)]
            outs: List[Optional[torch.Tensor]] = [None] * R
            for group in mesh.groups(("seq",)):
                qs = [qkv[r][0] for r in group]
                ks = [qkv[r][1].to(dt) for r in group]
                vs = [qkv[r][2].to(dt) for r in group]
                ps = [pos[r] for r in group]
                if self.cfg.attention_impl == "ring":
                    got = ring_attention_ranks(qs, ks, vs, ps, ps)
                else:
                    k_all = collectives.all_gather(ks, dim=1)[0]
                    v_all = collectives.all_gather(vs, dim=1)[0]
                    p_all = collectives.all_gather(ps, dim=1)[0]
                    got = [masked_attention(q, k_all, v_all, p_all[:, None, :] <= p[:, :, None])
                           for q, p in zip(qs, ps)]
                for r, o in zip(group, got):
                    outs[r] = o
            hs = [layers[r].attention.output(outs[r].flatten(2)) for r in range(R)]
            xs = self._finish_layer(layers, xs, hs, none, none)
        logits = self._head(xs)
        firsts: Dict[Tuple, int] = {}
        for r, (rows, cols) in enumerate(blocks):
            firsts.setdefault((rows.start, rows.stop, cols.start), r)
        return [(*blocks[r], logits[r]) for r in firsts.values()]

    def _moe(self, layers, ffn_in: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's MoE partial: the router's logits (gathered over
        'expert' when it splits them), ``route`` over all experts, the
        rank's experts weighted by their gates."""
        from seldon_core_tpu_torch.models.transformer import route

        R = self.mesh.size
        cfg = self.cfg
        k = min(cfg.n_experts_per_token, cfg.n_experts)
        if self.router_split:
            logits = []
            for r in range(R):
                router = layers[r].moe.router
                if isinstance(router, QuantizedTensor):
                    router = dequantize_array(router)
                logits.append(ffn_in[r].float() @ router.float())
            logits = self._gather(logits, ("expert",))
            dense = [route(logits[r], k)[0] for r in range(R)]
        else:   # the whole router on every rank: MoEFFN's own routing
            dense = [layers[r].moe.gates(ffn_in[r])[0] for r in range(R)]
        out = []
        e_l = self.local_cfg.n_experts
        for r in range(R):
            gates = dense[r]
            if self.expert_split:
                e0 = self.mesh.coords(r).get("expert", 0) * e_l
                gates = gates[..., e0:e0 + e_l]
            out.append(layers[r].moe.combine(ffn_in[r], gates))
        return out

    def _seq_attention(self, i: int, layers, normed, pos, caches, index, la,
                       ids) -> List[torch.Tensor]:
        """Attention over a dense cache whose positions split over 'seq':
        every rank projects its heads and writes the tokens whose cache slot
        lies in its range (``write_dense`` with the range; a slot pool's
        ranks each end in a trash column, ``init_slot_caches``), attends
        over its range, and the ranges merge by log-sum-exp; then ``wo``."""
        mesh, L, R = self.mesh, self.cfg.n_layers, self.mesh.size
        dt = self.local_cfg.dtype
        trash = caches.width is not None
        parts = []
        for r in range(R):
            att, p, cache = layers[r].attention, pos[r], caches[r * L + i]
            q, k, v = att.project(normed[r], p, la[r], ids[r])
            n = cache[-1].shape[1] - trash
            write_dense(cache, cache_values(cache, k, v, p), index[r],
                        lo=mesh.coords(r)["seq"] * n,
                        total=caches.width if trash else caches.lead[1], trash=trash)
            logits, v_all = attention_logits(q, *dense_view(cache, dt),
                                             cache[-1][:, None, :] <= p[:, :, None])
            parts.append(collectives.softmax_partial(logits, v_all))
        return self._merge_seq(layers, parts, la, ids)

    def _merge_seq(self, layers, parts, la, ids) -> List[torch.Tensor]:
        """The 'seq' ranks' (max, sum, acc) merged by log-sum-exp, then
        ``wo`` on each rank."""
        R, dt = self.mesh.size, self.local_cfg.dtype
        outs: List[Optional[torch.Tensor]] = [None] * R
        for group in self.mesh.groups(("seq",)):
            for r, o in zip(group, collectives.softmax_merge([parts[r] for r in group], dt)):
                outs[r] = o
        return [layers[r].attention.output(outs[r].flatten(2), la[r], ids[r]) for r in range(R)]

    def _paged_seq_attention(self, i: int, layers, normed, pos, caches, tables, folded, la,
                             ids) -> List[torch.Tensor]:
        """Attention over a paged pool whose sequences' pages spread over
        'seq' (module docstring): every rank projects its heads, writes the
        tokens of its own pages, and takes its share of the softmax: a
        decode step (s = 1) or a verify (its columns ``folded`` into rows)
        through K1's partial mode, a chunk through the gathered view of its
        pages; then the ranks merge."""
        from seldon_core_tpu_torch.ops.paged_attention import paged_attention_partial

        mesh, L, R = self.mesh, self.cfg.n_layers, self.mesh.size
        sp, dt = mesh.axis_size("seq"), self.local_cfg.dtype
        parts = []
        for r in range(R):
            att, p, cache, table = layers[r].attention, pos[r], caches[r * L + i], tables[r]
            seq = mesh.coords(r)["seq"]
            q, k, v = att.project(normed[r], p, la[r], ids[r])
            entry, off = paged_write_targets(table, p, cache[0].shape[1], sp, seq)
            for buf, val in zip(cache, cache_values(cache, k, v, p)):
                buf[entry, off] = val.to(buf.dtype)
            b, s, h, hd = q.shape
            if folded[r] is not None:
                m, l, acc = paged_attention_partial(q.reshape(b * s, 1, h, hd), cache,
                                                    *folded[r], sp, seq)
                parts.append((m.reshape(b, s, h).transpose(1, 2),
                              l.reshape(b, s, h).transpose(1, 2), acc.reshape(b, s, h, hd)))
            elif s == 1:
                parts.append(paged_attention_partial(q, cache, table, p, sp, seq))
            else:
                k_all, v_all, pos_view = gather_paged_view(cache, table, dt)
                parts.append(collectives.softmax_partial(*attention_logits(
                    q, k_all, v_all, pos_view[:, None, :] <= p[:, :, None])))
        return self._merge_seq(layers, parts, la, ids)

    # ------------------------------------------------------------------
    def weight_bytes(self) -> List[int]:
        """Each rank's weight bytes (a shard shared by ranks counts in each)."""
        out = []
        for module in self.ranks:
            n = 0
            for t in module.leaves().values():
                for a in ((t.q, t.scale) if isinstance(t, QuantizedTensor) else (t,)):
                    n += a.numel() * a.element_size()
            out.append(n)
        return out


__all__ = ["RankCaches", "ShardedTransformer", "head_layout"]
