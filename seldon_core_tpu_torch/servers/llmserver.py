"""LLM_SERVER: autoregressive text generation, ported to PyTorch.

Port of ``seldon_core_tpu/servers/llmserver.py``: the same constructor
arguments and defaults (plus ``device``), the byte tokenizer, ``load`` for a
randomly initialised model or converted JAX weights, the private dense
``generate()`` path, and the paged chunked-prefill / decode-step programs the
continuous batcher (``runtime/batcher.py``) drives. The programs are kept
as the JAX package keys them: ``generate()``'s ``_get_prefill(b, plen,
max_len)`` (the dense prefill) and ``_get_decode(b, max_len)`` (one dense
decode step, which the JAX package scans), the batcher's
``_get_prefill_chunk(chunk, n_pages)`` (one chunk of one prompt into the
paged pool) and ``_get_decode_step_paged(slots, n_pages, k)`` (k decode
steps, ``decode_fuse_steps``), and with speculative decoding
(``spec_mode``) ``_get_spec_step(slots, spec_k, hist_len, mode=...)`` (one
fused draft + verify step) and ``_get_draft_prefill(b, plen, max_len)``
(the draft model's prompt prefill). On the CPU every program runs eagerly.
On the card (``servers/step_graph.py``) the batcher captures its programs
once as CUDA graphs over its own buffers (a prefill graph per chunk length
it can produce, then decode graphs of K = 1 and K, or in spec mode the one
spec step) and replays them, one replay per prefill chunk, one per
dispatch; the draft prefill runs eagerly at admission; ``generate()`` runs
its prefill eagerly into the server's one dense buffer and replays the
decode step's graph of (batch bucket, max_len), captured at first use,
once per token.

Sampling chain (a decision of the port). The JAX package chains
``jax.random`` keys: one split per generated token, the first token drawn at
prefill. The port keeps that structure with a counter-based chain of its
own, computed with exact integer tensor ops so the same key gives the same
draw on the CPU and on the card: a key is a 32-bit value in an int64 tensor,
``split_keys`` derives (next key, draw key) by two rounds of an integer hash,
and the draw is a Gumbel-max over the top-k logits with noise hashed from the
draw key. It does not reproduce ``jax.random``'s bits. Inside the port the
same seed gives the same tokens through ``generate(seed=)`` (row 0 of a
batch) and through the batcher (``submit(seed=)``): both start from
``seed_key(seed)`` and sample through ``sample_tokens``, one split per token.
Greedy decoding (temperature <= 0) still advances the chain.

Prefix caching (``prefix_cache_size`` > 0) is served on both paths, as the
JAX package serves it: the batcher's radix trie over its page pool
(``runtime/radix.py``), and for a one-prompt ``generate()`` dense entries of
the longest prefilled prefix (``_prefix_lookup`` / ``_prefix_store``; an exact
hit skips the prefill, a partial hit prefills the suffix through
``_get_extend``). An entry is a copy of the dense buffer's caches taken
before the first decode step, since ``generate()`` decodes in place.

Weight-only int8 (``quantize="int8"``) and the int8 KV cache
(``kv_cache_dtype="int8"``) are served, alone or together, through every
path below.

Checkpoints (``model_uri``, ``draft_model_uri``): a directory of
``config.json`` + ``params.msgpack``, the JAX package's
``export_checkpoint(use_orbax=False)`` format, read without flax
(``models/checkpoint.py``). Batched LoRA (``lora_rank`` > 0): the adapter
pool of ``runtime/adapters.py``; every program the batcher runs is then the
adapted one (``lora=True``), which serves base traffic (id 0) bit-equal to
the unadapted program. ``generate()`` stays base-only, as in the JAX
package. Weighted-fair admission (``slo_class_weights``, ``tenant_weights``,
``tenant_quota(s)``) is the batcher's (``runtime/scheduler.py``). Knobs that
belong to later slices raise ``NotImplementedError`` naming the slice when
set to a non-default value; none is ignored silently.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_LEN_BUCKETS = (32, 128, 512, 2048)
DEFAULT_BATCH_BUCKETS = (1, 4, 8)


def bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; beyond the largest bucket, round up to a
    multiple of it (copied from ``seldon_core_tpu/utils.py``)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


class ByteTokenizer:
    """UTF-8 byte fallback tokenizer (ids 0..255): always available, exercises
    the full serving path without a vocab artifact. eos_id defaults to 0."""

    vocab_size = 256

    def __init__(self, eos_id: int = 0):
        self.eos_id = eos_id

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if 0 <= int(i) < 256 and int(i) != self.eos_id]
        return bytes(ids).decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Sampling chain (module docstring): exact 32-bit integer hashing that works
# alike on Python ints and int64 tensors, on the CPU and on the card.
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """(x * c) mod 2**32 for 0 <= x < 2**32, with every intermediate below
    2**49 so int64 tensor arithmetic never overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finaliser (xorshift-multiply, "lowbias32")."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The chain's starting key for a request seed."""
    return _mix32((int(seed) & _M32) ^ _GOLDEN)


def split_keys(keys):
    """(next key, draw key) — one split per generated token."""
    return _mix32(keys ^ 0x5BD1E995), _mix32(keys ^ 0x1B873593)


def fast_forward_key(seed: int, n_tokens: int) -> int:
    """A seeded request's key after ``n_tokens`` generated tokens: the
    chain takes exactly one split a token (the first token's at admission,
    then one a decode step), so ``n_tokens`` splits from ``seed_key(seed)``
    land on the key a slot held when it had delivered them. A fleet resume
    draws its next token from it (``ContinuousBatcher._first_key``)."""
    key = seed_key(seed)
    for _ in range(int(n_tokens)):
        key, _ = split_keys(key)
    return key


def sample_tokens(keys: torch.Tensor, logits: torch.Tensor, temperature,
                  top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Port of ``_slot_sampler``: per row, split the key, then greedy
    (temperature <= 0) or a temperature/top-k categorical draw. keys: [b]
    int64; logits: [b, vocab] float32. ``temperature`` is a 0-dim float32
    tensor on the logits' device: both tokens are computed and the choice
    is made on the device, as the JAX package's ``jnp.where`` makes it, so
    a CUDA graph holds the temperature as data (``generate()``, whose
    temperature is per call). ``None`` is greedy, chosen on the host by a
    caller whose temperature is fixed at or below 0 (the batcher), which
    skips the draw. A float is made into the tensor (for tests). The draw
    divides by the tensor: on the card a tensor divided by a Python scalar
    is a multiply by its reciprocal, which differs in the last bit, so
    every caller passes the same form and the same seed gives the same
    tokens on every path. Returns (next keys, tokens [b])."""
    if temperature is None:
        keys, _ = split_keys(keys)
        return keys, torch.argmax(logits, dim=-1)
    if not torch.is_tensor(temperature):
        temperature = torch.full((), float(temperature), dtype=torch.float32,
                                 device=logits.device)
    elif temperature.device != logits.device or temperature.dim() != 0:
        raise ValueError(f"temperature must be a 0-dim tensor on {logits.device}, got "
                         f"{tuple(temperature.shape)} on {temperature.device}")
    keys, sub = split_keys(keys)
    greedy = torch.argmax(logits, dim=-1)
    k = min(int(top_k), logits.shape[-1])
    topv, topi = torch.topk(logits, k, dim=-1)
    j = torch.arange(k, device=logits.device, dtype=torch.int64)
    bits = _mix32((sub[:, None] + j * _GOLDEN) & _M32)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    gumbel = -torch.log(-torch.log(u))
    draw = torch.argmax(topv / torch.clamp(temperature, min=1e-6) + gumbel, dim=-1)
    sampled = topi.gather(-1, draw[:, None])[:, 0]
    return keys, torch.where(temperature <= 0.0, greedy, sampled)


def first_token(first_logits: torch.Tensor, key: int, temperature, top_k: int) -> Tuple[int, int]:
    """The first token of a request from its prefill's last-position logits
    [vocab] (``sample_tokens`` on one row, from the host key ``key``).
    Returns (token, next key) as host ints: the one sync of an admission,
    made by the thread that calls this (the batcher's for a local
    admission, a prefill worker's for a remote one)."""
    keys = torch.tensor([key], dtype=torch.int64, device=first_logits.device)
    keys, tok = sample_tokens(keys, first_logits[None].float(), temperature, top_k)
    return int(tok[0]), int(keys[0])


def _page_words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous [pages, ...] tensor as [pages, words]: each page's
    bytes as 8-byte words where they divide (a copy moves the same bits in
    fewer, wider elements), else as [pages, elements]."""
    flat = t.reshape(t.shape[0], -1)
    if t.is_contiguous() and (flat.shape[1] * t.element_size()) % 8 == 0:
        return flat.view(torch.int64)
    return flat


def _row_keys(base_seed: int, n: int) -> List[int]:
    """generate()'s per-row keys: row 0 starts the chain of ``base_seed``
    (the batcher's chain for the same seed), later rows fold their index in."""
    k0 = seed_key(base_seed)
    return [k0] + [_mix32(k0 ^ _mix32(i)) for i in range(1, n)]


# terminal marker in the dense prefix-cache index trie: an object() can
# never collide with an int token id
_TERM = object()


class _PrefixTrieIndex:
    """Token trie over the dense prefix-cache entry keys (copied from the
    JAX package), so ``_prefix_lookup`` walks the PROMPT once instead of
    scanning every entry. ``candidates`` returns every stored key that is a
    prefix of the probe, shortest to longest, in O(len(probe)) node steps;
    the caller picks the longest one whose entry passes its predicates
    (dtype, geometry). ``work`` counts node visits: the lookup's cost,
    independent of the entry count. NOT thread-safe on its own: every call
    happens under the server's ``_prefix_lock``."""

    __slots__ = ("_root", "work")

    def __init__(self):
        self._root: Dict[Any, Any] = {}
        self.work = 0

    def add(self, key: Tuple[int, ...]) -> None:
        node = self._root
        for t in key:
            node = node.setdefault(t, {})
        node[_TERM] = key

    def remove(self, key: Tuple[int, ...]) -> None:
        path = [(None, self._root)]
        node = self._root
        for t in key:
            nxt = node.get(t)
            if nxt is None:
                return
            path.append((t, nxt))
            node = nxt
        node.pop(_TERM, None)
        # prune now-empty suffix nodes so dead entries cost no walk time
        for i in range(len(path) - 1, 0, -1):
            tok, n = path[i]
            if n:
                break
            del path[i - 1][1][tok]

    def candidates(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        node = self._root
        out: List[Tuple[int, ...]] = []
        self.work += 1
        for t in tokens:
            if _TERM in node:
                out.append(node[_TERM])
            node = node.get(t)
            if node is None:
                return out
            self.work += 1
        if _TERM in node:
            out.append(node[_TERM])
        return out

    def clear(self) -> None:
        self._root = {}


class _DenseBuffer:
    """``generate()``'s dense KV caches and decode state: one per server,
    reused by every call. Each cache tensor of each layer is one flat
    tensor of ``capacity`` (rows x positions) entries of its own inner
    shape (the layout of ``init_kv_caches``: the bf16 triple or the int8
    5-tuple); the caches of a call of ``b`` rows and ``max_len`` positions
    are the contiguous prefix of each, ``flat[:b * max_len * inner]`` viewed
    as [b, max_len, ...], so every key starts at the same address and the
    attention reads a contiguous tensor. Beside them, the decode state
    ``tok``, ``pos``, ``done``, ``keys`` [bmax] (a call uses ``[:b]``), and
    the 0-dim float32 ``temperature``."""

    def __init__(self, module, kv_cache_dtype: str, capacity: int, bmax: int, device):
        self.capacity = int(capacity)
        # the model's own caches (a sharded model's: one flat tensor set a
        # (rank, layer), each key's views at the rank's share)
        self.module = module
        caches = module.init_caches((1, self.capacity), kv_cache_dtype, device=device)
        self.inner = [tuple(t.shape[2:] for t in layer) for layer in caches]
        self.layers = [tuple(t.view(-1) for t in layer) for layer in caches]
        self.tok = torch.zeros((bmax,), dtype=torch.int64, device=device)
        self.pos = torch.zeros((bmax,), dtype=torch.int64, device=device)
        self.done = torch.zeros((bmax,), dtype=torch.bool, device=device)
        self.keys = torch.zeros((bmax,), dtype=torch.int64, device=device)
        self.temperature = torch.zeros((), dtype=torch.float32, device=device)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for layer in self.layers for t in layer)

    def caches(self, b: int, max_len: int):
        """The [b, max_len, ...] caches: contiguous prefix views (of each
        rank's share of [b, max_len] when the model is sharded)."""
        rows, length = self.module.cache_share((b, max_len))
        n = rows * length
        views = [tuple(t[:n * shape.numel()].view(rows, length, *shape)
                       for t, shape in zip(layer, inner))
                 for layer, inner in zip(self.layers, self.inner)]
        return self.module.wrap_caches(views, (b, max_len))

    def state(self, b: int):
        return self.tok[:b], self.pos[:b], self.done[:b], self.keys[:b]


def _decode_steps(module, k: int, top_k: int, last_tok: torch.Tensor, next_pos: torch.Tensor,
                  keys: torch.Tensor, temperature, **forward) -> torch.Tensor:
    """``k`` decode steps of the batcher's step programs: each feeds
    ``last_tok`` at ``next_pos`` through ``module`` (``forward``: the caches
    and how they are addressed, the adapters), samples with
    ``sample_tokens`` (one key split), and updates ``keys``, ``last_tok``
    and ``next_pos`` in place. Returns the tokens [slots, k]."""
    tokens = torch.empty((last_tok.shape[0], k), dtype=torch.int64, device=last_tok.device)
    for j in range(k):
        logits, _ = module(last_tok[:, None], positions=next_pos[:, None], **forward)
        new_keys, nxt = sample_tokens(keys, logits[:, -1], temperature, top_k)
        keys.copy_(new_keys)
        last_tok.copy_(nxt)
        next_pos.add_(1)
        tokens[:, j] = nxt
    return tokens


def _lora_args_bad(lora: bool, adapters, adapter_ids, rows: int) -> bool:
    """True when an adapted program (``lora``) lacks its adapter pool or
    its ``adapter_ids`` of ``rows`` entries, or a base program is given
    either."""
    if not lora:
        return adapters is not None or adapter_ids is not None
    return adapters is None or adapter_ids is None or tuple(adapter_ids.shape) != (rows,)


def _lora_args_text(adapters, adapter_ids) -> str:
    return ("none" if adapters is None else "given") + ", adapter_ids " + (
        "none" if adapter_ids is None else str(tuple(adapter_ids.shape)))


class LLMServer(SeldonComponent):
    """Serves a registered transformer-family model for text generation.

    Parameters as the JAX package's (``model_uri`` for a checkpoint
    directory, ``model`` + ``init_random=True`` for a randomly initialised
    model; weights of a JAX model also cross over with
    ``load(params=<JAX param tree as numpy>)``), plus ``device``: "cuda" by
    default (raises without a card), "cpu" only when asked."""

    def __init__(
        self,
        model_uri: str = "",
        model: Optional[str] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
        init_random: bool = False,
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        top_k: int = 40,
        eos_id: Optional[int] = None,
        tokenizer: str = "bytes",
        len_buckets: Optional[Sequence[int]] = None,
        batch_buckets: Optional[Sequence[int]] = None,
        mesh: Optional[Any] = None,
        topology: Optional[Any] = None,
        tensor_parallel: int = 0,
        sequence_parallel: int = 0,
        quantize: str = "",
        param_dtype: str = "",
        kv_cache_dtype: str = "",
        kv_cache_layout: str = "",
        kv_page_size: int = 0,
        kv_pool_pages: int = 0,
        prefill_chunk: int = 0,
        continuous_batching: int = 0,
        continuous_batching_max_len: int = 0,
        decode_pipeline_depth: int = 2,
        decode_fuse_steps: int = 0,
        spec_mode: str = "",
        spec_k: int = 0,
        spec_ngram: int = 0,
        disaggregation: str = "",
        prefill_devices: int = 0,
        decode_devices: int = 0,
        prefill_workers: int = 0,
        handoff_transport: str = "",
        disagg_mesh: Optional[Any] = None,
        draft_model: Optional[str] = None,
        draft_model_kwargs: Optional[Dict[str, Any]] = None,
        draft_model_uri: str = "",
        prefix_cache_size: int = 0,
        prefix_cache_bytes: int = 0,
        lora_rank: int = 0,
        lora_max_adapters: int = 8,
        lora_adapters: Optional[Dict[str, str]] = None,
        slo_class_weights: Optional[Dict[str, float]] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        tenant_quota: int = 0,
        tenant_quotas: Optional[Dict[str, int]] = None,
        seed: int = 0,
        device: Optional[str] = None,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        from seldon_core_tpu_torch.runtime.disagg import normalize_disaggregation

        try:
            disagg_on = normalize_disaggregation(disaggregation) != "off"
        except ValueError:
            disagg_on = False   # load() raises naming the value
        if disagg_on and (int(tensor_parallel) > 1 or int(sequence_parallel) > 1
                          or mesh is not None):
            raise ValueError(
                "disaggregation='remote_prefill' does not yet compose with tensor/sequence "
                "parallelism or an explicit mesh: the batcher's slot pool is single-device per "
                "slice — shard WITHIN a slice is a follow-up")
        if tokenizer != "bytes":
            raise NotImplementedError(
                "LLMServer(tokenizer=...) is not ported yet: it arrives with HF tokenizers "
                "(a later slice)")
        if int(kv_page_size) < 0:
            raise ValueError(f"kv_page_size={kv_page_size} must be >= 0 (0 = default page size)")
        if int(kv_pool_pages) < 0:
            raise ValueError(f"kv_pool_pages={kv_pool_pages} must be >= 0 "
                             f"(0 = fully provisioned pool)")
        if int(prefill_chunk) < 0:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 0 (0 = default chunk size)")
        if int(decode_pipeline_depth) < 1:
            raise ValueError(f"decode_pipeline_depth={decode_pipeline_depth} must be >= 1 "
                             f"(1 = serial dispatch-then-sync, >=2 pipelines)")
        if int(decode_fuse_steps) < 0:
            raise ValueError(f"decode_fuse_steps={decode_fuse_steps} must be >= 0 (0/1 = no fusing)")
        self.device = resolve_device(device)
        # parallelism (``parallel/``, ``models/sharded.py``): an explicit
        # mesh, or tensor_parallel / sequence_parallel, which build a
        # ('data', 'seq', 'model') mesh over ``topology`` (default: the
        # process topology) at load(); its ranks must share this device
        self.mesh = mesh
        self.topology = topology
        self.tensor_parallel = int(tensor_parallel)
        self.sequence_parallel = int(sequence_parallel)
        # a checkpoint directory (local path or file:// URI) holding
        # config.json + params.msgpack; ``model`` / ``model_kwargs`` override
        # the file's name and kwargs, as in the JAX package
        self.model_uri = model_uri
        self.model_name = model
        self.model_kwargs = dict(model_kwargs or {})
        self.init_random = bool(init_random)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.tokenizer_name = tokenizer
        self.len_buckets = tuple(len_buckets or DEFAULT_LEN_BUCKETS)
        self.batch_buckets = tuple(batch_buckets or DEFAULT_BATCH_BUCKETS)
        self.param_dtype = param_dtype
        # weight-only int8 ("int8": every projection and the lm_head run
        # through the W8A16 GEMM kernel); validated at load(), as the JAX
        # package does
        self.quantize = quantize
        self.kv_cache_dtype = kv_cache_dtype
        self.kv_cache_layout = kv_cache_layout
        self.kv_page_size = int(kv_page_size)
        self.kv_pool_pages = int(kv_pool_pages)
        self.prefill_chunk = int(prefill_chunk)
        self.continuous_batching = int(continuous_batching)
        self.continuous_batching_max_len = int(continuous_batching_max_len) or None
        self.decode_pipeline_depth = int(decode_pipeline_depth)
        self.decode_fuse_steps = int(decode_fuse_steps)
        # speculative decoding (runtime/batcher.py + _get_spec_step): "off",
        # "ngram" (prompt lookup over each slot's history) or "draft" (a
        # small draft model); validated at load(), as the JAX package does.
        # spec_k: drafts a verify step (0 = default 4); spec_ngram: the
        # longest n-gram the proposer matches (0 = default 3)
        self.spec_mode = spec_mode
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        # the draft model: registry name + kwargs, random from the server
        # seed or JAX weights through load(draft_params=...); its vocab must
        # be the target's (proposals index the target's tokens)
        self.draft_model = str(draft_model or "")
        self.draft_model_kwargs = dict(draft_model_kwargs or {})
        self.draft_model_uri = draft_model_uri
        self._draft_module = None
        self._draft_cfg = None
        # batched LoRA (runtime/adapters.py): lora_rank > 0 builds the
        # adapter pool at load() (lora_max_adapters rows, the identity row
        # included) and preloads ``lora_adapters`` (name -> local or file://
        # URI); every program the batcher runs is then the adapted one
        self.lora_rank = int(lora_rank)
        self.lora_max_adapters = int(lora_max_adapters)
        self.lora_adapters = dict(lora_adapters or {})
        self.adapter_registry = None
        # weighted-fair SLO admission (runtime/scheduler.py): class and
        # tenant weights, per-tenant queued-request quotas (0 = unbounded)
        self.slo_class_weights = dict(slo_class_weights or {})
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_quota = int(tenant_quota or 0)
        self.tenant_quotas = dict(tenant_quotas or {})
        # prefix caching (opt-in): the batcher's radix trie over its page
        # pool (``runtime/radix.py``), and for a one-prompt generate() call
        # dense entries of the longest previously prefilled token prefix,
        # LRU-evicted past ``prefix_cache_size`` entries or past
        # ``prefix_cache_bytes`` (512 MB by default whenever the cache is
        # on). An entry is a COPY of the dense caches, taken before the
        # first decode step: generate() decodes in place into one reused
        # buffer (the JAX package may keep the cache object itself: its
        # arrays are immutable)
        self.prefix_cache_size = int(prefix_cache_size)
        self.prefix_cache_bytes = int(prefix_cache_bytes) or (
            512 * 1024 * 1024 if self.prefix_cache_size else 0)
        self._prefix_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._prefix_index = _PrefixTrieIndex()
        self._prefix_bytes = 0
        self._prefix_lock = threading.Lock()
        self._prefix_hits = 0
        self._prefix_overbudget_warned = False
        # disaggregated prefill/decode (runtime/disagg.py): validated at
        # load(), as the JAX package does. prefill_devices (or
        # prefill_workers) = N puts N prefill workers on this server's
        # device; disagg_mesh (a parallel.mesh.DisaggregatedMesh) may name
        # other devices; the batcher decodes on this server's one device,
        # which a decode slice of several devices (decode_devices > 1, or a
        # disagg_mesh naming them) must contain, as the JAX batcher decodes
        # on the default device inside its slice
        self.disaggregation = disaggregation
        self.prefill_devices = int(prefill_devices)
        self.decode_devices = int(decode_devices)
        self.prefill_workers = int(prefill_workers)
        self.handoff_transport = handoff_transport or ""
        self.disagg_mesh = disagg_mesh
        # per handoff: the worker's prefill and copy, then the decode-side import
        self._handoff_times: Any = deque(maxlen=4096)
        # the weights on another device, one module a device (``_params_on``)
        self._device_params: Dict[Any, Any] = {}
        self._device_params_lock = threading.Lock()
        self.seed = int(seed)
        self.ready = False
        self._eos_override = eos_id
        self._request_count = 0
        self._lock = threading.Lock()
        # serving observability, appended by the batcher: time to first
        # token per request, the gap before each later token at its drain
        # (a fused block's trailing tokens read ~0), the drain-to-drain wall
        # of each decode step, and
        # per dispatch the host time of the step call (enqueue or replay, no
        # sync), per drain the host wait for its tokens, and the steps in
        # flight at each drain (host lag, in steps: a fused record is k)
        self._ttft_times: Any = deque(maxlen=4096)
        # (slo_class, TTFT) per request, for seldon_llm_tenant_ttft_seconds
        self._ttft_by_class: Any = deque(maxlen=4096)
        self._inter_token_times: Any = deque(maxlen=8192)
        self._decode_step_times: Any = deque(maxlen=4096)
        self._decode_dispatch_times: Any = deque(maxlen=4096)
        self._decode_sync_times: Any = deque(maxlen=4096)
        self._decode_host_lag: Any = deque(maxlen=4096)
        # tokens each drained verify step emitted for each slot (1..K+1)
        self._spec_accepted: Any = deque(maxlen=4096)
        # prefill chunks and decode dispatches the batcher ran: as graph
        # replays (the card), and through the eager programs (the CPU, or
        # the private _eager switch)
        self._prefill_replays = 0
        self._prefill_eager = 0
        self._decode_replays = 0
        self._decode_eager = 0
        # the batcher's copy-on-write page copies, replayed and run eagerly
        self._cow_replays = 0
        self._cow_eager = 0
        # the KV bytes the last decode streamed a step (the batcher's pool,
        # set at each drain; generate()'s caches, set at each call)
        self._last_decode_kv_bytes = 0
        # the decode programs by ("decode", b, max_len) and ("pagedstep",
        # slots, n_pages, k), the prefill programs by ("prefill", b, plen,
        # max_len) and ("pchunk", chunk, n_pages), and the one stream every
        # batcher of this server captures its graphs on
        self._decode_cache: Dict[tuple, Any] = {}
        self._prefill_cache: Dict[tuple, Any] = {}
        self._capture_stream: Optional[Any] = None
        # generate(): the dense buffer (grown on demand; growths counted),
        # its decode graphs by (b, max_len) in one pool, captured on their
        # own stream, and the lock a call holds from its prefill to its
        # tokens' copy to the host; decode steps replayed (the card) and run
        # through the eager program (the CPU, or the private _eager switch)
        self._dense: Optional[_DenseBuffer] = None
        self._dense_growths = 0
        self._dense_lock = threading.Lock()
        self._generate_graphs: Dict[Tuple[int, int], Any] = {}
        self._generate_pool: Optional[Any] = None
        self._gen_stream: Optional[Any] = None
        self._generate_replays = 0
        self._generate_eager = 0

    # ------------------------------------------------------------------
    def load(self, params: Optional[Dict[str, Any]] = None,
             draft_params: Optional[Dict[str, Any]] = None) -> None:
        """Build the model on ``self.device``. ``params`` (a JAX param tree
        of numpy arrays — ``models/convert.py``) fills it with converted
        weights; else ``model_uri`` names a checkpoint directory
        (``config.json`` + ``params.msgpack``, read by
        ``models/checkpoint.load_params``; the file's model name and kwargs
        unless ``model`` / ``model_kwargs`` override them; an orbax
        ``params/`` directory raises naming the format); else
        ``init_random=True`` draws them from a ``torch.Generator`` seeded
        with ``seed``. The draft model (``draft_model`` and/or
        ``draft_model_uri``) is built beside it the same way: from
        ``draft_params`` through ``params_from_jax``, else from its
        checkpoint, else drawn from a generator seeded with ``seed``, so a
        draft configured like the target is a bit-identical copy of a random
        target (the perfect drafter). The draft is never quantized; it is
        stored as the target is (``param_dtype``). ``param_dtype`` "auto"
        stores the weights in the compute dtype, as the JAX package casts
        them; "" keeps float32 storage with a cast per use.

        ``quantize="int8"`` quantizes after that cast, as the JAX package
        orders it. The model is quantized as a layout first, on the meta
        device, and then filled leaf by leaf (a float leaf quantized into
        its int8 buffers as it is copied in), so the float tree is never on
        the device: at Llama-2-7B the peak is the int8 tree plus one float32
        leaf, for random, converted and checkpointed weights alike.

        ``lora_rank > 0`` builds the adapter pool (``runtime/adapters.py``)
        and preloads ``lora_adapters``."""
        if self.ready:
            return
        from seldon_core_tpu_torch.models import get_model
        from seldon_core_tpu_torch.models.convert import has_quantized_leaves, params_from_jax
        from seldon_core_tpu_torch.models.transformer import (
            normalize_kv_cache_dtype, normalize_kv_cache_layout, to_torch_dtype)
        from seldon_core_tpu_torch.runtime.scheduler import normalize_slo_class

        self.kv_cache_dtype = normalize_kv_cache_dtype(self.kv_cache_dtype)
        self.kv_cache_layout = normalize_kv_cache_layout(self.kv_cache_layout)
        if self.param_dtype and self.param_dtype != "auto":
            to_torch_dtype(self.param_dtype)  # ValueError on an unknown name
        if self.quantize and self.quantize != "int8":
            raise SeldonError(f"unsupported quantize={self.quantize!r} (int8 only)",
                              status_code=500)
        from seldon_core_tpu_torch.runtime.spec import normalize_spec_mode

        self.spec_mode = normalize_spec_mode(self.spec_mode)
        if self.spec_k < 0:
            raise ValueError(f"spec_k={self.spec_k} must be >= 0 (0 = default draft "
                             f"depth when speculation is on)")
        if self.spec_ngram < 0:
            raise ValueError(f"spec_ngram={self.spec_ngram} must be >= 0 (0 = default "
                             f"3-gram prompt lookup)")
        has_draft = bool(self.draft_model or self.draft_model_uri)
        if self.spec_mode == "draft" and not has_draft:
            raise ValueError("spec_mode='draft' needs a draft model: pass draft_model="
                             "<registry name> (+ draft_model_kwargs) or draft_model_uri=")
        if draft_params is not None and not self.draft_model:
            raise ValueError("load(draft_params=...) needs draft_model=<registry name> "
                             "naming the draft's architecture")
        from seldon_core_tpu_torch.runtime.disagg import normalize_disaggregation

        self.disaggregation = normalize_disaggregation(self.disaggregation)
        if self.prefill_devices < 0 or self.decode_devices < 0 or self.prefill_workers < 0:
            raise ValueError(f"prefill_devices={self.prefill_devices} / decode_devices="
                             f"{self.decode_devices} / prefill_workers={self.prefill_workers} "
                             f"must be >= 0")
        self._build_mesh()
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank={self.lora_rank} must be >= 0 (0 = adapters off)")
        if self.lora_rank > 0 and self.disaggregation != "off":
            raise ValueError("lora_rank > 0 does not yet compose with "
                             "disaggregation='remote_prefill': the adapter pool lives on the "
                             "decode slice and prefill-slice workers would need committed "
                             "replicas — a follow-up")
        if self.lora_rank > 0 and int(self.model_kwargs.get("n_experts", 0) or 0) > 0:
            raise ValueError("lora_rank > 0 does not support MoE FFNs: adapters "
                             "target the dense q/o/FFN projections")
        # one device is allowed (the JAX package needs two): the workers
        # then share the server's device (runtime/disagg.py)
        if self.handoff_transport not in ("", "device", "network"):
            raise ValueError(f"unknown handoff_transport {self.handoff_transport!r}: "
                             "expected '', 'device' or 'network'")
        if self.handoff_transport == "network" and self.disaggregation == "off":
            raise ValueError("handoff_transport='network' only applies to "
                             "disaggregation='remote_prefill' (there is no KV handoff without a "
                             "prefill/decode split)")
        for cls in self.slo_class_weights:
            normalize_slo_class(cls)  # unknown class names fail at load()
        name, kwargs = self.model_name, dict(self.model_kwargs)
        if self.model_uri and params is None:
            name, kwargs, params = self._read_checkpoint(self.model_uri, name, kwargs)
        if name is None:
            raise SeldonError("LLMServer needs model_uri or model=<registry name>",
                              status_code=500)
        if params is None and not self.init_random:
            raise SeldonError("No weights: pass model_uri, init_random=True or "
                              "load(params=...)", status_code=500)
        quantized_tree = params is not None and has_quantized_leaves(params)
        if quantized_tree and not self.quantize:
            raise SeldonError("params hold int8 (quantized) leaves: load them with "
                              "quantize='int8'", status_code=500)
        layout_first = bool(self.quantize)
        module = get_model(name, device="meta" if layout_first else self.device,
                           param_dtype=self.param_dtype or None, **kwargs)
        if layout_first:
            module.quantize_().to_empty(device=self.device)
        if params is not None:
            params_from_jax(params, module, quantize_float=layout_first)
            del params
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            module.init_params(gen)
        module.eval()
        if self.mesh is not None:
            # quantized before sharding (the JAX package's order): each
            # rank's int8 leaves are cuts of the whole leaf's codes
            module = module.shard(self.mesh)
        # a tied int8 head's transposed copy, which its card route reads
        module.prepare_head_()
        self._module = module
        self._cfg = module.cfg
        self._model_build = (name, kwargs)
        if has_draft:
            self._load_draft(draft_params)
        if self.lora_rank > 0:
            from seldon_core_tpu_torch.runtime.adapters import AdapterRegistry

            self.adapter_registry = AdapterRegistry(self._cfg, self.lora_rank,
                                                    self.lora_max_adapters, device=self.device)
            for aname, uri in self.lora_adapters.items():
                self.adapter_registry.load_uri(aname, uri)
        self._tokenizer = ByteTokenizer()
        self.eos_id = self._eos_override if self._eos_override is not None else self._tokenizer.eos_id
        self.ready = True
        logger.info("LLMServer loaded %s (vocab=%d) on %s", name, self._cfg.vocab_size,
                    self.device)

    def _build_mesh(self) -> None:
        """The serving mesh (``parallel/topology.build_serving_mesh``: ``{"data":
        -1, "seq": sp, "model": tp}``), before any weight moves. LoRA reads
        the one adapter pool on every rank (``models/sharded.py``); a draft
        model stays one unsharded model on the server's device, as in the
        JAX package."""
        from seldon_core_tpu_torch.parallel.topology import build_serving_mesh

        self.mesh, self.topology = build_serving_mesh(
            self.device, self.mesh, self.topology, self.tensor_parallel,
            sequence_parallel=self.sequence_parallel)

    @staticmethod
    def _read_checkpoint(uri: str, name: Optional[str], kwargs: Dict[str, Any]):
        """(model name, model kwargs, param tree) of the checkpoint at
        ``uri`` (``storage.download``: a local path or file:// URI): the
        file's name unless ``name`` is given, its kwargs under ``kwargs``,
        and ``params.msgpack`` (flax's variables dict, or one holding only
        the ``params`` collection; ``params_from_jax`` reads both)."""
        from seldon_core_tpu_torch import storage
        from seldon_core_tpu_torch.models.checkpoint import load_params

        path = storage.download(uri)
        with open(os.path.join(path, "config.json")) as f:
            file_cfg = json.load(f)
        return (name or file_cfg["model"], {**file_cfg.get("kwargs", {}), **kwargs},
                load_params(path))

    def _load_draft(self, draft_params: Optional[Dict[str, Any]]) -> None:
        """The draft model beside the target (``load``): from
        ``draft_params``, else ``draft_model_uri``'s checkpoint, else random.
        Its vocab must be the target's, and it is never quantized (the JAX
        package only casts it)."""
        from seldon_core_tpu_torch.models import get_model
        from seldon_core_tpu_torch.models.convert import params_from_jax

        name, kwargs = self.draft_model or None, dict(self.draft_model_kwargs)
        if self.draft_model_uri and draft_params is None:
            name, kwargs, draft_params = self._read_checkpoint(self.draft_model_uri, name,
                                                               kwargs)
        draft = get_model(name, device=self.device, param_dtype=self.param_dtype or None,
                          **kwargs)
        if draft.cfg.vocab_size != self._cfg.vocab_size:
            raise ValueError(f"draft model vocab {draft.cfg.vocab_size} != target vocab "
                             f"{self._cfg.vocab_size}: draft proposals index the target's "
                             f"token space")
        if draft_params is not None:
            params_from_jax(draft_params, draft)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            draft.init_params(gen)
        draft.eval()
        self._draft_module = draft
        self._draft_cfg = draft.cfg

    # ------------------------------------------------------------------
    # Forward programs (the JAX package's compiled stages, under its keys):
    # generate()'s dense prefill runs eagerly everywhere; its decode step,
    # the paged prefill chunk and the paged decode step of k fused steps run
    # eagerly on the CPU and as CUDA graph replays on the card
    # ------------------------------------------------------------------
    def _prefill_fresh(self, tokens: torch.Tensor, positions: torch.Tensor, max_len: int,
                       adapter_ids: Optional[torch.Tensor] = None):
        """The dense prefill into fresh ``init_kv_caches`` of ``max_len``,
        filled from offset 0: the oracle of the served paths (independent
        of the dense buffer ``generate()`` reuses); with ``adapter_ids`` ([b]
        ids of the adapter pool) each row through its adapter. Returns
        (logits [b, plen, vocab], caches)."""
        caches = self._module.init_caches((tokens.shape[0], max_len), self.kv_cache_dtype,
                                          device=self.device)
        lora = {} if adapter_ids is None else dict(adapters=self.adapter_registry.pool(),
                                                   adapter_ids=adapter_ids)
        return self._module(tokens, positions=positions, caches=caches, cache_index=0, **lora)

    def _get_prefill(self, b: int, plen: int, max_len: int, lora: bool = False,
                     device: Optional[Any] = None):
        """Port of ``_get_prefill``: the dense prefill program, cached under
        ``("prefill", b, plen, max_len)``. Its call ``prefill(caches, tokens,
        positions)`` (caches [b, max_len, ...], ``tokens`` [b, plen] int64,
        ``positions`` [b, plen], PAD_POS past each prompt) first resets the
        caches in place to what ``init_kv_caches`` makes, then writes them
        from offset 0, and returns the logits [b, plen, vocab]. The caches
        may be a slot pool's row (``Transformer.slot_rows``: the dense
        batcher's admission), reset trash column and all. ``lora=True`` is
        the adapted program, under ``("prefill", b, plen, max_len, True)``:
        its call also takes ``adapters`` (the adapter pool) and
        ``adapter_ids`` ([b] int). ``device`` (a prefill worker's) other
        than the server's runs the same program over the weights there
        (``_params_on``), under a key that also names the device."""
        from seldon_core_tpu_torch.runtime.disagg import same_device

        if device is None or same_device(device, self.device):
            return self._dense_prefill(self._module, "prefill", b, plen, max_len, lora)
        return self._dense_prefill(self._params_on(device), "prefill", b, plen, max_len, lora,
                                   (str(torch.device(device)),))

    def _get_extend(self, b: int, slen: int, max_len: int):
        """Port of ``_get_extend``: the suffix prefill of a prefix-cache
        continuation, cached under ``("extend", b, slen, max_len)``. Its call
        ``extend(caches, tokens, positions, start)`` (caches [b, max_len,
        ...] already holding the prefix, ``tokens`` [b, slen] int64,
        ``positions`` [b, slen], PAD_POS past the suffix, ``start`` the int
        write offset) writes the slen columns at ``start`` in place,
        attending over the cached prefix, and returns the logits [b, slen,
        vocab]. Eager everywhere, like ``_get_prefill``."""
        b, slen, max_len = int(b), int(slen), int(max_len)
        key = ("extend", b, slen, max_len)
        with self._lock:
            fn = self._prefill_cache.get(key)
        if fn is not None:
            return fn
        module = self._module

        def extend(caches, tokens, positions, start):
            if (module.cache_lead(caches) != (b, max_len) or tuple(tokens.shape) != (b, slen)
                    or tuple(positions.shape) != (b, slen)):
                raise ValueError(f"extend {key}: caches {module.cache_lead(caches)}, tokens "
                                 f"{tuple(tokens.shape)}, positions {tuple(positions.shape)}")
            logits, _ = module(tokens, positions=positions, caches=caches,
                               cache_index=int(start))
            return logits

        with self._lock:
            return self._prefill_cache.setdefault(key, extend)

    def _get_draft_prefill(self, b: int, plen: int, max_len: int):
        """Port of ``_get_draft_prefill``: ``_get_prefill``'s program over
        the DRAFT model, cached under ``("draft_prefill", b, plen,
        max_len)``: ``prefill(caches, tokens, positions)`` resets the draft
        caches it is given ([b, max_len, ...]; the batcher passes its slot's
        row of the dense draft cache) and writes them from offset 0. The
        logits are discarded by the batcher: drafting always restarts from
        the last accepted target token. It runs eagerly, at admission (the
        draft is small)."""
        if self._draft_module is None:
            raise ValueError("no draft model loaded: pass draft_model=<registry name>")
        return self._dense_prefill(self._draft_module, "draft_prefill", b, plen, max_len)

    def _dense_prefill(self, module, name: str, b: int, plen: int, max_len: int,
                       lora: bool = False, tail: Tuple[Any, ...] = ()):
        """The dense prefill program of ``module`` under ``(name, b, plen,
        max_len)``, ``lora=True`` adding ``True`` to the key and ``tail``
        the rest (``_get_prefill``, ``_get_draft_prefill``)."""
        from seldon_core_tpu_torch.models.transformer import reset_kv_caches

        b, plen, max_len, lora = int(b), int(plen), int(max_len), bool(lora)
        key = (name, b, plen, max_len) + ((True,) if lora else ()) + tuple(tail)
        with self._lock:
            fn = self._prefill_cache.get(key)
        if fn is not None:
            return fn

        def prefill(caches, tokens, positions, adapters=None, adapter_ids=None):
            if (module.cache_lead(caches) != (b, max_len) or tuple(tokens.shape) != (b, plen)
                    or tuple(positions.shape) != (b, plen)
                    or _lora_args_bad(lora, adapters, adapter_ids, b)):
                raise ValueError(f"dense prefill {key}: caches {module.cache_lead(caches)}, "
                                 f"tokens {tuple(tokens.shape)}, positions "
                                 f"{tuple(positions.shape)}, adapters "
                                 f"{_lora_args_text(adapters, adapter_ids)}")
            reset_kv_caches(caches)
            logits, _ = module(tokens, positions=positions, caches=caches, cache_index=0,
                               adapters=adapters, adapter_ids=adapter_ids)
            return logits

        with self._lock:
            return self._prefill_cache.setdefault(key, prefill)

    def _get_decode(self, b: int, max_len: int):
        """Port of ``_get_decode``: one step of the dense decode, cached
        under ``("decode", b, max_len)`` (the JAX package scans it
        ``n_steps`` times in one program; ``generate()`` calls or replays
        it once per token). Its call ``step(caches, tok, pos, done, keys,
        temperature)`` feeds ``tok`` [b] at ``pos`` [b] (also the write
        offset: the tensor-index branch, no host read), samples with
        ``sample_tokens`` (one key split), masks the rows already ``done``
        to EOS, leaves ``tok``, ``pos``, ``done`` and ``keys`` updated in
        place and returns the tokens [b]. Nothing is read back to the
        host, so the same call is what a CUDA graph captures
        (``servers/step_graph.capture_generate_step``)."""
        b, max_len = int(b), int(max_len)
        key = ("decode", b, max_len)
        with self._lock:
            fn = self._decode_cache.get(key)
        if fn is not None:
            return fn
        module, top_k, eos_id = self._module, self.top_k, self.eos_id

        def step(caches, tok, pos, done, keys, temperature):
            if module.cache_lead(caches) != (b, max_len) or tok.shape != (b,):
                raise ValueError(f"dense decode step {key}: caches "
                                 f"{module.cache_lead(caches)}, tok {tuple(tok.shape)}")
            logits, _ = module(tok[:, None], positions=pos[:, None], caches=caches,
                               cache_index=pos)
            new_keys, nxt = sample_tokens(keys, logits[:, -1], temperature, top_k)
            nxt = nxt.masked_fill(done, eos_id)
            done.logical_or_(nxt == eos_id)
            keys.copy_(new_keys)
            tok.copy_(nxt)
            pos.add_(1)
            return nxt

        with self._lock:
            return self._decode_cache.setdefault(key, step)

    def _params_on(self, device):
        """The weights on ``device``: this server's own module on its own
        device (the prefill workers of one card share it: a second copy of
        a 7B model's weights on the same card would be a waste of 13.5 GB),
        else one copy a device, made at first use under a lock (the JAX
        package's committed copies for its prefill slice)."""
        from seldon_core_tpu_torch.runtime.disagg import same_device

        device = torch.device(device)
        if same_device(device, self.device):
            return self._module
        with self._device_params_lock:
            module = self._device_params.get(device)
            if module is None:
                from seldon_core_tpu_torch.models import get_model

                name, kwargs = self._model_build
                module = get_model(name, device="meta", param_dtype=self.param_dtype or None,
                                   **kwargs)
                if self.quantize:
                    module.quantize_()
                module.to_empty(device=device)
                module.load_state_dict(self._module.state_dict())
                module.eval().prepare_head_()
                self._device_params[device] = module
            return module

    def _get_staging_pool_init(self, pool_pages: int, page_size: int):
        """Port of ``_get_staging_pool_init``: a prefill worker's staging
        page pool of ``pool_pages`` pages (``RESERVED_PAGES + n_pages``) in
        this server's KV dtype (an int8 pool carries its scales), cached
        under ``("staging_init", pool_pages, page_size)``. Its call takes
        the device (default: the server's) and returns fresh pools."""
        key = ("staging_init", int(pool_pages), int(page_size))
        with self._lock:
            fn = self._prefill_cache.get(key)
        if fn is not None:
            return fn

        def init(device=None):
            return self._module.init_caches((int(pool_pages), int(page_size)),
                                            self.kv_cache_dtype, device=device or self.device,
                                            paged=True)

        with self._lock:
            return self._prefill_cache.setdefault(key, init)

    def _get_handoff_import(self, n_pages: int, staged_pages: Optional[int] = None):
        """Port of ``_get_handoff_import``: the import of a staged page
        bucket into a paged pool, cached under ``("handoff_import",
        n_pages, m)``, m = ``min(staged_pages, n_pages)``. Its call
        ``import_pages(pools, staged, block_row, n_valid)`` (``staged`` a
        bucket of ``RESERVED_PAGES + m`` rows a tensor, ``block_row`` the
        host block-table row of the destination pages, ``n_valid`` an int)
        copies bucket row ``RESERVED_PAGES + j`` of every tensor of every
        layer into pool page ``block_row[j]``, in place; rows ``j >=
        n_valid`` and NULL entries go to TRASH_PAGE, as in the JAX package.
        The targets are computed on the host and staged in one copy; then
        one ``index_copy_`` a tensor over its pages seen as 8-byte words, on
        the current stream (eager: its source is a fresh bucket each
        handoff, which a graph could not read without a copy of its
        own)."""
        from seldon_core_tpu_torch.models.transformer import NULL_PAGE, RESERVED_PAGES, TRASH_PAGE

        n_pages = int(n_pages)
        m = n_pages if staged_pages is None else min(int(staged_pages), n_pages)
        key = ("handoff_import", n_pages, m)
        with self._lock:
            fn = self._prefill_cache.get(key)
        if fn is not None:
            return fn

        def import_pages(pools, staged, block_row, n_valid):
            row = np.asarray(block_row, np.int64).reshape(-1)[:m]
            j = np.arange(m)
            tgt = torch.from_numpy(np.where((j < int(n_valid)) & (row != NULL_PAGE), row,
                                            TRASH_PAGE).astype(np.int64))
            dev = pools[0][0].device
            tgt = tgt.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else tgt
            for pool_layer, staged_layer in zip(pools, staged):
                for pool, st in zip(pool_layer, staged_layer):
                    _page_words(pool).index_copy_(
                        0, tgt, _page_words(st)[RESERVED_PAGES:RESERVED_PAGES + m])

        with self._lock:
            return self._prefill_cache.setdefault(key, import_pages)

    def _get_prefill_chunk(self, chunk: int, n_pages: int, lora: bool = False,
                           device: Optional[Any] = None):
        """Port of ``_get_prefill_chunk``: the program that writes one chunk
        of one sequence's prompt into the paged pool while attending over
        its earlier chunks, cached under ``("pchunk", chunk, n_pages,
        lora)``. Its call ``prefill(pools, block_row, tokens, positions)``
        (``block_row`` [1, n_pages] int32, ``tokens`` [1, chunk] int64,
        ``positions`` [1, chunk] int32, PAD_POS past the prompt) writes the
        pools in place and returns logits [1, chunk, vocab]. ``lora=True``
        is the adapted program: the call also takes ``adapters`` (the
        adapter pool) and ``adapter_ids`` ([1] int: the sequence's id, 0 =
        the identity). Nothing is read back to the host, so the same call is
        what a CUDA graph captures (``servers/step_graph.py``). ``device``
        (a prefill worker's) other than the server's runs the same program
        over the weights there (``_params_on``), cached under a key that
        also names the device."""
        from seldon_core_tpu_torch.runtime.disagg import same_device

        chunk, n_pages, lora = int(chunk), int(n_pages), bool(lora)
        other = device is not None and not same_device(device, self.device)
        key = ("pchunk", chunk, n_pages, lora) + ((str(torch.device(device)),) if other else ())
        with self._lock:
            fn = self._prefill_cache.get(key)
        if fn is not None:
            return fn
        module = self._params_on(device) if other else self._module

        def prefill(pools, block_row, tokens, positions, adapters=None, adapter_ids=None):
            if (tuple(block_row.shape) != (1, n_pages) or tuple(tokens.shape) != (1, chunk)
                    or tuple(positions.shape) != (1, chunk)
                    or _lora_args_bad(lora, adapters, adapter_ids, 1)):
                raise ValueError(f"prefill chunk {key}: block_row {tuple(block_row.shape)}, "
                                 f"tokens {tuple(tokens.shape)}, positions "
                                 f"{tuple(positions.shape)}, adapters "
                                 f"{_lora_args_text(adapters, adapter_ids)}")
            logits, _ = module(tokens, positions=positions, caches=pools,
                               block_tables=block_row, adapters=adapters,
                               adapter_ids=adapter_ids)
            return logits

        with self._lock:
            return self._prefill_cache.setdefault(key, prefill)

    def _get_decode_step(self, slots: int, max_len: int, k: int = 1, lora: bool = False):
        """Port of ``_get_decode_step``: the program of ``k`` decode steps
        over the dense batcher's slot pool, cached under ``("pipestep",
        slots, max_len, k, lora)`` (not generate()'s one-step ``_get_decode``).
        Its call ``step(caches, last_tok, next_pos, keys, temperature)``
        (``caches`` a slot pool of ``slots`` rows of ``max_len`` positions,
        ``Transformer.init_slot_caches``) feeds each slot's ``last_tok`` at
        ``next_pos``, also its write offset (a slot past its row, a free one
        stepping on, writes the trash column), and otherwise runs as
        ``_get_decode_step_paged``: sampling state on the device, ``last_tok``,
        ``next_pos`` and ``keys`` updated in place, the tokens [slots, k]
        returned, ``lora=True`` taking ``adapters`` and ``adapter_ids``.
        Nothing is read back to the host, so the same call is what a CUDA
        graph captures (``servers/step_graph.py``)."""
        slots, max_len, k, lora = int(slots), int(max_len), int(k), bool(lora)
        key = ("pipestep", slots, max_len, k, lora)
        with self._lock:
            fn = self._decode_cache.get(key)
        if fn is not None:
            return fn
        module, top_k = self._module, self.top_k

        def step(caches, last_tok, next_pos, keys, temperature, adapters=None,
                 adapter_ids=None):
            if (getattr(caches, "width", None) is None
                    or module.cache_lead(caches) != (slots, max_len)
                    or last_tok.shape != (slots,)
                    or _lora_args_bad(lora, adapters, adapter_ids, slots)):
                raise ValueError(f"decode step {key}: caches {module.cache_lead(caches)} "
                                 f"(a slot pool: {getattr(caches, 'width', None) is not None}), "
                                 f"last_tok {tuple(last_tok.shape)}, adapters "
                                 f"{_lora_args_text(adapters, adapter_ids)}")
            return _decode_steps(module, k, top_k, last_tok, next_pos, keys, temperature,
                                 caches=caches, cache_index=next_pos, adapters=adapters,
                                 adapter_ids=adapter_ids)

        with self._lock:
            return self._decode_cache.setdefault(key, step)

    def _get_decode_step_paged(self, slots: int, n_pages: int, k: int = 1, lora: bool = False):
        """Port of ``_get_decode_step_paged``: the program of ``k`` decode
        steps over the paged pool, cached under ``("pagedstep", slots,
        n_pages, k, lora)``. Its call ``step(pools, last_tok, next_pos, keys,
        temperature, block_tables)`` runs the steps with the sampling state
        on the device (one key split per step, ``sample_tokens``), leaves
        ``last_tok``, ``next_pos`` and ``keys`` updated in place (the JAX
        package donated them) and returns the tokens [slots, k]; the pools
        are written in place, the block tables only read. ``lora=True`` is
        the adapted program: the call also takes ``adapters`` (the adapter
        pool) and ``adapter_ids`` ([slots] int, 0 = the identity). Nothing is
        read back to the host, so the same call is what a CUDA graph
        captures (``servers/step_graph.py``)."""
        slots, n_pages, k, lora = int(slots), int(n_pages), int(k), bool(lora)
        key = ("pagedstep", slots, n_pages, k, lora)
        with self._lock:
            fn = self._decode_cache.get(key)
        if fn is not None:
            return fn
        module, top_k = self._module, self.top_k

        def step(pools, last_tok, next_pos, keys, temperature, block_tables, adapters=None,
                 adapter_ids=None):
            if (tuple(block_tables.shape) != (slots, n_pages) or last_tok.shape != (slots,)
                    or _lora_args_bad(lora, adapters, adapter_ids, slots)):
                raise ValueError(f"decode step {key}: block_tables {tuple(block_tables.shape)}, "
                                 f"last_tok {tuple(last_tok.shape)}, adapters "
                                 f"{_lora_args_text(adapters, adapter_ids)}")
            return _decode_steps(module, k, top_k, last_tok, next_pos, keys, temperature,
                                 caches=pools, block_tables=block_tables, adapters=adapters,
                                 adapter_ids=adapter_ids)

        with self._lock:
            return self._decode_cache.setdefault(key, step)

    def _get_spec_step(self, slots: int, spec_k: int, hist_len: int, *, mode: str = "ngram",
                       layout: str = "paged", n_pages: int = 0, lora: bool = False):
        """Port of ``_get_spec_step``: ONE dispatch drafts up to K tokens a
        slot, verifies them in a single K+1-column target forward, and
        accepts the longest prefix that agrees with the slot's sampling
        chain, cached under ``("specstep", slots, spec_k, hist_len, mode,
        layout, n_pages, lora)``. Its call ``step(pools, last_tok, next_pos,
        keys, temperature, block_tables, hist, draft_cap, draft_caches=None)``
        (``layout="dense"``: ``pools`` the dense batcher's slot pool of
        ``hist_len`` positions a row, ``Transformer.init_slot_caches``, and
        ``block_tables`` None)
        (``lora=True``: also ``adapters`` and ``adapter_ids`` [slots], which
        only the target's verify reads; the drafts stay base) computes, in
        order:

        - the proposer: ``mode="ngram"`` matches the longest (up to
          ``spec_ngram``) trailing n-gram of the slot's history ``hist``
          against every earlier position (longest match wins, the most
          recent breaks ties) and proposes the K tokens that followed it;
          ``mode="draft"`` runs K+1 greedy forwards of the draft model over
          its dense cache ``draft_caches`` ([slots, max_len + 1, ...]), from
          the last accepted token (no rng is drawn for drafting);
        - the clamp of the offer to ``draft_cap`` [slots] int32 (the
          batcher's acceptance-rate controller and its budget and cache
          edges);
        - the target forward over ``[last_tok, d_1..d_K]`` at positions
          next_pos.. (PAD_POS past the cap), its attention through
          ``ops.paged_attention`` with the columns folded into rows
          (``Transformer.forward(verify=True)``); over a dense slot pool a
          K+1-column forward whose tokens write each at its position (a
          PAD_POS column, or one past the row, to the trash column) and
          read the plain masked attention, as the JAX package's;
        - the chain-exact accept loop: column j's logits sampled with
          ``sample_tokens`` give token j+1, the key is split only while
          accepting, and a draft is accepted while the sample equals it;
        - the history append (the fed token and the accepted samples; a
          write past the history lands in its last column, a trash column:
          ``hist`` is [slots, hist_len + 1]) and the reject repair: the
          position rows of the columns that lost verification go back to
          PAD_POS (the pool through ``paged_write_targets``, a column past
          the table to TRASH; a dense slot pool and the draft cache by
          position, past their length to their trash column).

        ``last_tok``, ``next_pos``, ``keys`` and ``hist`` are updated in
        place (the JAX package donated them), the pools and draft caches
        written in place. It returns one int64 tensor [slots, K+2]: the
        tokens [slots, K+1] and, in its last column, ``n_acc`` [slots], the
        tokens each slot advanced (1..K+1): one buffer, so the batcher
        stages both to the host in one copy. Nothing is read back to the
        host, so the same call is what a CUDA graph captures
        (``servers/step_graph.capture_spec_step``). A jnp ``mode="drop"``
        scatter has no PyTorch twin: the writes that drop in the JAX
        package land in trash columns here."""
        from seldon_core_tpu_torch.models.transformer import (
            PAD_POS, normalize_kv_cache_layout, paged_write_targets)
        from seldon_core_tpu_torch.runtime.spec import DEFAULT_SPEC_NGRAM, normalize_spec_mode

        mode = normalize_spec_mode(mode)
        if mode == "off":
            raise ValueError("_get_spec_step needs spec mode 'ngram' or 'draft'")
        layout = normalize_kv_cache_layout(layout)
        paged = layout == "paged"
        S, K, H, n_pages, lora = int(slots), int(spec_k), int(hist_len), int(n_pages), bool(lora)
        if K < 1:
            raise ValueError(f"spec_k={K} must be >= 1")
        draft = mode == "draft"
        if draft and self._draft_module is None:
            raise ValueError("spec mode 'draft' needs the server loaded with draft_model=")
        key = ("specstep", S, K, H, mode, layout, n_pages, lora)
        with self._lock:
            fn = self._decode_cache.get(key)
        if fn is not None:
            return fn
        module, dmodule, top_k = self._module, self._draft_module, self.top_k
        lead = module.cache_lead
        ngram = max(self.spec_ngram or DEFAULT_SPEC_NGRAM, 1)

        def propose_ngram(hist, next_pos, cap):
            dev = hist.device
            hv = hist[:, :H]
            pos = next_pos.long()
            idx = torch.arange(H, device=dev)
            ok = torch.ones((S, H), dtype=torch.bool, device=dev)
            length = torch.zeros((S, H), dtype=torch.int64, device=dev)
            for j in range(ngram):
                hj = hv[:, (idx - j).clamp(0, H - 1)]
                cj = hv.gather(1, (pos - j).clamp(0, H - 1)[:, None])
                ok = ok & (hj == cj) & ((idx - j) >= 0)[None, :] & ((pos - j) >= 0)[:, None]
                length = length + ok
            cand = idx[None, :] < pos[:, None]
            score = torch.where(cand & (length > 0), length * H + idx[None, :], -1)
            best = score.argmax(dim=1)
            has = score.gather(1, best[:, None])[:, 0] >= 0
            src = best[:, None] + torch.arange(1, K + 1, device=dev)[None, :]
            drafts = hv.gather(1, src.clamp(0, H - 1))
            dlen = torch.where(has, (src <= pos[:, None]).sum(dim=1), 0)
            return drafts, torch.minimum(dlen, cap)

        def propose_draft(draft_caches, last_tok, next_pos):
            width = draft_caches[0][-1].shape[1] - 1   # column `width` is the trash column
            tok, pos, out = last_tok, next_pos, []
            for _ in range(K + 1):
                logits, _ = dmodule(tok[:, None], positions=pos[:, None], caches=draft_caches,
                                    cache_index=pos.clamp(max=width))
                tok = torch.argmax(logits[:, -1], dim=-1)
                out.append(tok)
                pos = pos + 1
            return torch.stack(out[:K], dim=1)

        def step(pools, last_tok, next_pos, keys, temperature, block_tables, hist, draft_cap,
                 draft_caches=None, adapters=None, adapter_ids=None):
            bad_pool = (tuple(block_tables.shape) != (S, n_pages) if paged else
                        block_tables is not None or getattr(pools, "width", None) is None
                        or module.cache_lead(pools) != (S, H))
            if (bad_pool or last_tok.shape != (S,)
                    or tuple(hist.shape) != (S, H + 1) or draft_cap.shape != (S,)
                    or (draft_caches is None) == draft
                    or _lora_args_bad(lora, adapters, adapter_ids, S)):
                raise ValueError(f"spec step {key}: block_tables "
                                 f"{None if block_tables is None else tuple(block_tables.shape)}, "
                                 f"pool {None if paged or pools is None else lead(pools)}, "
                                 f"last_tok {tuple(last_tok.shape)}, hist {tuple(hist.shape)}, "
                                 f"draft_cap {tuple(draft_cap.shape)}, draft caches "
                                 f"{'given' if draft_caches is not None else 'missing'}, "
                                 f"adapters {_lora_args_text(adapters, adapter_ids)}")
            dev = last_tok.device
            cap = draft_cap.long().clamp(0, K)
            if draft:
                drafts, dlen = propose_draft(draft_caches, last_tok, next_pos), cap
            else:
                drafts, dlen = propose_ngram(hist, next_pos, cap)
            cols = torch.arange(K + 1, device=dev, dtype=torch.int32)
            tokens_in = torch.cat([last_tok[:, None], drafts], dim=1)
            positions = torch.where(cols[None, :] <= dlen[:, None], next_pos[:, None] + cols,
                                    PAD_POS)
            if paged:
                logits, _ = module(tokens_in, positions=positions, caches=pools,
                                   block_tables=block_tables, adapters=adapters,
                                   adapter_ids=adapter_ids, verify=True)
            else:
                logits, _ = module(tokens_in, positions=positions, caches=pools,
                                   cache_index=next_pos, adapters=adapters,
                                   adapter_ids=adapter_ids)
            # chain-exact accept loop: sample column j -> token j+1; the key
            # advances ONLY while accepting
            out = torch.zeros((S, K + 2), dtype=torch.int64, device=dev)
            a = torch.zeros((S,), dtype=torch.int64, device=dev)
            valid = torch.ones((S,), dtype=torch.bool, device=dev)
            cur = keys
            for j in range(K + 1):
                split, sj = sample_tokens(cur, logits[:, j], temperature, top_k)
                cur = torch.where(valid, split, cur)
                a = a + valid
                out[:, j] = torch.where(valid, sj, 0)
                if j < K:
                    valid = valid & (sj == tokens_in[:, j + 1]) & (dlen > j)
            out[:, K + 1] = a
            toks = out[:, :K + 1]
            # history append: the fed token and the a accepted samples, at
            # next_pos..next_pos + a; the rest (and any past H) to column H
            wcols = torch.arange(K + 2, device=dev)
            wpos = next_pos.long()[:, None] + wcols[None, :]
            wpos = torch.where((wcols[None, :] <= a[:, None]) & (wpos < H), wpos, H)
            hist.scatter_(1, wpos, torch.cat([last_tok[:, None], toks], dim=1))
            hist[:, H].zero_()   # the trash column, written in no set order
            # reject repair: columns a..K lost verification
            rcols = cols[1:]
            rej = rcols[None, :].long() >= a[:, None]
            rpos = torch.where(rej, next_pos[:, None] + rcols, PAD_POS)
            pad = torch.full_like(rpos, PAD_POS)
            if paged:
                entry, off = paged_write_targets(block_tables, rpos, pools[0][0].shape[1])
                for layers, local in module.pool_ranks(pools, entry):
                    for layer in layers:
                        layer[-1][local, off] = pad
            else:
                for layers, rows, at in module.slot_columns(pools, rpos):
                    ri = torch.arange(at.shape[0], device=dev)[:, None]
                    for layer in layers:
                        layer[-1][ri, at] = pad[rows]
            if draft:
                width = draft_caches[0][-1].shape[1] - 1
                rows = torch.arange(S, device=dev)[:, None]
                dcol = torch.where(rej & (rpos < width), rpos, width).long()
                for layer in draft_caches:
                    layer[-1][rows, dcol] = pad
            last_tok.copy_(toks.gather(1, (a - 1)[:, None])[:, 0])
            next_pos.add_(a.to(next_pos.dtype))
            keys.copy_(cur)
            return out

        with self._lock:
            return self._decode_cache.setdefault(key, step)

    def _graph_stream(self) -> torch.cuda.Stream:
        """The server's one capture stream (made at first use): every
        batcher captures its prefill and decode graphs on it, so cuBLAS
        keeps one workspace for them all."""
        with self._lock:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(device=self.device)
            return self._capture_stream

    def _generate_stream(self) -> torch.cuda.Stream:
        """The capture stream of ``generate()``'s decode graphs (made at
        first use), apart from the batchers' (``_graph_stream``): cuBLAS
        binds one workspace per (handle, stream), and the batcher's thread
        replays while REST threads run ``generate()``."""
        with self._lock:
            if self._gen_stream is None:
                self._gen_stream = torch.cuda.Stream(device=self.device)
            return self._gen_stream

    def _dense_for(self, b: int, max_len: int) -> _DenseBuffer:
        """The dense buffer, grown to hold ``b`` x ``max_len`` if it is
        smaller. A growth drops every captured generate graph (they hold
        the old addresses) and is counted. Called under ``_dense_lock``."""
        need = int(b) * int(max_len)
        if self._dense is None or self._dense.capacity < need:
            if self._dense is not None:
                self._dense_growths += 1
            self._generate_graphs.clear()
            self._generate_pool = None
            self._dense = None   # the old buffer goes before the new one is made
            self._dense = _DenseBuffer(self._module, self.kv_cache_dtype, need,
                                       self.batch_buckets[-1], self.device)
        return self._dense

    def _generate_graph(self, b: int, max_len: int, dense: _DenseBuffer):
        """The decode step of ``(b, max_len)`` as a CUDA graph over the
        dense buffer's views, captured at first use on the generate stream,
        in the one memory pool every generate graph shares (they replay one
        at a time, under ``_dense_lock``, which the caller holds)."""
        from seldon_core_tpu_torch.servers.step_graph import capture_generate_step

        key = (int(b), int(max_len))
        graph = self._generate_graphs.get(key)
        if graph is None:
            if self._generate_pool is None:
                self._generate_pool = torch.cuda.graph_pool_handle()
            graph = capture_generate_step(self, b, max_len, dense.caches(b, max_len),
                                          *dense.state(b), dense.temperature,
                                          self._generate_pool)
            self._generate_graphs[key] = graph
        return graph

    # ------------------------------------------------------------------
    # generate()'s dense prefix cache (the batcher's is its radix trie)
    # ------------------------------------------------------------------
    @staticmethod
    def _entry_nbytes(caches, last_logits) -> int:
        n = 0 if last_logits is None else last_logits.numel() * last_logits.element_size()
        return n + sum(t.numel() * t.element_size() for layer in caches for t in layer)

    def clear_prefix_cache(self) -> None:
        """Drop every dense entry AND its byte accounting, and clear the
        shared batcher's radix trie too: both layers read as cold
        together."""
        with self._prefix_lock:
            self._prefix_cache.clear()
            self._prefix_index.clear()
            self._prefix_bytes = 0
        radix = self._batcher_radix()
        if radix is not None:
            radix.clear()

    def _batcher_radix(self):
        """The shared batcher's radix trie, or None."""
        svc = getattr(self, "_batcher_service", None)
        return svc.batcher._radix if svc is not None else None

    def _prefix_lookup(self, tokens: List[int], max_len: Optional[int] = None):
        """Longest cached prefix of ``tokens`` of this server's KV dtype (and,
        with ``max_len``, of exactly that cache length: the entry is copied
        whole into the dense buffer's view of that geometry); returns
        (prefix_len, entry_max_len, caches, last_logits) or None. An exact
        full-prompt hit's stored logits skip the prefill. One walk of the
        prompt down the index, under ``_prefix_lock``."""
        with self._prefix_lock:
            best = None
            for key in self._prefix_index.candidates(tokens):
                entry_max_len, entry_kvd, caches, last_logits, _nb = self._prefix_cache[key]
                if entry_kvd != self.kv_cache_dtype:
                    continue
                if max_len is not None and entry_max_len != max_len:
                    continue
                # candidates arrive shortest -> longest: the last passer is
                # the longest compatible prefix
                best = (len(key), entry_max_len, caches, last_logits)
            if best is not None:
                self._prefix_cache.move_to_end(tuple(tokens[:best[0]]))
                self._prefix_hits += 1
            return best

    def _prefix_store(self, tokens: List[int], max_len: int, caches, last_logits) -> None:
        """Store a COPY of ``caches`` (the dense buffer's views, before any
        decode step writes them) and ``last_logits`` under ``tokens``, then
        evict least-recently-used entries past the count or byte budget. An
        entry over the byte budget alone is not stored (warned once)."""
        key = tuple(tokens)
        nbytes = self._entry_nbytes(caches, last_logits)
        if self.prefix_cache_bytes and nbytes > self.prefix_cache_bytes:
            if not self._prefix_overbudget_warned:
                self._prefix_overbudget_warned = True
                logger.warning(
                    "prefix cache entry (%d bytes) exceeds prefix_cache_bytes (%d); nothing "
                    "will be cached — raise prefix_cache_bytes for this model size",
                    nbytes, self.prefix_cache_bytes)
            return
        entry = ([tuple(t.clone() for t in layer) for layer in caches],
                 None if last_logits is None else last_logits.clone())
        with self._prefix_lock:
            old = self._prefix_cache.pop(key, None)
            if old is not None:
                self._prefix_bytes -= old[-1]
            else:
                self._prefix_index.add(key)
            self._prefix_cache[key] = (max_len, self.kv_cache_dtype, *entry, nbytes)
            self._prefix_bytes += nbytes
            while self._prefix_cache and (
                    len(self._prefix_cache) > self.prefix_cache_size
                    or (self.prefix_cache_bytes and self._prefix_bytes > self.prefix_cache_bytes)):
                evicted, old = self._prefix_cache.popitem(last=False)
                self._prefix_index.remove(evicted)
                self._prefix_bytes -= old[-1]

    def prefix_match_len(self, prompt: Any) -> int:
        """Cached-prefix length (tokens) this server holds for ``prompt``:
        the shared batcher's radix trie when one exists, else the dense
        entry index. No device work, no pinning."""
        if not self.ready:
            return 0
        if isinstance(prompt, str):
            ids = self._tokenizer.encode(prompt)
        else:
            ids = [int(t) for t in np.asarray(prompt).ravel()]
        radix = self._batcher_radix()
        if radix is not None:
            return radix.match_len(ids)
        with self._prefix_lock:
            cands = self._prefix_index.candidates(ids)
            return len(cands[-1]) if cands else 0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(
        self,
        prompts: Sequence[Any],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: Optional[int] = None,
        _eager: bool = False,
    ) -> Dict[str, Any]:
        """prompts: list of strings or of int token lists/arrays. The
        private, non-batched path (and the batcher's parity oracle): the
        dense prefill program over the server's dense buffer, the first
        token sampled on the device, then ``max_new - 1`` decode steps: on
        the card one replay each of the step's CUDA graph for (batch
        bucket, max_len), captured at first use; the eager program on the
        CPU, or on the card only under the private ``_eager`` switch. The
        tokens reach the host in one copy at the end."""
        from seldon_core_tpu_torch.models.transformer import PAD_POS

        if not self.ready:
            self.load()
        max_new = int(max_new_tokens or self.max_new_tokens)
        temp = self.temperature if temperature is None else float(temperature)

        token_lists: List[List[int]] = []
        text_mode = []
        for p in prompts:
            if isinstance(p, str):
                token_lists.append(self._tokenizer.encode(p))
                text_mode.append(True)
            else:
                token_lists.append([int(t) for t in np.asarray(p).ravel()])
                text_mode.append(False)
        if not token_lists:
            raise SeldonError("generate() needs at least one prompt")
        if any(len(t) == 0 for t in token_lists):
            raise SeldonError("empty prompt")

        n = len(token_lists)
        max_batch = self.batch_buckets[-1]
        if n > max_batch:
            out_tokens, out_texts = [], []
            for i in range(0, n, max_batch):
                part = self.generate(prompts[i: i + max_batch], max_new_tokens=max_new,
                                     temperature=temp, seed=seed, _eager=_eager)
                out_tokens.extend(part["tokens"])
                out_texts.extend(part["texts"])
            return {"tokens": out_tokens, "texts": out_texts}
        nb = bucket(n, self.batch_buckets)
        longest = max(len(t) for t in token_lists)
        plen = min(bucket(longest, self.len_buckets), self._cfg.max_seq_len)
        if longest > plen:
            logger.warning("prompt of %d tokens truncated to max_seq_len %d", longest, plen)
        token_lists = [t[-plen:] for t in token_lists]  # keep the prompt tail
        # one prompt with the prefix cache on: one cache length for every
        # call (entries serve only their own geometry), never below the
        # prompt's bucket; entries are looked up and stored for a 1-row call
        single = self.prefix_cache_size > 0 and n == 1
        use_prefix = single and nb == 1
        if single:
            max_len = (max(plen, min(self.len_buckets[-1], self._cfg.max_seq_len))
                       + max(max_new, self.max_new_tokens))
        else:
            max_len = min(plen + max_new, self._cfg.max_seq_len + max_new)
        if self.mesh is not None:
            # round the cache length up to a multiple of the seq axis so the
            # KV cache can actually shard over it
            sp = self.mesh.axis_size("seq")
            if sp > 1:
                max_len = -(-max_len // sp) * sp

        tokens = np.zeros((nb, plen), np.int64)
        positions = np.full((nb, plen), PAD_POS, np.int32)
        true_len = np.ones((nb,), np.int64)  # dummy rows decode from slot 1
        for i, toks in enumerate(token_lists):
            L = len(toks)
            tokens[i, :L] = toks
            positions[i, :L] = np.arange(L)
            true_len[i] = L
        # explicit seed => reproducible; otherwise vary per request
        with self._lock:
            request_index = self._request_count
            self._request_count += 1
        base = int(seed) if seed is not None else self.seed + request_index

        dev = self.device
        graphs = dev.type == "cuda" and not _eager
        with self._dense_lock:
            dense = self._dense_for(nb, max_len)
            caches = dense.caches(nb, max_len)
            tok, pos, done, keys = dense.state(nb)
            true_len_t = torch.from_numpy(true_len).to(dev)
            first_logits = self._prefill_prefix(token_lists[0], max_len, caches) \
                if use_prefix else None
            if first_logits is None:
                logits = self._get_prefill(nb, plen, max_len)(
                    caches, torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(positions).to(dev))
                # next-token logits live at each sequence's last real slot
                first_logits = logits[torch.arange(nb, device=dev), true_len_t - 1]
                del logits
                if use_prefix:
                    self._prefix_store(token_lists[0], max_len, caches, first_logits)
            keys.copy_(torch.tensor(_row_keys(base, nb), dtype=torch.int64))
            dense.temperature.fill_(temp)
            new_keys, first = sample_tokens(keys, first_logits, dense.temperature, self.top_k)
            keys.copy_(new_keys)
            out = torch.empty((nb, max_new), dtype=torch.int64, device=dev)
            out[:, 0] = first
            if max_new > 1:
                self._last_decode_kv_bytes = self._entry_nbytes(caches, None)
                tok.copy_(first)
                pos.copy_(true_len_t)
                done.zero_()
                step = self._get_decode(nb, max_len)
                graph = self._generate_graph(nb, max_len, dense) if graphs else None
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                t0 = time.perf_counter()
                for j in range(1, max_new):
                    out[:, j] = (graph.replay() if graph is not None else
                                 step(caches, tok, pos, done, keys, dense.temperature))
                all_toks = out.cpu().numpy()[:n]
                # as the JAX package records it: the decode wall, the sync
                # to the host included, per step
                self._decode_step_times.append((time.perf_counter() - t0) / (max_new - 1))
                if graph is not None:
                    self._generate_replays += max_new - 1
                else:
                    self._generate_eager += max_new - 1
            else:
                all_toks = out.cpu().numpy()[:n]

        results_tokens: List[List[int]] = []
        results_text: List[Optional[str]] = []
        for i in range(n):
            seq = all_toks[i].tolist()
            if self.eos_id in seq:
                seq = seq[: seq.index(self.eos_id)]
            results_tokens.append(seq)
            results_text.append(self._tokenizer.decode(seq) if text_mode[i] else None)
        return {"tokens": results_tokens, "texts": results_text}

    def _prefill_prefix(self, prompt: List[int], max_len: int, caches):
        """generate()'s prefix-cache path for one prompt, into ``caches`` (the
        dense buffer's [1, max_len] views; the caller holds ``_dense_lock``):
        on an exact hit the entry's caches are copied in and its stored
        first-token logits returned (no prefill runs); on a partial hit the
        entry is copied in, the suffix prefilled at its offset
        (``_get_extend``) and the extended prompt stored; on a miss None
        (the caller prefills and stores)."""
        from seldon_core_tpu_torch.models.transformer import PAD_POS

        hit = self._prefix_lookup(prompt, max_len)
        if hit is None:
            return None
        p0, _, entry, entry_logits = hit
        for layer, stored in zip(caches, entry):
            for t, e in zip(layer, stored):
                t.copy_(e)
        if p0 == len(prompt):
            return entry_logits
        suffix = prompt[p0:]
        L = len(suffix)
        slen = min(bucket(L, self.len_buckets), max_len - p0)
        stoks = np.zeros((1, slen), np.int64)
        spos = np.full((1, slen), PAD_POS, np.int32)
        stoks[0, :L] = suffix
        spos[0, :L] = np.arange(p0, p0 + L)
        dev = self.device
        logits = self._get_extend(1, slen, max_len)(
            caches, torch.from_numpy(stoks).to(dev), torch.from_numpy(spos).to(dev), p0)
        first_logits = logits[:, L - 1]
        self._prefix_store(prompt, max_len, caches, first_logits)
        return first_logits

    # ------------------------------------------------------------------
    # SeldonComponent surface
    # ------------------------------------------------------------------
    def predict(self, X, names: Sequence[str], meta: Optional[Dict] = None):
        """strData -> the generated text; jsonData ``{"prompts" | "prompt",
        "max_new_tokens", "temperature", "seed"}`` -> ``{"texts", "tokens"}``;
        an int array (rows right-padded with -1) -> int64 tokens, -1-padded."""
        if isinstance(X, (bytes, bytearray)):
            X = X.decode("utf-8")
        if isinstance(X, str):
            return self.generate([X])["texts"][0]
        if isinstance(X, dict):
            prompts = X.get("prompts") or X.get("prompt")
            if prompts is None:
                raise SeldonError("jsonData needs 'prompts'")
            if isinstance(prompts, str):
                prompts = [prompts]
            out = self.generate(prompts, max_new_tokens=X.get("max_new_tokens"),
                                temperature=X.get("temperature"), seed=X.get("seed"))
            return {"texts": out["texts"], "tokens": out["tokens"]}
        arr = np.atleast_2d(np.asarray(X, dtype=np.int64))
        prompts = [row[row >= 0] for row in arr]  # -1 right-padding
        out = self.generate(prompts)
        width = max(len(t) for t in out["tokens"])
        padded = np.full((len(prompts), width), -1, np.int64)
        for i, t in enumerate(out["tokens"]):
            padded[i, :len(t)] = t
        return padded

    def tags(self) -> Dict[str, Any]:
        """``{"llm_requests": N}``: private ``generate()`` calls so far; with
        the prefix cache on also ``prefix_cache_hits`` and
        ``prefix_cache_entries`` (the dense entries)."""
        with self._lock:
            out = {"llm_requests": self._request_count}
        if self.prefix_cache_size:
            with self._prefix_lock:
                out["prefix_cache_hits"] = self._prefix_hits
                out["prefix_cache_entries"] = len(self._prefix_cache)
        return out

    def flight_recorder(self):
        """The shared batcher's flight recorder (``runtime/flight.py``), or
        None without a batcher service or with tracing off: the data of
        ``/debug/timeline`` and gRPC ``DebugTimeline``."""
        svc = getattr(self, "_batcher_service", None)
        if svc is None:
            return None
        return svc.batcher._flight

    def llm_stats(self) -> Dict[str, Any]:
        """The serving snapshot a /metrics scrape reads
        (``metrics/registry.MetricsRegistry.sync_llm``): the page pool's
        gauges (fragmentation included), slot occupancy, the resident KV
        bytes (the batcher's pool plus the dense prefix entries), the KV
        bytes the last decode read a step, the steps in flight, the
        speculation counters and the radix trie's counters of the shared
        batcher (zeros without one, or with either off), the dense prefix
        cache's hits and entries, the adapter pool's gauges, the
        scheduler's per-(tenant, class) tallies and queue depth by class,
        the handoff counters (``disaggregation``, ``handoffs_total``,
        ``handoff_transfer_bytes_total``, ``handoff_queue_depth``,
        ``handoff_network_bytes_total``: zeros with disaggregation off),
        and the TTFT (also by class), inter-token, decode, handoff and
        accepted-tokens series accumulated since the last call, drained
        here so each is observed exactly once. The trie is walked once a
        call."""
        from seldon_core_tpu_torch.runtime.spec import SPEC_STATS_OFF

        def drain(dq) -> List[float]:
            out: List[float] = []
            while True:
                try:
                    out.append(dq.popleft())
                except IndexError:
                    return out

        page_stats = {"kv_pages_total": 0, "kv_pages_in_use": 0, "kv_page_size": 0,
                      "kv_page_fragmentation": 0.0, "kv_page_sheds": 0}
        prefix_stats = dict.fromkeys(("prefix_cached_blocks", "prefix_shared_pages",
                                      "prefix_hit_blocks", "prefix_hit_tokens",
                                      "prefix_cow_copies", "prefix_evicted_blocks",
                                      "prefix_bytes_saved"), 0)
        in_flight = 0
        occupancy = 0.0
        pool_bytes = 0
        spec_stats = dict(SPEC_STATS_OFF)
        adapter_stats = {"adapter_loaded": 0, "adapter_evictions_total": 0,
                         "adapter_pool_bytes": 0}
        if self.adapter_registry is not None:
            snap = self.adapter_registry.stats()
            adapter_stats = {k: snap[k] for k in adapter_stats}
        tenant_counters: List[dict] = []
        queue_by_class: Dict[str, int] = {}
        svc = getattr(self, "_batcher_service", None)
        if svc is not None:
            batcher = svc.batcher
            radix_stats = batcher._radix.stats() if batcher._radix is not None else None
            if radix_stats is not None:
                prefix_stats.update(radix_stats)
            page_stats = batcher.page_stats(radix_stats=radix_stats)
            in_flight = len(batcher._inflight)
            occupancy = sum(1 for s in batcher._slots if s.active) / max(batcher.S, 1)
            pool_bytes = batcher._cache_nbytes
            spec_stats = batcher.spec_stats()
            tenant_counters = batcher._pending.counters()
            queue_by_class = batcher._pending.depths()
        handoff_stats = {"disaggregation": self.disaggregation or "off", "handoffs_total": 0,
                         "handoff_transfer_bytes_total": 0, "handoff_queue_depth": 0,
                         "handoff_network_bytes_total": 0}
        if svc is not None:
            handoff_stats.update(svc.batcher.handoff_stats())
        with self._prefix_lock:
            prefix_bytes = self._prefix_bytes
            hits, entries = self._prefix_hits, len(self._prefix_cache)
        return {
            **page_stats,
            "kv_cache_bytes": pool_bytes + prefix_bytes,
            "kv_occupancy": occupancy,
            "kv_bytes_per_step": self._last_decode_kv_bytes,
            "decode_step_times_s": drain(self._decode_step_times),
            "decode_dispatch_times_s": drain(self._decode_dispatch_times),
            "decode_sync_times_s": drain(self._decode_sync_times),
            "decode_host_lag_steps": drain(self._decode_host_lag),
            "decode_steps_in_flight": in_flight,
            **spec_stats,
            "spec_accepted_per_step": drain(self._spec_accepted),
            "ttft_s": drain(self._ttft_times),
            "inter_token_s": drain(self._inter_token_times),
            **prefix_stats,
            "prefix_cache_hits": hits,
            "prefix_cache_entries": entries,
            **adapter_stats,
            "tenant_counters": tenant_counters,
            "queue_by_class": queue_by_class,
            "ttft_by_class": drain(self._ttft_by_class),
            **handoff_stats,
            "handoff_times_s": drain(self._handoff_times),
        }


__all__ = ["ByteTokenizer", "LLMServer", "bucket", "fast_forward_key", "first_token",
           "sample_tokens", "seed_key", "split_keys"]
