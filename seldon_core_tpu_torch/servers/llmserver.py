"""LLM_SERVER: autoregressive text generation, ported to PyTorch.

Port of ``seldon_core_tpu/servers/llmserver.py``: the same constructor
arguments and defaults (plus ``device``), the byte tokenizer, ``load`` for a
randomly initialised model or converted JAX weights, the private dense
``generate()`` path, and the paged chunked-prefill / decode-step programs the
continuous batcher (``runtime/batcher.py``) drives. PyTorch runs eagerly, so
the JAX package's compiled-program caches (``_get_prefill`` ...) become plain
methods (``_prefill`` ...).

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

Weight-only int8 (``quantize="int8"``) and the int8 KV cache
(``kv_cache_dtype="int8"``) are served, alone or together, through every
path below. Knobs that belong to later slices raise ``NotImplementedError``
naming the slice when set to a non-default value; none is ignored silently.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
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


def sample_tokens(keys: torch.Tensor, logits: torch.Tensor, temperature: float,
                  top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Port of ``_slot_sampler``: per row, split the key, then greedy
    (temperature <= 0) or a temperature/top-k categorical draw. keys: [b]
    int64; logits: [b, vocab] float32. Returns (next keys, tokens [b])."""
    keys, sub = split_keys(keys)
    if temperature <= 0.0:
        return keys, torch.argmax(logits, dim=-1)
    k = min(int(top_k), logits.shape[-1])
    topv, topi = torch.topk(logits, k, dim=-1)
    j = torch.arange(k, device=logits.device, dtype=torch.int64)
    bits = _mix32((sub[:, None] + j * _GOLDEN) & _M32)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    gumbel = -torch.log(-torch.log(u))
    draw = torch.argmax(topv / max(float(temperature), 1e-6) + gumbel, dim=-1)
    return keys, topi.gather(-1, draw[:, None])[:, 0]


def _row_keys(base_seed: int, n: int) -> List[int]:
    """generate()'s per-row keys: row 0 starts the chain of ``base_seed``
    (the batcher's chain for the same seed), later rows fold their index in."""
    k0 = seed_key(base_seed)
    return [k0] + [_mix32(k0 ^ _mix32(i)) for i in range(1, n)]


class LLMServer(SeldonComponent):
    """Serves a registered transformer-family model for text generation.

    Parameters as the JAX package's (``model`` + ``init_random=True`` for a
    randomly initialised model; weights of a JAX model cross over with
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
        later = [
            ("model_uri", model_uri, "checkpoint loading (the JAX_SERVER/engine "
             "predict slice); JAX weights cross over with load(params=...)"),
            ("tokenizer", tokenizer != "bytes", "HF tokenizers (a later slice)"),
            ("mesh", mesh is not None, "the parallelism slice"),
            ("topology", topology is not None, "the parallelism slice"),
            ("tensor_parallel", int(tensor_parallel) > 1, "the parallelism slice"),
            ("sequence_parallel", int(sequence_parallel) > 1, "the parallelism slice"),
            ("decode_fuse_steps", int(decode_fuse_steps) > 1, "the decode_fuse_steps slice"),
            ("spec_mode", str(spec_mode or "off").lower() != "off",
             "the speculative-decoding slice"),
            ("spec_k", spec_k, "the speculative-decoding slice"),
            ("spec_ngram", spec_ngram, "the speculative-decoding slice"),
            ("draft_model", draft_model or draft_model_uri or draft_model_kwargs,
             "the speculative-decoding slice"),
            ("disaggregation", str(disaggregation or "off").lower() != "off",
             "the disaggregation slice"),
            ("prefill_devices/decode_devices/prefill_workers/handoff_transport/disagg_mesh",
             prefill_devices or decode_devices or prefill_workers or handoff_transport
             or disagg_mesh is not None, "the disaggregation slice"),
            ("prefix_cache_size", prefix_cache_size or prefix_cache_bytes,
             "the radix prefix-cache slice"),
            ("lora_rank", lora_rank or lora_adapters or int(lora_max_adapters) != 8,
             "the LoRA/tenants slice"),
            ("slo_class_weights/tenant_weights/tenant_quota(s)",
             slo_class_weights or tenant_weights or tenant_quota or tenant_quotas,
             "the LoRA/tenants slice"),
        ]
        for name, value, slice_name in later:
            if value:
                raise NotImplementedError(
                    f"LLMServer({name}=...) is not ported yet: it arrives with {slice_name}")
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
        self.seed = int(seed)
        self.ready = False
        self._eos_override = eos_id
        self._request_count = 0
        self._lock = threading.Lock()
        # serving observability, appended by the batcher: time to first
        # token per request and the drain-to-drain wall of each decode step
        self._ttft_times: Any = deque(maxlen=4096)
        self._decode_step_times: Any = deque(maxlen=4096)

    # ------------------------------------------------------------------
    def load(self, params: Optional[Dict[str, Any]] = None) -> None:
        """Build the model on ``self.device``. ``params`` (a JAX param tree
        of numpy arrays — ``models/convert.py``) fills it with converted
        weights; otherwise ``init_random=True`` draws them from a
        ``torch.Generator`` seeded with ``seed``. ``param_dtype`` "auto"
        stores the weights in the compute dtype, as the JAX package casts
        them; "" keeps float32 storage with a cast per use.

        ``quantize="int8"`` quantizes after that cast, as the JAX package
        orders it. A random or already-quantized (JAX ``quantize_params``
        tree) model is quantized as a layout first, on the meta device, and
        then filled leaf by leaf, so the float tree is never on the device:
        at Llama-2-7B the peak is the int8 tree plus one float32 leaf. A
        float JAX tree is loaded as floats and then quantized leaf by leaf."""
        if self.ready:
            return
        from seldon_core_tpu_torch.models import get_model
        from seldon_core_tpu_torch.models.convert import has_quantized_leaves, params_from_jax
        from seldon_core_tpu_torch.models.transformer import (
            normalize_kv_cache_dtype, normalize_kv_cache_layout, to_torch_dtype)

        self.kv_cache_dtype = normalize_kv_cache_dtype(self.kv_cache_dtype)
        self.kv_cache_layout = normalize_kv_cache_layout(self.kv_cache_layout)
        if self.param_dtype and self.param_dtype != "auto":
            to_torch_dtype(self.param_dtype)  # ValueError on an unknown name
        if self.quantize and self.quantize != "int8":
            raise SeldonError(f"unsupported quantize={self.quantize!r} (int8 only)",
                              status_code=500)
        if self.model_name is None:
            raise SeldonError("LLMServer needs model=<registry name>", status_code=500)
        if params is None and not self.init_random:
            raise SeldonError("No weights: pass init_random=True or load(params=...)",
                              status_code=500)
        quantized_tree = params is not None and has_quantized_leaves(params)
        if quantized_tree and not self.quantize:
            raise SeldonError("params hold int8 (quantized) leaves: load them with "
                              "quantize='int8'", status_code=500)
        layout_first = bool(self.quantize) and (params is None or quantized_tree)
        module = get_model(self.model_name, device="meta" if layout_first else self.device,
                           param_dtype=self.param_dtype or None, **self.model_kwargs)
        if layout_first:
            module.quantize_().to_empty(device=self.device)
        if params is not None:
            params_from_jax(params, module)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            module.init_params(gen)
        if self.quantize and not layout_first:
            module.quantize_()
        module.eval()
        self._module = module
        self._cfg = module.cfg
        self._tokenizer = ByteTokenizer()
        self.eos_id = self._eos_override if self._eos_override is not None else self._tokenizer.eos_id
        self.ready = True
        logger.info("LLMServer loaded %s (vocab=%d) on %s", self.model_name,
                    self._cfg.vocab_size, self.device)

    # ------------------------------------------------------------------
    # Forward programs (the JAX package's compiled stages, run eagerly)
    # ------------------------------------------------------------------
    def _prefill(self, tokens: torch.Tensor, positions: torch.Tensor, max_len: int):
        """Port of ``_get_prefill``: fresh dense caches of ``max_len``
        filled from offset 0. Returns (logits [b, plen, vocab], caches)."""
        from seldon_core_tpu_torch.models.transformer import init_kv_caches

        caches = init_kv_caches(self._cfg, tokens.shape[0], max_len, self.kv_cache_dtype,
                                device=self.device)
        return self._module(tokens, positions=positions, caches=caches, cache_index=0)

    def _decode(self, caches, last_tok: torch.Tensor, true_len: torch.Tensor,
                n_steps: int, keys: torch.Tensor, temperature: float) -> torch.Tensor:
        """Port of ``_get_decode``: ``n_steps`` decode steps over the dense
        caches (written in place), EOS-masked per sequence. Returns tokens
        [b, n_steps] on the device."""
        eos_id = self.eos_id
        tok = last_tok
        done = torch.zeros_like(last_tok, dtype=torch.bool)
        out = []
        for offset in range(n_steps):
            pos = true_len + offset
            logits, caches = self._module(tok[:, None], positions=pos[:, None],
                                          caches=caches, cache_index=pos)
            keys, nxt = sample_tokens(keys, logits[:, -1], temperature, self.top_k)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)

    def _prefill_chunk(self, pools, block_row: torch.Tensor, tokens: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
        """Port of ``_get_prefill_chunk``: write one chunk of one sequence's
        prompt into the paged pool (in place, through ``block_row`` [1,
        n_pages]) while attending over its earlier chunks. Returns logits
        [1, chunk, vocab]."""
        logits, _ = self._module(tokens, positions=positions, caches=pools,
                                 block_tables=block_row)
        return logits

    def _decode_step_paged(self, pools, last_tok: torch.Tensor, next_pos: torch.Tensor,
                           keys: torch.Tensor, temperature: float,
                           block_tables: torch.Tensor):
        """Port of ``_get_decode_step_paged`` (k = 1): one decode step over
        every slot with the sampling state on the device. Returns the next
        (last_tok, next_pos, keys) and the step's tokens [slots]; nothing is
        read back to the host here."""
        logits, _ = self._module(last_tok[:, None], positions=next_pos[:, None],
                                 caches=pools, block_tables=block_tables)
        keys, nxt = sample_tokens(keys, logits[:, -1], temperature, self.top_k)
        return nxt, next_pos + 1, keys, nxt

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(
        self,
        prompts: Sequence[Any],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> Dict[str, Any]:
        """prompts: list of strings or of int token lists/arrays. The
        private, non-batched path (and the batcher's parity oracle)."""
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
                                     temperature=temp, seed=seed)
                out_tokens.extend(part["tokens"])
                out_texts.extend(part["texts"])
            return {"tokens": out_tokens, "texts": out_texts}
        nb = bucket(n, self.batch_buckets)
        longest = max(len(t) for t in token_lists)
        plen = min(bucket(longest, self.len_buckets), self._cfg.max_seq_len)
        if longest > plen:
            logger.warning("prompt of %d tokens truncated to max_seq_len %d", longest, plen)
        token_lists = [t[-plen:] for t in token_lists]  # keep the prompt tail
        max_len = min(plen + max_new, self._cfg.max_seq_len + max_new)

        tokens = np.zeros((nb, plen), np.int64)
        positions = np.full((nb, plen), PAD_POS, np.int32)
        true_len = np.ones((nb,), np.int64)  # dummy rows decode from slot 1
        for i, toks in enumerate(token_lists):
            L = len(toks)
            tokens[i, :L] = toks
            positions[i, :L] = np.arange(L)
            true_len[i] = L

        dev = self.device
        logits, caches = self._prefill(torch.from_numpy(tokens).to(dev),
                                       torch.from_numpy(positions).to(dev), max_len)
        true_len_t = torch.from_numpy(true_len).to(dev)
        # next-token logits live at each sequence's last real slot
        first_logits = logits[torch.arange(nb, device=dev), true_len_t - 1]
        # explicit seed => reproducible; otherwise vary per request
        with self._lock:
            request_index = self._request_count
            self._request_count += 1
        base = int(seed) if seed is not None else self.seed + request_index
        keys = torch.tensor(_row_keys(base, nb), dtype=torch.int64, device=dev)
        keys, first_tok = sample_tokens(keys, first_logits, temp, self.top_k)

        out_tokens = [first_tok[:, None]]
        if max_new > 1:
            out_tokens.append(self._decode(caches, first_tok, true_len_t, max_new - 1,
                                           keys, temp))
        all_toks = torch.cat(out_tokens, dim=1).cpu().numpy()[:n]

        results_tokens: List[List[int]] = []
        results_text: List[Optional[str]] = []
        for i in range(n):
            seq = all_toks[i].tolist()
            if self.eos_id in seq:
                seq = seq[: seq.index(self.eos_id)]
            results_tokens.append(seq)
            results_text.append(self._tokenizer.decode(seq) if text_mode[i] else None)
        return {"tokens": results_tokens, "texts": results_text}


__all__ = ["ByteTokenizer", "LLMServer", "bucket", "sample_tokens", "seed_key",
           "split_keys"]
