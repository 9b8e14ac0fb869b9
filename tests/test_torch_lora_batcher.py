"""Batched LoRA through the port's paged batcher (``seldon_core_tpu_torch/
runtime/batcher.py`` with the server's adapter pool) against the JAX
package on the CPU, at the JAX ``tests/test_adapters.py`` widths (float32):

- three adapters and the identity in ONE batch: greedy, every request's
  tokens equal the JAX batcher's on the same weights and factors, and equal
  the request served alone; seeded-sampled (the port's own sampling chain,
  which does not reproduce ``jax.random``'s bits), equal the request served
  alone; the identity request equals the port's ``generate()``; on the
  CPU every chunk and dispatch runs the eager adapted programs;
- the identity through the adapted programs equals an unadapted server's
  batcher;
- the adapted n-gram speculative batcher equals the plain adapted batcher;
- adapted requests neither match nor insert into the radix trie;
- an adapter cannot be evicted while a request of it is queued or decoding;
- a staged prefill's shed, and a quota shed at submit, release the pin;
  an unknown adapter, or an adapter on a server without a pool, is 400."""

import asyncio
import threading
from concurrent.futures import Future

import numpy as np
import pytest

import jax

from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.runtime.adapters import projection_dims
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.runtime.resilience import ShedError
from seldon_core_tpu_torch.runtime.scheduler import PendingRequest
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
RANK = 4
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1,), temperature=0.0, eos_id=-1, seed=3, lora_rank=RANK,
              lora_max_adapters=6)
PROMPTS = [[5, 9, 17, 3], [11, 2, 63, 40, 7], [29, 29, 4], [77, 13, 8, 1, 90, 33]]
NAMES = ["tenant-0", "tenant-1", "tenant-2"]
ADAPTERS = NAMES + [None]


def load_adapters(server):
    """The three adapters of the JAX tests' ``load_adapters``."""
    rng = np.random.default_rng(1234)
    cfg = server._cfg
    for name in NAMES:
        w = {p: (rng.normal(size=(cfg.n_layers, din, RANK)) * 0.25,
                 rng.normal(size=(cfg.n_layers, RANK, dout)) * 0.25)
             for p, (din, dout) in projection_dims(cfg).items()}
        server.adapter_registry.load(name, w, alpha=2 * RANK)


def _jax_params(j):
    return {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}


@pytest.fixture(scope="module")
def pair():
    """(JAX server, port server): the same weights and adapters, greedy."""
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    load_adapters(j)
    p = LLMServer(device="cpu", **COMMON)
    p.load(params=_jax_params(j))
    load_adapters(p)
    return j, p


@pytest.fixture(scope="module")
def sampled():
    s = LLMServer(device="cpu", init_random=True, **dict(COMMON, temperature=0.8))
    s.load()
    load_adapters(s)
    return s


def serve(server, prompts, adapters, seed=None, max_new=6, slots=None, **kw):
    """All prompts at once through one paged batcher; their token lists."""
    b = ContinuousBatcher(server, max_slots=slots or len(prompts), max_len=40,
                          len_buckets=(8,), page_size=8, device="cpu", **kw)
    try:
        futs = [b.submit(p, max_new_tokens=max_new, adapter=a, seed=seed, tenant=a or "base")
                for p, a in zip(prompts, adapters)]
        return [f.result(60) for f in futs]
    finally:
        b.close()


def jax_serve(server, prompts, adapters, max_new=6):
    async def go():
        b = JaxBatcher(server, max_slots=len(prompts), max_len=40, len_buckets=(8,),
                       layout="paged", page_size=8)
        outs = await asyncio.gather(*[b.submit(p, max_new_tokens=max_new, adapter=a,
                                               tenant=a or "base")
                                      for p, a in zip(prompts, adapters)])
        await b.close()
        return outs

    return asyncio.run(go())


def test_mixed_batch_greedy_equals_jax_and_solo(pair):
    j, p = pair
    before = (p._prefill_eager, p._decode_eager)
    mixed = serve(p, PROMPTS, ADAPTERS)
    assert p._prefill_eager > before[0] and p._decode_eager > before[1]
    assert p._prefill_replays == p._decode_replays == 0
    assert mixed == jax_serve(j, PROMPTS, ADAPTERS)
    for prompt, adapter, got in zip(PROMPTS, ADAPTERS, mixed):
        assert got == serve(p, [prompt], [adapter], slots=1)[0], adapter
    base = serve(p, PROMPTS[:3], [None] * 3)
    assert all(m != b for m, b in zip(mixed[:3], base))   # the adapters are real
    assert mixed[3] == p.generate([PROMPTS[3]], max_new_tokens=6)["tokens"][0]


def test_mixed_batch_seeded_equals_solo(sampled):
    mixed = serve(sampled, PROMPTS, ADAPTERS, seed=1234)
    for prompt, adapter, got in zip(PROMPTS, ADAPTERS, mixed):
        assert got == serve(sampled, [prompt], [adapter], seed=1234, slots=1)[0], adapter
    assert mixed[3] == sampled.generate([PROMPTS[3]], max_new_tokens=6,
                                        seed=1234)["tokens"][0]


def test_identity_through_adapted_programs_equals_unadapted_server(pair):
    j, p = pair
    plain = LLMServer(device="cpu", **dict(COMMON, lora_rank=0))
    plain.load(params=_jax_params(j))
    assert plain.adapter_registry is None
    assert serve(p, PROMPTS, [None] * 4) == serve(plain, PROMPTS, [None] * 4)
    with pytest.raises(SeldonError, match="no adapter pool") as e:
        ContinuousBatcher(plain, max_slots=1, device="cpu").submit([1], adapter=NAMES[0])
    assert e.value.status_code == 400


def test_adapted_ngram_spec_equals_plain_adapted_batcher(pair):
    _, p = pair
    prompts = [[7, 8, 9, 7, 8, 9, 7, 8], [4, 4, 4, 4, 4], [1, 2, 1, 2, 1, 2],
               [5, 6, 5, 6, 5, 6, 5]]
    spec = serve(p, prompts, ADAPTERS, max_new=8, spec_mode="ngram", spec_k=2)
    assert spec == serve(p, prompts, ADAPTERS, max_new=8)
    for prompt, adapter, got in zip(prompts, ADAPTERS, spec):
        assert got == serve(p, [prompt], [adapter], max_new=8, slots=1, spec_mode="ngram",
                            spec_k=2)[0]
    assert ("specstep", 4, 2, 40, "ngram", "paged", 5, True) in p._decode_cache


def test_adapted_requests_skip_the_trie(pair):
    j, _ = pair
    s = LLMServer(device="cpu", prefix_cache_size=4, **COMMON)
    s.load(params=_jax_params(j))
    load_adapters(s)
    prompt = [9, 9, 9, 9, 9, 9, 9, 9, 9, 3]
    b = ContinuousBatcher(s, max_slots=1, max_len=48, len_buckets=(16,), page_size=4,
                          device="cpu")
    try:
        adapted = b.submit(prompt, max_new_tokens=4, adapter=NAMES[0]).result(60)
        after_adapted = b._radix.stats()
        again = b.submit(prompt, max_new_tokens=4, adapter=NAMES[0]).result(60)
        base1 = b.submit(prompt, max_new_tokens=4).result(60)
        base2 = b.submit(prompt, max_new_tokens=4).result(60)
        st = b._radix.stats()
    finally:
        b.close()
    assert after_adapted["prefix_cached_blocks"] == 0 and after_adapted["prefix_hit_tokens"] == 0
    assert adapted == again != base1 == base2
    assert st["prefix_hit_tokens"] > 0 and st["prefix_cached_blocks"] > 0
    assert b.page_stats()["kv_pages_in_use"] == st["prefix_cached_blocks"]


def _gate(b):
    gate = threading.Event()
    admit = b._admit_pending

    def gated():
        gate.wait()
        admit()

    b._admit_pending = gated
    return gate


def test_eviction_blocked_while_queued_or_active(pair):
    _, p = pair
    reg = p.adapter_registry
    name = NAMES[1]
    b = ContinuousBatcher(p, max_slots=1, max_len=40, len_buckets=(8,), page_size=8,
                          device="cpu")
    gate = _gate(b)
    active_refs = []
    try:
        fut = b.submit(PROMPTS[0], max_new_tokens=6, adapter=name,
                       on_token=lambda t: active_refs.append(reg.refs_of(name)))
        assert reg.refs_of(name) == 1 and reg.evict(name) is False        # queued
        with pytest.raises(ValueError, match="pinned"):
            reg.load(name, {})
        gate.set()
        out = fut.result(60)
    finally:
        gate.set()
        b.close()
    assert len(out) == 6 and active_refs[:6] == [1] * 6                 # decoding
    assert reg.refs_of(name) == 0
    assert int(b._adapter_ids[0]) == 0                                  # released slot id
    assert reg.names() == NAMES


def test_sheds_release_the_pin(pair):
    """A staged (pre-commit) adapted prefill's shed drops the request's pin
    (the slot never took it); so does a quota shed at submit; an unknown
    adapter is 400 and pins nothing."""
    _, p = pair
    reg = p.adapter_registry
    name = NAMES[2]
    b = ContinuousBatcher(p, max_slots=1, max_len=48, len_buckets=(16,), page_size=4,
                          prefill_chunk=2, device="cpu")
    aid = reg.resolve_and_pin(name)
    req = PendingRequest(ids=list(range(1, 15)), max_new=4, fut=Future(), tenant="t",
                         slo_class="batch", adapter_id=aid)
    assert b._pending.push(req)
    b._admit_pending()
    assert b._prefill is not None and reg.refs_of(name) == 1
    assert int(b._chunk_adapter[0]) == aid
    b._shed_prefill_job("test: forced staged shed")
    with pytest.raises(ShedError):
        req.fut.result(1)
    assert reg.refs_of(name) == 0 and req.adapter_id == 0
    ctrs = {(r["tenant"], r["slo_class"]): r for r in b._pending.counters()}
    assert ctrs[("t", "batch")]["shed"] == 1
    b._pending._tenant_quotas["q"] = 1
    b._pending.push(PendingRequest(ids=[1], max_new=1, fut=None, tenant="q"))
    with pytest.raises(ShedError, match="quota"):
        b.submit([5, 9], adapter=name, tenant="q")
    assert reg.refs_of(name) == 0
    with pytest.raises(SeldonError, match="unknown adapter") as e:
        b.submit([5, 9], adapter="ghost")
    assert e.value.status_code == 400
    with pytest.raises(SeldonError, match="unknown SLO class"):
        b.submit([5, 9], slo_class="gold")
    b._pending.drain_all()
    b.close()
