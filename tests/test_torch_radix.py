"""The radix prefix cache in the port (``seldon_core_tpu_torch/runtime/radix.py``,
the batcher's admission / insertion / eviction / CoW copy, ``LLMServer``'s
``prefix_match_len`` and ``clear_prefix_cache``) held against the JAX package on
the CPU, at ``tests/test_radix.py``'s sizes (vocab 96, dim 32, 2 layers, pages
of 4, prefill chunks of 8) in float32, so that tokens compare exactly:

- the call sequences of the JAX package's pure trie tests run on both
  ``RadixPrefixCache`` copies (each over its own ``PageAllocator``) give equal
  returns, stats and refcounts at every step;
- three greedy chat turns (``TURNS``: each prompt the last one plus its answer
  plus the user's tokens) through the port's radix batcher give the JAX
  ``generate()`` cold tokens and the JAX radix batcher's tokens, with equal
  per-turn trie stats; float and int8 KV, and a seeded run (the port's own
  sampling chain: equal to the port's cold ``generate(seed=)`` and its
  trie-off batcher, with the JAX seeded run's hit counters);
- the pools a hit lands in equal JAX's within 1e-5 (int8 codes within one
  step) on every page but TRASH; ``cow_page_copy`` equals JAX's on both pool
  layouts and leaves PAD_POS past ``n_valid``;
- the CoW pin never starves an idle minimum pool, and eviction relieves pool
  pressure without a shed, with JAX's outcome;
- ``spec_mode="ngram"`` with the cache on equals the JAX spec batcher;
- ``page_stats`` (fragmentation included) at each turn's first token equals
  JAX's; ``clear_prefix_cache`` clears the batcher's trie; ``prefix_match_len``
  equals JAX's on the trie and on the dense entries."""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.runtime.batcher import PageAllocator as JaxAllocator
from seldon_core_tpu.runtime.batcher import _page_table_ops
from seldon_core_tpu.runtime.radix import RadixPrefixCache as JaxTrie
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import PAD_POS, TRASH_PAGE
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, PageAllocator, cow_page_copy
from seldon_core_tpu_torch.runtime.radix import RadixPrefixCache
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3, prefix_cache_size=8)
BKW = dict(page_size=4, max_len=64, len_buckets=(16, 32), prefill_chunk=8, max_slots=2)
TURNS = ([9, 8, 7, 6, 5, 4, 3, 2, 1, 11, 12], [30, 31, 32], [44, 45])
SEEDS = [42, 1234, 7]
KNOBS = {"float": {}, "int8": dict(kv_cache_dtype="int8"),
         "sampled": dict(temperature=0.8, top_k=20, seed=5)}
TIMEOUT = 120


def _pair(**extra):
    j = JaxLLMServer(init_random=True, **dict(COMMON, **extra))
    j.load()
    p = LLMServer(device="cpu", **dict(COMMON, **extra))
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    return j, p


@pytest.fixture(scope="module")
def pairs():
    """knob name -> (the JAX server, the port server on its weights), each
    loaded at first use."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _pair(**KNOBS[name])
        return made[name]

    return get


def _prompts(outs):
    """The chat's prompts: each the last one, its answer and the user's turn."""
    prompts = [list(TURNS[0])]
    for out, user in zip(outs, TURNS[1:]):
        prompts.append(prompts[-1] + out + list(user))
    return prompts


def port_chat(server, seeds=None, **kw):
    """The chat through one port batcher. Returns (outputs, per-turn trie
    stats, the page stats at each turn's first token, the batcher)."""
    b = ContinuousBatcher(server, device="cpu", **dict(BKW, **kw))
    outs, snaps, firsts = [], [], []
    try:
        for i in range(len(TURNS)):
            prompt = _prompts(outs)[i]

            def first(tok, b=b):
                if tok is not None and len(firsts) == len(outs):
                    firsts.append(b.page_stats())

            fut = b.submit(prompt, 6, seed=None if seeds is None else seeds[i], on_token=first)
            outs.append(fut.result(TIMEOUT))
            snaps.append(dict(b._radix.stats()) if b._radix is not None else {})
    finally:
        b.close()
    return outs, snaps, firsts, b


def jax_chat(server, seeds=None, **kw):
    async def go():
        b = JaxBatcher(server, layout="paged", **dict(BKW, **kw))
        outs, snaps, firsts = [], [], []
        for i in range(len(TURNS)):
            prompt = _prompts(outs)[i]

            def first(tok, b=b):
                if tok is not None and len(firsts) == len(outs):
                    firsts.append(b.page_stats())

            outs.append(await b.submit(prompt, max_new_tokens=6, on_token=first,
                                       seed=None if seeds is None else seeds[i]))
            snaps.append(dict(b._radix.stats()))
        await b.close()
        return outs, snaps, firsts, b

    return asyncio.run(go())


# ------------------------------------------------------- trie call sequences
def seq_insert_match_dedup(PA, RC):
    alloc = PA(total_pages=32, page_size=4)
    trie = RC(alloc, page_size=4, bytes_per_block=100)
    seq = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    pages = alloc.alloc(3)
    log = [sorted(trie.insert(seq, pages, 0)), trie.stats(), alloc.refs_map(pages)]
    k0, shared, cow = trie.match_and_pin(seq, limit=len(seq) - 1)
    log += [(k0, shared, cow), alloc.refs_map(pages), trie.stats()]
    alloc.free([cow[0]])
    alloc.free(shared)
    log.append(alloc.refs_map(pages))
    dup = alloc.alloc(3)
    log += [sorted(trie.insert(seq, dup, 0)), trie.stats(), alloc.refs_map(dup)]
    return log


def seq_failed_admission_retry(PA, RC):
    alloc = PA(total_pages=32, page_size=4)
    trie = RC(alloc, page_size=4, bytes_per_block=100)
    pages = alloc.alloc(2)
    trie.insert([1, 2, 3, 4, 5, 6, 7, 8], pages, 0)
    log = []
    for _ in range(5):
        got = trie.match_and_pin([1, 2, 3, 4, 5, 6, 7, 8, 9], limit=8)
        log.append(got)
        alloc.free(got[1] + ([got[2][0]] if got[2] is not None else []))
    log.append(trie.stats())
    trie.record_hit(8, 2, False)
    log.append(trie.stats())
    return log


def seq_partial_tail_upgrade(PA, RC):
    alloc = PA(total_pages=32, page_size=4)
    trie = RC(alloc, page_size=4)
    short = alloc.alloc(1)
    log = [sorted(trie.insert([5, 6], short, 0)), trie.match_len([5, 6, 7])]
    longer = alloc.alloc(1)
    log += [sorted(trie.insert([5, 6, 7], longer, 0)), alloc.refs_of(short[0]),
            trie.match_len([5, 6, 7, 8])]
    shorter = alloc.alloc(1)
    log += [sorted(trie.insert([5, 6], shorter, 0)), alloc.refs_of(shorter[0]), trie.stats()]
    return log


def seq_eviction_lru_pinned(PA, RC):
    alloc = PA(total_pages=8, page_size=4)
    trie = RC(alloc, page_size=4)
    a = alloc.alloc(2)
    trie.insert([1] * 8, a, 0)
    b = alloc.alloc(2)
    trie.insert([2] * 8, b, 0)
    _, pa, cow_a = trie.match_and_pin([1] * 8, limit=7)
    alloc.free(pa + [cow_a[0]])
    pinned = trie.match_and_pin([2] * 8, limit=8)
    log = [pinned, trie.evict(7), alloc.refs_map(a + b), trie.evict(4), alloc.refs_map(a + b),
           trie.stats(), alloc.free_count()]
    return log


def seq_hot_prefix(PA, RC):
    """test_hot_prefix_shared_by_8_threads' cycle, on one thread."""
    alloc = PA(total_pages=64, page_size=4)
    trie = RC(alloc, page_size=4, bytes_per_block=64)
    hot = list(range(1, 17))
    base = alloc.alloc(4)
    trie.insert(hot, base, 0)
    log = []
    for _ in range(8):
        k0, shared, cow = trie.match_and_pin(hot, limit=len(hot) - 1)
        log.append((k0, shared, cow, alloc.refs_map(base)))
        trie.record_hit(k0, len(shared), cow is not None)
        log.append(trie.match_len(hot))
        alloc.free(shared + ([cow[0]] if cow is not None else []))
    log += [alloc.refs_map(base), trie.stats()]
    return log


SEQUENCES = [seq_insert_match_dedup, seq_failed_admission_retry, seq_partial_tail_upgrade,
             seq_eviction_lru_pinned, seq_hot_prefix]


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__[4:])
def test_trie_call_sequence_equals_jax(seq):
    got = seq(PageAllocator, RadixPrefixCache)
    assert got == seq(JaxAllocator, JaxTrie)
    assert got  # the sequence ran


def test_hot_prefix_shared_by_8_threads():
    """The port's trie under contention (the JAX package's hot-prefix test,
    with a shortened switch interval): 8 threads pin, tally and release one
    hot prefix 200 times each while the stats walk runs; every pin comes
    back (refcounts exactly the trie's own), the counters are exact, and no
    page is double-freed (the allocator raises if one is)."""
    import sys
    import threading

    alloc = PageAllocator(total_pages=64, page_size=4)
    trie = RadixPrefixCache(alloc, page_size=4, bytes_per_block=64)
    hot = list(range(1, 17))
    base = alloc.alloc(4)
    trie.insert(hot, base, 0)
    n, errs = 200, []
    barrier = threading.Barrier(8)

    def worker():
        try:
            barrier.wait(10)
            for _ in range(n):
                k0, shared, cow = trie.match_and_pin(hot, limit=len(hot) - 1)
                assert (k0, shared, cow) == (15, base[:3], (base[3], 3))
                trie.record_hit(k0, len(shared), True)
                trie.stats()
                alloc.free(shared + [cow[0]])
        except BaseException as e:  # surfaced below
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errs and not any(t.is_alive() for t in threads)
    assert alloc.refs_map(base) == [1, 1, 1, 1]
    st = trie.stats()
    assert (st["prefix_hit_blocks"], st["prefix_cow_copies"], st["prefix_shared_pages"]) == \
        (8 * n * 4, 8 * n, 0)


def test_trie_stats_and_match_work_equal_jax():
    """The lookup's visit counter too (the walk's cost): O(prompt blocks),
    equal on both copies over a trie of 40 prompts."""
    tries = []
    for PA, RC in ((PageAllocator, RadixPrefixCache), (JaxAllocator, JaxTrie)):
        alloc = PA(total_pages=256, page_size=4)
        trie = RC(alloc, page_size=4, bytes_per_block=7)
        rng = np.random.default_rng(0)
        for _ in range(40):
            ids = rng.integers(0, 6, size=int(rng.integers(3, 23))).tolist()
            pages = alloc.alloc(-(-len(ids) // 4))
            consumed = trie.insert(ids, pages, 0)
            alloc.free([p for p in pages if p not in consumed])
        probes = [rng.integers(0, 6, size=20).tolist() for _ in range(10)]
        tries.append(([trie.match_len(p) for p in probes], trie.match_work_total,
                      trie.stats(), alloc.stats()))
    assert tries[0] == tries[1]


# ------------------------------------------------------------- chat parity
@pytest.mark.parametrize("name", list(KNOBS))
def test_chat_parity_equals_jax(pairs, name):
    """Greedy (float and int8 KV): the port's radix batcher == JAX cold
    generate() == the JAX radix batcher, token for token, with equal trie
    stats after each turn and equal page stats at each turn's first token.
    Seeded (the port's own chain): == the port's cold generate(seed=) and
    its trie-off batcher, with the JAX seeded run's trie stats."""
    j, p = pairs(name)
    seeds = SEEDS if name == "sampled" else None
    outs, snaps, firsts, _ = port_chat(p, seeds=seeds)
    jouts, jsnaps, jfirsts, _ = jax_chat(j, seeds=seeds)
    assert snaps == jsnaps
    assert [f["kv_pages_in_use"] for f in firsts] == [f["kv_pages_in_use"] for f in jfirsts]
    assert firsts == jfirsts
    assert snaps[0]["prefix_hit_tokens"] == 0
    assert 8 <= snaps[1]["prefix_hit_tokens"] < snaps[2]["prefix_hit_tokens"]
    assert snaps[2]["prefix_cow_copies"] >= 1 and snaps[2]["prefix_bytes_saved"] > 0
    if seeds is None:
        assert outs == jouts
        cold = [j.generate([pr], max_new_tokens=6)["tokens"][0] for pr in _prompts(outs)]
        assert outs == cold
    else:
        cold = [p.generate([pr], max_new_tokens=6, seed=sd)["tokens"][0]
                for pr, sd in zip(_prompts(outs), seeds)]
        assert outs == cold
        p.prefix_cache_size = 0
        try:
            plain, _, _, b = port_chat(p, seeds=seeds)
        finally:
            p.prefix_cache_size = COMMON["prefix_cache_size"]
        assert b._radix is None and plain == outs


@pytest.mark.parametrize("name", ["float", "int8"])
def test_hit_pools_equal_jax(pairs, name):
    """After the chat (turn 3 a hit with a CoW copy), every pool page but
    TRASH equals JAX's: positions exactly, float K/V within 1e-5, int8
    codes within one step and scales within 1e-5."""
    j, p = pairs(name)
    *_, b = port_chat(p)
    *_, jb = jax_chat(j)
    keep = [i for i in range(b.pool_pages) if i != TRASH_PAGE]
    assert b._radix.cow_copies_total == 1
    for layer, jlayer in zip(b._caches, jb._caches):
        assert len(layer) == len(jlayer)
        for t, jt in zip(layer, jlayer):
            got, want = t.numpy()[keep], np.asarray(jt)[keep]
            if t.dtype == torch.int32:
                assert np.array_equal(got, want)
            elif t.dtype == torch.int8:
                assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_cow_page_copy_equals_jax(kv):
    """``cow_page_copy`` (the batcher's eager program, what the CoW graph
    captures) against JAX's on the same random pools: every leaf equal,
    the destination's position row PAD_POS from ``n_valid`` on, and no
    other page touched."""
    rng = np.random.default_rng(5)
    n_pages, ps, kvh, hd = 6, 4, 2, 8
    layers = []
    for _ in range(2):
        pos = rng.integers(0, 50, size=(n_pages, ps)).astype(np.int32)
        if kv == "int8":
            q = lambda: rng.integers(-127, 128, size=(n_pages, ps, kvh, hd)).astype(np.int8)
            s = lambda: rng.uniform(0.1, 2, size=(n_pages, ps, kvh)).astype(np.float32)
            layers.append((q(), s(), q(), s(), pos))
        else:
            f = lambda: rng.standard_normal((n_pages, ps, kvh, hd)).astype(np.float32)
            layers.append((f(), f(), pos))
    src, dst, n_valid = 3, 5, 3
    want = _page_table_ops()[5]([tuple(jnp.asarray(a) for a in layer) for layer in layers],
                                jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                                jnp.asarray(n_valid, jnp.int32))
    pools = [tuple(torch.from_numpy(a.copy()) for a in layer) for layer in layers]
    arg = lambda v: torch.tensor([v], dtype=torch.int64)
    cow_page_copy(pools, arg(src), arg(dst), arg(n_valid))
    for layer, jlayer, before in zip(pools, want, layers):
        for t, jt, b0 in zip(layer, jlayer, before):
            assert np.array_equal(t.numpy(), np.asarray(jt))
            others = [i for i in range(n_pages) if i != dst]
            assert np.array_equal(t.numpy()[others], b0[others])
        pos = layer[-1].numpy()
        assert list(pos[dst, :n_valid]) == list(before[-1][src, :n_valid])
        assert (pos[dst, n_valid:] == PAD_POS).all()


# ------------------------------------------------------ admission edges
def test_cow_pin_never_starves_an_idle_minimum_pool(pairs):
    """A pool of exactly one max_len sequence: the second prompt matches two
    full blocks and part-way into the cached tail, its fresh pages exceed
    the free list, and the pinned CoW source blocks eviction: the
    admission drops the partial match, keeps the full blocks, and is never
    shed; same outcome as JAX."""
    j, p = pairs("float")
    kw = dict(max_slots=2, max_len=16, len_buckets=(16,), page_size=4, pool_pages=6,
              prefill_chunk=4)
    prompt2 = [1, 2, 3, 4, 5, 6, 7, 8] + list(range(20, 27))

    async def jax_run():
        b = JaxBatcher(j, layout="paged", **kw)
        o1 = await b.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=3)
        st1 = dict(b._radix.stats())
        o2 = await b.submit(prompt2, max_new_tokens=1)
        out = (o1, o2, st1, dict(b._radix.stats()), b.page_stats())
        await b.close()
        return out

    b = ContinuousBatcher(p, device="cpu", **kw)
    try:
        o1 = b.submit([1, 2, 3, 4, 5, 6, 7, 8], 3).result(TIMEOUT)
        st1 = dict(b._radix.stats())
        o2 = b.submit(prompt2, 1).result(TIMEOUT)
        got = (o1, o2, st1, dict(b._radix.stats()), b.page_stats())
    finally:
        b.close()
    assert got == asyncio.run(jax_run())
    assert got[4]["kv_page_sheds"] == 0 and got[2]["prefix_cached_blocks"] == 3
    assert got[3]["prefix_hit_blocks"] - got[2]["prefix_hit_blocks"] == 2
    assert got[3]["prefix_cow_copies"] == 0
    assert o2 == j.generate([prompt2], max_new_tokens=1)["tokens"][0]


def test_eviction_relieves_pool_pressure(pairs):
    """A full trie is a cache, not a tenant: a third distinct prompt that
    the free list cannot cover evicts LRU leaves instead of shedding; same
    tokens, trie stats and page stats as JAX."""
    j, p = pairs("float")
    kw = dict(max_slots=2, max_len=32, len_buckets=(16,), page_size=4, pool_pages=12,
              prefill_chunk=8)
    prompts = [([10, 11, 12, 13], 6), ([20, 21, 22, 23], 6), ([30] * 16, 8)]

    async def jax_run():
        b = JaxBatcher(j, layout="paged", **kw)
        outs = [await b.submit(pr, max_new_tokens=n) for pr, n in prompts]
        out = (outs, dict(b._radix.stats()), b.page_stats())
        await b.close()
        return out

    b = ContinuousBatcher(p, device="cpu", **kw)
    try:
        outs = [b.submit(pr, n).result(TIMEOUT) for pr, n in prompts]
        got = (outs, dict(b._radix.stats()), b.page_stats())
    finally:
        b.close()
    assert got == asyncio.run(jax_run())
    assert len(outs[2]) == 8 and got[1]["prefix_evicted_blocks"] > 0
    assert got[2]["kv_page_sheds"] == 0


# ------------------------------------------------------------ speculation
def test_spec_ngram_with_prefix_cache_equals_jax():
    """n-gram speculation over radix-served slots: tokens, trie stats and
    acceptance equal to the JAX spec batcher with the cache on (its slots
    insert through the same completion path)."""
    j, p = _pair(spec_mode="ngram", spec_k=4)
    outs, snaps, _, b = port_chat(p, max_len=48, page_size=8, len_buckets=(16,))
    jouts, jsnaps, _, jb = jax_chat(j, max_len=48, page_size=8, len_buckets=(16,))
    assert outs == jouts and snaps == jsnaps
    assert snaps[2]["prefix_hit_tokens"] > 0
    spec, jspec = b.spec_stats(), jb.spec_stats()
    assert spec["spec_slot_steps_total"] == jspec["spec_slot_steps_total"] > 0
    assert spec["spec_accept_rate"] == pytest.approx(jspec["spec_accept_rate"])


# ------------------------------------------------------------- accounting
def test_clear_and_prefix_match_len_equal_jax(pairs):
    """With a batcher behind the server: ``prefix_match_len`` reads its
    trie (equal to JAX's on every turn's prompt, a longer one and a cold
    one), and ``clear_prefix_cache`` clears it (every page back). Without
    one it reads the dense entries, equal to JAX's."""
    j, p = pairs("float")
    outs, _, _, b = port_chat(p)
    *_, jb = jax_chat(j)
    p._batcher_service, j._batcher_service = SimpleNamespace(batcher=b), \
        SimpleNamespace(batcher=jb)
    try:
        probes = _prompts(outs) + [_prompts(outs)[-1] + outs[-1], [50, 51, 52]]
        got = [p.prefix_match_len(pr) for pr in probes]
        assert got == [j.prefix_match_len(pr) for pr in probes]
        assert got[-1] == 0 and got[-2] > got[0] > 0
        assert b.page_stats()["kv_pages_in_use"] == b._radix.stats()["prefix_cached_blocks"] > 0
        p.clear_prefix_cache()
        j.clear_prefix_cache()
        assert b._radix.stats() == jb._radix.stats()
        assert b._radix.stats()["prefix_cached_blocks"] == 0
        assert b.page_stats()["kv_pages_in_use"] == 0
        assert p.prefix_match_len(probes[1]) == 0
    finally:
        del p._batcher_service, j._batcher_service
    # the dense layer: generate()'s entries
    prompt = list(TURNS[0])
    p.generate([prompt], max_new_tokens=2)
    j.generate([prompt], max_new_tokens=2)
    probes = [prompt, prompt + [3, 4], prompt[:5], [50]]
    assert [p.prefix_match_len(pr) for pr in probes] == \
        [j.prefix_match_len(pr) for pr in probes] == [11, 11, 0, 0]
    p.clear_prefix_cache()
    j.clear_prefix_cache()
