"""``generate()``'s dense prefix cache in the port (``LLMServer._prefix_lookup``,
``_prefix_store``, ``_get_extend``, ``clear_prefix_cache``, the
``_PrefixTrieIndex``) held against the JAX server on the CPU, float32 weights
at a small width, the model-dtype KV cache and the int8 one:

- a one-prompt call stores an entry under the prompt with the JAX package's
  cache length (``max_len``); a lookup of the prompt, and of a longer one,
  hits it; the stored caches equal JAX's within 1e-5 at every held
  position (positions exactly, int8 codes within one step), the stored
  first-token logits too;
- eviction by count and by bytes keeps the entries and byte total JAX keeps;
  an entry over the byte budget alone is not stored (warned once);
- no entry is served across KV dtypes;
- a lookup's work (index nodes visited) is independent of the entry count
  and equal to JAX's;
- multi-turn ``generate()`` (each turn the last prompt, its answer and new
  tokens: a partial hit through ``_get_extend``; a repeated prompt: an exact
  hit, no prefill) gives JAX's tokens and ``tags()``, float and int8 KV;
- the port's own trap: ``generate()`` decodes in place into one reused
  dense buffer, so an entry must be a copy. After an exact hit and a partial
  hit decode through that buffer, every stored entry is bit-equal to what
  was stored, while the buffer itself was written past the prompt."""

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import PAD_POS
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=256, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=128, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=6, len_buckets=(16, 32),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=7, prefix_cache_size=4)
KV = {"float": {}, "int8": dict(kv_cache_dtype="int8")}
PROMPT = [5, 9, 17, 33, 2, 7, 40, 3]


def pair(kv, **extra):
    """(JAX server, port server on its weights) with the ``kv`` cache and
    ``extra`` knobs."""
    j = JaxLLMServer(init_random=True, **dict(COMMON, **KV[kv], **extra))
    j.load()
    return j, port_twin(j, kv, **extra)


def port_twin(j, kv, **extra):
    """A port server on the JAX server ``j``'s weights."""
    p = LLMServer(device="cpu", **dict(COMMON, **KV[kv], **extra))
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    return p


def budget(server, size: int, nbytes: int) -> None:
    """Re-budget a server's dense cache and empty it (its programs stay)."""
    server.clear_prefix_cache()
    server.prefix_cache_size, server.prefix_cache_bytes = size, nbytes
    server._prefix_overbudget_warned = False


def _entries(server):
    return {k: v for k, v in server._prefix_cache.items()}


def _same_caches(port_caches, jax_caches):
    """Positions exactly; values where a position is held (the prefill's
    padding columns, at PAD_POS, hold the rotary of a huge angle, which
    the two libraries round differently, and are never attended)."""
    for layer, jlayer in zip(port_caches, jax_caches):
        assert len(layer) == len(jlayer)
        held = layer[-1].numpy() != PAD_POS
        assert np.array_equal(layer[-1].numpy(), np.asarray(jlayer[-1]))
        for t, jt in zip(layer[:-1], jlayer[:-1]):
            got, want = t.numpy()[held], np.asarray(jt)[held]
            if t.dtype == torch.int8:
                assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", list(KV))
def test_store_lookup_roundtrip_equals_jax(kv):
    j, p = pair(kv)
    for s in (p, j):
        s.generate([PROMPT], max_new_tokens=1)
    (key, entry), = _entries(p).items()
    (jkey, jentry), = _entries(j).items()
    assert key == jkey == tuple(PROMPT)
    # max_len: the top length bucket + max(max_new, the server's), as JAX
    assert entry[0] == jentry[0] == 32 + 6
    assert entry[1] == jentry[1]
    _same_caches(entry[2], jentry[2])
    np.testing.assert_allclose(entry[3].numpy(), np.asarray(jentry[3]), rtol=1e-5, atol=1e-5)
    assert entry[4] == jentry[4] == p._prefix_bytes == j._prefix_bytes
    for probe in (PROMPT, PROMPT + [1, 2]):
        hit, jhit = p._prefix_lookup(probe, entry[0]), j._prefix_lookup(probe, entry[0])
        assert hit[:2] == jhit[:2] == (len(PROMPT), entry[0])
    assert p._prefix_lookup(PROMPT, entry[0] + 1) is None
    assert p._prefix_hits == j._prefix_hits == 2
    assert len(entry[2][0]) == (5 if kv == "int8" else 3)


@pytest.mark.parametrize("kv", list(KV))
def test_eviction_by_count_and_bytes_equals_jax(kv):
    """By count (2 entries kept of 4 prompts); by bytes (a budget of one
    entry keeps the newest); over budget alone (nothing stored, warned
    once): the same entries and byte totals as JAX."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 255, size=int(n)).tolist() for n in (6, 9, 12, 20)]
    j, p = pair(kv, prefix_cache_size=2)
    for s in (p, j):
        for pr in prompts:
            s.generate([pr], max_new_tokens=1)
    assert list(_entries(p)) == list(_entries(j)) == [tuple(pr) for pr in prompts[2:]]
    one = p._prefix_bytes // 2
    assert p._prefix_bytes == j._prefix_bytes == sum(
        p._entry_nbytes(e[2], e[3]) for e in p._prefix_cache.values())
    for nbytes, kept in ((one + 1, True), (one - 1, False)):
        for s in (p, j):
            budget(s, 8, nbytes)
            for pr in prompts[:3] + prompts[1:2]:
                s.generate([pr], max_new_tokens=1)
        # prompts of 6, 9, 12 tokens: one cache length, one entry size
        assert list(_entries(p)) == list(_entries(j)) == [tuple(pr) for pr in
                                                          ([prompts[1]] if kept else [])]
        assert p._prefix_bytes == j._prefix_bytes
        assert p._prefix_overbudget_warned == (not kept)
    p.clear_prefix_cache()
    assert (p._prefix_bytes, len(p._prefix_cache), p.prefix_match_len(prompts[1])) == (0, 0, 0)


def test_default_byte_budget_equals_jax():
    for extra in (dict(prefix_cache_size=3), dict(prefix_cache_size=3, prefix_cache_bytes=99),
                  dict()):
        p = LLMServer(device="cpu", **dict(COMMON, **extra))
        j = JaxLLMServer(init_random=True, **dict(COMMON, **extra))
        assert (p.prefix_cache_size, p.prefix_cache_bytes) == \
            (j.prefix_cache_size, j.prefix_cache_bytes)


def test_no_entry_served_across_kv_dtypes():
    for kv, other in (("float", "int8"), ("int8", "bf16")):
        j, p = pair(kv)
        for s in (p, j):
            s.generate([PROMPT], max_new_tokens=1)
            max_len = next(iter(s._prefix_cache.values()))[0]
            assert s._prefix_lookup(PROMPT, max_len) is not None
            s.kv_cache_dtype = other
            assert s._prefix_lookup(PROMPT, max_len) is None


def test_lookup_work_independent_of_entry_count():
    """Synthetic entries (the lookup reads keys and metadata only): the
    work of a missing probe does not grow from 4 entries to 132, a real
    hit costs at most one node a probe token, equal to JAX's."""
    works = []
    for s in pair("float", prefix_cache_size=256, prefix_cache_bytes=1 << 40):
        probe = [200 + i for i in range(12)]
        got = []
        for n in (4, 128):
            for i in range(n):
                s._prefix_store([i, 1, 2, 3, 4, 5, 6, 7], 64, [], None)
            s._prefix_index.work = 0
            assert s._prefix_lookup(probe, 64) is None
            got.append(s._prefix_index.work)
        s._prefix_index.work = 0
        hit = s._prefix_lookup([3, 1, 2, 3, 4, 5, 6, 7, 9, 9], 64)
        assert hit is not None and hit[0] == 8
        got.append(s._prefix_index.work)
        works.append(got)
    assert works[0] == works[1]
    assert works[0][0] == works[0][1] and works[0][2] <= 11


@pytest.mark.parametrize("kv", list(KV))
def test_multi_turn_generate_equals_jax(kv):
    """Turn 2 and 3 extend the last prompt with its answer (partial hits
    through ``_get_extend``), turn 4 repeats turn 3 (an exact hit: the
    stored logits, no prefill): tokens equal JAX's, and equal a
    cache-cleared server's; ``tags()`` equal JAX's."""
    j, p = pair(kv)
    cold = port_twin(j, kv, prefix_cache_size=0)
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, 255, size=12).tolist()
    prompts, outs = [], []
    for turn in range(4):
        if 0 < turn < 3:
            prompt = prompt + outs[-1] + rng.integers(1, 255, size=3).tolist()
        prompts.append(prompt)
        outs.append(p.generate([prompt])["tokens"][0])
        assert outs[-1] == j.generate([prompt])["tokens"][0]
        assert outs[-1] == cold.generate([prompt])["tokens"][0]
    assert p.tags() == j.tags() == {"llm_requests": 4, "prefix_cache_hits": 3,
                                    "prefix_cache_entries": 3}
    assert ("extend", 1, 16, 38) in p._prefill_cache
    assert list(_entries(p)) == list(_entries(j))


@pytest.mark.parametrize("kv", list(KV))
def test_stored_entry_unchanged_by_decode(kv):
    """The trap: an exact hit and a partial hit each decode into the dense
    buffer the entry was copied from, and every entry stays bit-equal to
    what was stored; the buffer holds the decode's positions past the
    prompt, the entry PAD_POS there."""
    _, p = pair(kv)
    out = p.generate([PROMPT], max_new_tokens=6)["tokens"][0]
    (key, entry), = _entries(p).items()
    snap = [tuple(t.clone() for t in layer) for layer in entry[2]], entry[3].clone()
    assert p.generate([PROMPT], max_new_tokens=6)["tokens"][0] == out   # exact hit
    longer = PROMPT + out + [4, 4]
    p.generate([longer], max_new_tokens=6)                            # partial hit
    assert p._prefix_hits == 2 and len(p._prefix_cache) == 2
    stored = p._prefix_cache[key]
    for layer, before in zip(stored[2], snap[0]):
        for t, b in zip(layer, before):
            assert torch.equal(t, b)
    assert torch.equal(stored[3], snap[1])
    L, max_len = len(PROMPT), entry[0]
    assert (stored[2][0][-1][0, L:] == PAD_POS).all()
    dense_pos = p._dense.caches(1, max_len)[0][-1][0]
    assert dense_pos[len(longer)].item() == len(longer)   # the decode wrote the buffer
    # the extended entry holds the longer prompt's positions, PAD_POS after
    ext = p._prefix_cache[tuple(longer)][2][0][-1][0]
    assert ext[:len(longer)].tolist() == list(range(len(longer)))
    assert (ext[len(longer):] == PAD_POS).all()
