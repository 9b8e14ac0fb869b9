"""The port's dense ``generate()`` path (servers/llmserver.py): the JAX
package's program keys, ``_get_prefill(b, plen, max_len)`` and
``_get_decode(b, max_len)``, run over the server's one dense buffer, which
every call reuses (its caches the contiguous prefix of each flat cache
tensor, reset by the prefill program) and which grows on demand. On the
CPU every program runs eagerly; on the card the decode step is a CUDA
graph replay (tests/test_torch_kernels_cuda.py).

Held on the CPU at a small width (float32 model, the model-dtype KV cache
and the int8 KV cache):

- greedy tokens EQUAL the JAX ``LLMServer.generate()`` at several (batch
  bucket, plen, max_new) keys, dummy rows and a split batch included;
- a call after a larger one, on a buffer poisoned with NaN (int8 values
  random, positions 0), gives tokens equal to a fresh server's, and the
  prefill program gives logits and caches bit-equal to fresh
  ``init_kv_caches``; nothing past the call's prefix is written;
- a growth drops the captured graphs and changes no token;
- ``sample_tokens`` with a 0-dim tensor temperature is bit-equal to the
  float form and to the draw the port made before the temperature became
  a tensor, greedy and sampled;
- threads calling ``generate()`` with different keys at once each get
  their solo tokens."""

import threading

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import PAD_POS
from seldon_core_tpu_torch.servers.llmserver import (_GOLDEN, _M32, LLMServer, _mix32,
                                                     sample_tokens, seed_key, split_keys)

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32", tie_embeddings=True)
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, eos_id=-1, seed=3,
              len_buckets=(16, 32), batch_buckets=(1, 4, 8))
KV = {"model-dtype": {}, "int8": dict(kv_cache_dtype="int8")}


def _prompts(n: int, seed: int = 0):
    """``n`` prompts of 3 to 14 tokens (one bucket of 16), made from a seed;
    every third a token list, the rest byte strings."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(1, 256, size=int(rng.integers(3, 15))).tolist()
        out.append(toks if i % 3 == 0 else bytes(t % 95 + 32 for t in toks).decode())
    return out


PROMPTS = _prompts(10)
LONG = [5, 9, 17, 2, 40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13, 1, 2]   # 18: bucket 32
# (prompts, max_new): batch buckets 1, 4 (one prompt of 18: plen 32), 8
# (5 prompts, 3 dummy rows) and 10 prompts split into 8 + 2 (bucket 4)
CASES = [(PROMPTS[:1], 5), ([PROMPTS[1], LONG, PROMPTS[2]], 8), (PROMPTS[:5], 6),
         (PROMPTS, 4)]


@pytest.fixture(scope="module", params=list(KV))
def pair(request):
    """(KV name, the JAX server, the port server on its weights, the
    weights as numpy)."""
    js = JaxLLMServer(init_random=True, temperature=0.0, **COMMON, **KV[request.param])
    js.load()
    tree = {"params": jax.tree_util.tree_map(np.asarray, js._params["params"])}
    return request.param, js, port_server(tree, request.param), tree


def port_server(tree, kv: str, **extra) -> LLMServer:
    s = LLMServer(device="cpu", temperature=0.0, **dict(COMMON, **KV[kv], **extra))
    s.load(params=tree)
    return s


@pytest.mark.parametrize("case", range(len(CASES)), ids=["b1", "b4-plen32", "b8-dummy",
                                                         "split-8+2"])
def test_greedy_generate_equals_jax(pair, case):
    """The same server across the cases: each key reuses (or grows) the
    one dense buffer."""
    _, js, server, _ = pair
    prompts, max_new = CASES[case]
    got = server.generate(prompts, max_new_tokens=max_new)
    want = js.generate(prompts, max_new_tokens=max_new)
    assert got["tokens"] == want["tokens"]
    assert got["texts"] == want["texts"]
    assert all(len(t) == max_new for t in got["tokens"])


def test_program_keys_counters_and_step_walls(pair):
    """The programs are cached under the JAX package's keys; each call
    with max_new > 1 appends one per-step wall to ``_decode_step_times``
    (a split batch one per part) and counts its decode steps as eager
    runs on the CPU."""
    kv, _, _, tree = pair
    s = port_server(tree, kv)
    s.generate([PROMPTS[1], LONG, PROMPTS[2]], max_new_tokens=8)
    assert ("prefill", 4, 32, 40) in s._prefill_cache
    assert ("decode", 4, 40) in s._decode_cache
    assert s._get_prefill(4, 32, 40) is s._get_prefill(4, 32, 40)
    assert s._get_decode(4, 40) is s._get_decode(4, 40)
    assert len(s._decode_step_times) == 1 and s._decode_step_times[0] > 0
    assert (s._generate_eager, s._generate_replays) == (7, 0)
    s.generate(PROMPTS, max_new_tokens=3)          # 8 + 2 rows: two calls
    assert {("decode", 8, 19), ("decode", 4, 19)} <= set(s._decode_cache)
    assert len(s._decode_step_times) == 3 and s._generate_eager == 7 + 2 + 2
    s.generate(PROMPTS[:1], max_new_tokens=1)      # the prefill's token only
    assert len(s._decode_step_times) == 3 and s._generate_eager == 11
    assert ("decode", 1, 17) not in s._decode_cache
    wrong = torch.zeros((4, 32), dtype=torch.int64)
    with pytest.raises(ValueError, match="dense prefill"):
        s._get_prefill(4, 16, 40)(s._dense.caches(4, 40), wrong, wrong)


def _poison(dense) -> None:
    """Every entry of the dense buffer made unusable: float tensors NaN,
    int8 values random, positions 0 (attended, were they not reset)."""
    g = torch.Generator().manual_seed(0)
    for layer in dense.layers:
        *kv, pos = layer
        for t in kv:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
            else:
                t.fill_(float("nan"))
        pos.zero_()


def test_reuse_after_larger_call_equals_fresh_caches(pair):
    """After a call of 8 rows x 28 positions, a call of 1 x 22 reuses the
    buffer's prefix: with the whole buffer poisoned, its tokens equal a
    fresh server's; the prefill program on the poisoned prefix gives logits
    and caches bit-equal to fresh ``init_kv_caches`` (int8 scales 1
    included), and the tail past the prefix keeps its poison."""
    kv, _, _, tree = pair
    s = port_server(tree, kv)
    s.generate(PROMPTS[:5], max_new_tokens=12)     # key (8, 28)
    dense = s._dense
    assert dense.capacity == 8 * 28
    small = ["hello there"]
    _poison(dense)
    got = s.generate(small, max_new_tokens=6)      # key (1, 22)
    assert s._dense is dense and s._dense_growths == 0
    assert got == port_server(tree, kv).generate(small, max_new_tokens=6)

    _poison(dense)
    ids = s._tokenizer.encode(small[0])
    toks = torch.zeros((1, 16), dtype=torch.int64)
    toks[0, :len(ids)] = torch.tensor(ids)
    pos = torch.full((1, 16), PAD_POS, dtype=torch.int32)
    pos[0, :len(ids)] = torch.arange(len(ids), dtype=torch.int32)
    with torch.no_grad():
        logits = s._get_prefill(1, 16, 22)(dense.caches(1, 22), toks, pos)
        want_logits, want_caches = s._prefill_fresh(toks, pos, 22)
    assert torch.equal(logits, want_logits) and bool(torch.isfinite(logits).all())
    for got_layer, want_layer in zip(dense.caches(1, 22), want_caches):
        assert len(got_layer) == (5 if kv == "int8" else 3)
        for x, y in zip(got_layer, want_layer):
            assert x.is_contiguous() and torch.equal(x, y)
    for layer in dense.layers:
        assert not layer[-1][22:].any()            # positions past the prefix: still 0
        scale_or_v = layer[1]                       # float32 scales, or model-dtype V
        assert bool(torch.isnan(scale_or_v[22 * scale_or_v.numel() // dense.capacity:]).all())


def test_growth_drops_graphs_and_keeps_tokens(pair):
    """A call larger than the buffer grows it to that call's rows x
    positions, counts the growth and drops every captured generate graph
    (they hold the old addresses); tokens do not change."""
    kv, _, _, tree = pair
    s = port_server(tree, kv)
    first = s.generate(PROMPTS[:1], max_new_tokens=4)
    assert s._dense.capacity == 1 * 20 and s._dense_growths == 0
    s._generate_graphs[(1, 20)] = object()          # stands for a captured graph
    big = s.generate(PROMPTS[:5], max_new_tokens=10)
    assert s._dense.capacity == 8 * 26 and s._dense_growths == 1
    assert s._generate_graphs == {}
    assert s.generate(PROMPTS[:1], max_new_tokens=4) == first
    assert s._dense_growths == 1
    assert big == port_server(tree, kv).generate(PROMPTS[:5], max_new_tokens=10)


def test_concurrent_callers_get_their_solo_tokens(pair):
    """Eight threads calling generate() at once with different keys (a
    seeded sampled call among them), three times each, with the
    interpreter switching threads every 10 us, serialize on the dense
    buffer: each gets its solo run's tokens, and no request is lost from
    the count."""
    import sys

    kv, _, _, tree = pair
    s = port_server(tree, kv)
    jobs = [dict(prompts=PROMPTS[:1], max_new_tokens=5),
            dict(prompts=[PROMPTS[3], LONG], max_new_tokens=7),
            dict(prompts=PROMPTS[:6], max_new_tokens=4),
            dict(prompts=PROMPTS[4:6], max_new_tokens=9, temperature=0.7, seed=11)]
    jobs = jobs + jobs[::-1]
    solo = [s.generate(**job) for job in jobs]
    n0 = s.tags()["llm_requests"]
    results, errors = [[] for _ in jobs], []
    barrier = threading.Barrier(len(jobs))

    def run(i):
        try:
            barrier.wait(30)
            for _ in range(3):
                results[i].append(s.generate(**jobs[i]))
        except Exception as e:   # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert results == [[out] * 3 for out in solo]
    assert s.tags()["llm_requests"] == n0 + 3 * len(jobs)


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_sample_tokens_tensor_temperature_bit_equal_to_float(temp):
    """The 0-dim tensor form, the float form and the draw as the port made
    it with a float (argmax at temperature 0; top-k Gumbel-max over the
    logits divided by the temperature) give the same tokens and keys."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy((rng.standard_normal((6, 256)) * 3).astype(np.float32))
    keys = torch.tensor([seed_key(i) for i in range(6)], dtype=torch.int64)
    k_t, t_t = sample_tokens(keys, logits, torch.tensor(temp, dtype=torch.float32), 20)
    k_f, t_f = sample_tokens(keys, logits, temp, 20)
    k_ref, sub = split_keys(keys)
    if temp <= 0.0:
        ref = torch.argmax(logits, dim=-1)
    else:
        topv, topi = torch.topk(logits, 20, dim=-1)
        bits = _mix32((sub[:, None] + torch.arange(20) * _GOLDEN) & _M32)
        u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
        draw = torch.argmax(topv / max(temp, 1e-6) - torch.log(-torch.log(u)), dim=-1)
        ref = topi.gather(-1, draw[:, None])[:, 0]
        assert not torch.equal(ref, torch.argmax(logits, dim=-1))
    assert torch.equal(t_t, ref) and torch.equal(t_f, ref)
    assert torch.equal(k_t, k_ref) and torch.equal(k_f, k_ref)


@pytest.mark.parametrize("temp", [0.0, -1.0])
def test_sample_tokens_host_greedy_equals_device_greedy(temp):
    """None (greedy chosen on the host, as a greedy batcher passes it)
    gives the tokens and keys of the 0-dim tensor at or below 0."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.standard_normal((5, 256)) * 3).astype(np.float32))
    keys = torch.tensor([seed_key(i) for i in range(5)], dtype=torch.int64)
    k_n, t_n = sample_tokens(keys, logits, None, 20)
    k_t, t_t = sample_tokens(keys, logits, torch.tensor(temp, dtype=torch.float32), 20)
    assert torch.equal(t_n, t_t) and torch.equal(k_n, k_t)
    assert torch.equal(t_n, torch.argmax(logits, dim=-1))


def test_sample_tokens_rejects_a_temperature_elsewhere():
    logits = torch.zeros((2, 8))
    keys = torch.zeros((2,), dtype=torch.int64)
    for bad in (torch.tensor(0.5, device="meta"), torch.tensor([0.5])):
        with pytest.raises(ValueError, match="0-dim tensor"):
            sample_tokens(keys, logits, bad, 4)
