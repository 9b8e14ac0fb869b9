"""Speculative decoding in the port (``seldon_core_tpu_torch/runtime/spec.py``,
``LLMServer._get_spec_step`` / ``_get_draft_prefill``, the batcher's spec
dispatch and drain, ``Transformer.forward(verify=True)``) held against the
JAX package on the CPU, at ``tests/test_speculative.py``'s sizes (vocab 96,
dim 32, 2 layers, 2 slots, max_len 32, pages of 8), in float32 so that
tokens compare exactly:

- ``normalize_spec_mode`` and ``SpecController`` equal the JAX package's,
  the controller over one seeded random trace of reset / observe / cap
  (caps, ``rates()``, ``snapshot()``);
- one spec step of the port equals the JAX ``_get_spec_step`` on the same
  converted params, pools, history, caps and state (n-gram over a float and
  an int8 pool; the draft model): tokens, advance, ``next_pos``,
  ``last_tok``, the history and every position row exactly; K/V within
  1e-5 (int8 codes within one step) on every page but TRASH, which absorbs
  the columns past the cap in no set order;
- the verify read (the columns folded into rows of ``ops.paged_attention``)
  equals the prefill-chunk read (the gathered view) on the same inputs,
  and every folded row meets the kernel's page walk (the table cut at the
  row's query page gives the same result);
- greedy tokens through the spec batcher equal the JAX ``generate()``
  (n-gram at K = 4 and K = 1, float and int8 KV, and the perfect drafter:
  a draft configured like the target, acceptance 1.0); a seeded sampled
  spec run equals the port's plain batcher (the port's RNG chain is its
  own); an EOS inside an accepted block, a mid-stream admission with steps
  in flight; on repetitive text (a prompt from a bigram model's greedy
  walk, which has entered its cycle) more than 1.5 tokens a forward, with
  the JAX batcher's exact counters;
- the refusals: fused steps with speculation, a draft of another vocab,
  ``draft_model_uri``, a LoRA spec step without its pool and a dense one
  given block tables, bad knobs at ``load()``."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.runtime.spec import SpecController as JaxController
from seldon_core_tpu.runtime.spec import normalize_spec_mode as jax_normalize
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models import transformer as tt
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.runtime.spec import SpecController, normalize_spec_mode
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3)
BKW = dict(max_slots=2, max_len=32, len_buckets=(8,), pipeline_depth=2, page_size=8)
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11], [7], [60, 61, 62, 63]]
REP = [3, 7, 11, 3, 7, 11, 3, 7, 11, 3, 7]
# a draft narrower than the target, its query heads grouped on one KV head
GQA_DRAFT = dict(vocab_size=96, dim=16, n_layers=1, n_heads=4, n_kv_heads=1, ffn_dim=32,
                 max_seq_len=96, dtype="float32")
S, K, MAX_LEN, PS = 2, 4, 32, 8
N_PAGES = MAX_LEN // PS
TIMEOUT = 120


def tree(server):
    return {"params": jax.tree_util.tree_map(np.asarray, server._params["params"])}


def jax_server(**extra):
    s = JaxLLMServer(init_random=True, **dict(COMMON, **extra))
    s.load()
    return s


def port_server(params, draft_params=None, **extra):
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params, draft_params=draft_params)
    return s


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX server (its draft a copy of the target: the perfect
    drafter) and its weights as numpy."""
    j = jax_server(spec_mode="draft", draft_model="transformer", draft_model_kwargs=KW)
    return j, tree(j)


@pytest.fixture(scope="module")
def server(jax_pair):
    j, params = jax_pair
    return port_server(params, {"params": jax.tree_util.tree_map(
        np.asarray, j._draft_params["params"])}, draft_model="transformer",
        draft_model_kwargs=KW)


def run_batch(server, prompts, *, n=8, seeds=None, **kw):
    b = ContinuousBatcher(server, device="cpu", **dict(BKW, **kw))
    try:
        futs = [b.submit(p, n, seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        outs = [f.result(TIMEOUT) for f in futs]
        stats = b.spec_stats()
        stats["admit_inflight"] = b._last_admit_inflight
        stats["pages_in_use"] = b.page_stats()["kv_pages_in_use"]
        return outs, stats
    finally:
        b.close()


# ------------------------------------------------------------ host state
def test_normalize_spec_mode_equals_jax():
    for v in ("", None, "off", "NONE", "0", "ngram", "n-gram", "prompt_lookup", "self",
              "DRAFT", "draft-model", "model"):
        assert normalize_spec_mode(v) == jax_normalize(v)
    for bad in ("banana", "warp-drive"):
        with pytest.raises(ValueError, match="spec_mode"):
            normalize_spec_mode(bad)
        with pytest.raises(ValueError, match="spec_mode"):
            jax_normalize(bad)


def test_controller_trace_equals_jax():
    rng = np.random.default_rng(14)
    port, ref = SpecController(3, 4), JaxController(3, 4)
    for _ in range(400):
        op, slot = rng.integers(0, 8), int(rng.integers(0, 3))
        if op == 0:
            port.reset(slot)
            ref.reset(slot)
        elif op < 5:
            offered = int(rng.integers(0, 5))
            acc = int(rng.integers(0, offered + 1))
            for c in (port, ref):
                c.observe(slot, acc, offered, acc + 1)
        assert port.cap(slot) == ref.cap(slot)
        assert port.rates() == ref.rates()
    assert port.snapshot() == ref.snapshot()


# ------------------------------------------------------------ one spec step
def _step_state(cfg, kv: str, dcfg=None, seed: int = 0):
    """A live two-slot state as numpy: pools whose pages hold the slots'
    positions below next_pos (the batcher's page invariant), random K/V,
    a history with a repeated trigram, caps and, given the draft's config
    ``dcfg``, the draft cache."""
    rng = np.random.default_rng(seed)
    kvh, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    pages = S * N_PAGES + tt.RESERVED_PAGES
    tables = np.arange(tt.RESERVED_PAGES, pages, dtype=np.int32).reshape(S, N_PAGES)
    next_pos = np.array([13, 19], np.int32)
    pos = np.full((pages, PS), tt.PAD_POS, np.int32)
    for i in range(S):
        for j, page in enumerate(tables[i]):
            p = j * PS + np.arange(PS)
            pos[page] = np.where(p < next_pos[i], p, tt.PAD_POS)
    pools = []
    for _ in range(L):
        k = rng.standard_normal((pages, PS, kvh, hd)).astype(np.float32)
        v = rng.standard_normal((pages, PS, kvh, hd)).astype(np.float32)
        if kv == "int8":
            pools.append((rng.integers(-127, 128, k.shape).astype(np.int8),
                          rng.uniform(0.005, 0.02, k.shape[:3]).astype(np.float32),
                          rng.integers(-127, 128, v.shape).astype(np.int8),
                          rng.uniform(0.005, 0.02, v.shape[:3]).astype(np.float32), pos.copy()))
        else:
            pools.append((k, v, pos.copy()))
    hist = rng.integers(0, cfg.vocab_size, (S, MAX_LEN)).astype(np.int32)
    hist[0, :14] = np.resize([3, 7, 11], 14)           # slot 0: a cycle up to next_pos
    hist[1, 17:20] = hist[1, 4:7]                        # slot 1: its last trigram seen before
    last_tok = hist[np.arange(S), next_pos].astype(np.int32)
    dcaches = None
    if dcfg is not None:
        dcaches = []
        dkvh, dhd = dcfg.n_kv_heads, dcfg.head_dim
        for _ in range(dcfg.n_layers):
            dpos = np.where(np.arange(MAX_LEN)[None] < next_pos[:, None],
                            np.arange(MAX_LEN)[None], tt.PAD_POS).astype(np.int32)
            dcaches.append((rng.standard_normal((S, MAX_LEN, dkvh, dhd)).astype(np.float32),
                            rng.standard_normal((S, MAX_LEN, dkvh, dhd)).astype(np.float32),
                            dpos))
    return dict(pools=pools, tables=tables, next_pos=next_pos, hist=hist, last_tok=last_tok,
                cap=np.array([4, 3], np.int32), dcaches=dcaches)


def _to_torch(arrs):
    return tuple(torch.from_numpy(np.array(a)) for a in arrs)


@pytest.mark.parametrize("mode,kv", [("ngram", "float"), ("ngram", "int8"), ("draft", "float")])
def test_spec_step_equals_jax(jax_pair, server, mode, kv):
    _check_step_equals_jax(jax_pair[0], server, mode, kv)


def test_gqa_draft_step_equals_jax():
    """A draft of its own widths with grouped KV heads (4 query heads on
    one KV head, as TinyLlama-1.1B groups 32 on 4): its K + 1 forwards over
    the dense draft cache, the cache index and the trash column, held to
    the JAX step like the perfect drafter."""
    j = jax_server(spec_mode="draft", draft_model="transformer", draft_model_kwargs=GQA_DRAFT)
    p = port_server(tree(j), {"params": jax.tree_util.tree_map(
        np.asarray, j._draft_params["params"])}, spec_mode="draft", draft_model="transformer",
        draft_model_kwargs=GQA_DRAFT)
    assert p._draft_cfg.n_kv_heads < p._draft_cfg.n_heads
    _check_step_equals_jax(j, p, "draft", "float")


def _check_step_equals_jax(j, server, mode, kv):
    st = _step_state(server._cfg, kv, server._draft_cfg if mode == "draft" else None)
    jfn = j._get_spec_step(S, K, MAX_LEN, mode=mode, layout="paged", n_pages=N_PAGES)
    args = [j._params, [tuple(jnp.asarray(a) for a in layer) for layer in st["pools"]],
            jnp.asarray(st["last_tok"]), jnp.asarray(st["next_pos"]),
            jnp.zeros((S, 2), jnp.uint32), jnp.asarray(0.0, jnp.float32),
            jnp.asarray(st["tables"]), jnp.asarray(st["hist"]), jnp.asarray(st["cap"])]
    if mode == "draft":
        args += [j._draft_params, [tuple(jnp.asarray(a) for a in layer)
                                   for layer in st["dcaches"]]]
    ref = jfn(*args)
    jpools, jlast, jnext, _, jhist, jtoks, jacc = ref[:7]

    pools = [_to_torch(layer) for layer in st["pools"]]
    last_tok = torch.from_numpy(st["last_tok"].astype(np.int64))
    next_pos = torch.from_numpy(st["next_pos"].copy())
    keys = torch.arange(S, dtype=torch.int64)
    hist = torch.zeros((S, MAX_LEN + 1), dtype=torch.int64)
    hist[:, :MAX_LEN] = torch.from_numpy(st["hist"].astype(np.int64))
    dcaches = None
    if mode == "draft":   # the port's draft cache has a trash column past max_len
        dcaches = tt.init_kv_caches(server._draft_cfg, S, MAX_LEN + 1, device="cpu")
        for layer, src in zip(dcaches, st["dcaches"]):
            for t, a in zip(layer, src):
                t[:, :MAX_LEN] = torch.from_numpy(a)
    fn = server._get_spec_step(S, K, MAX_LEN, mode=mode, layout="paged", n_pages=N_PAGES)
    out = fn(pools, last_tok, next_pos, keys, None, torch.from_numpy(st["tables"]), hist,
             torch.from_numpy(st["cap"]), dcaches)

    assert out[:, :K + 1].tolist() == np.asarray(jtoks).tolist()
    assert out[:, K + 1].tolist() == np.asarray(jacc).tolist()
    assert next_pos.tolist() == np.asarray(jnext).tolist()
    assert last_tok.tolist() == np.asarray(jlast).tolist()
    assert hist[:, :MAX_LEN].tolist() == np.asarray(jhist).tolist()
    assert hist[:, MAX_LEN].tolist() == [0] * S
    keep = torch.ones(S * N_PAGES + tt.RESERVED_PAGES, dtype=torch.bool)
    keep[tt.TRASH_PAGE] = False
    for layer, jlayer in zip(pools, jpools):
        assert torch.equal(layer[-1], torch.from_numpy(np.array(jlayer[-1])))
        for t, a in zip(layer[:-1], jlayer[:-1]):
            want = torch.from_numpy(np.asarray(a))[keep]
            if t.dtype == torch.int8:
                assert (t[keep].int() - want.int()).abs().max() <= 1
            else:
                torch.testing.assert_close(t[keep], want, rtol=1e-5, atol=1e-5)
    if mode == "draft":
        for layer, jlayer in zip(dcaches, ref[7]):
            assert torch.equal(layer[-1][:, :MAX_LEN], torch.from_numpy(np.asarray(jlayer[-1])))
            for t, a in zip(layer[:-1], jlayer[:-1]):
                torch.testing.assert_close(t[:, :MAX_LEN], torch.from_numpy(np.asarray(a)),
                                           rtol=1e-5, atol=1e-5)


def test_verify_read_equals_chunk_read_and_meets_the_page_walk(server, monkeypatch):
    """The verify's folded rows read what the gathered prefill-chunk read
    computes, and every row meets the kernel's walk (its table cut at its
    query page)."""
    from seldon_core_tpu_torch.ops import paged_attention as pa

    st = _step_state(server._cfg, "float", seed=5)
    mk = lambda: [_to_torch(layer) for layer in st["pools"]]  # noqa: E731
    tables = torch.from_numpy(st["tables"])
    cols = torch.arange(K + 1, dtype=torch.int32)
    nxt = torch.from_numpy(st["next_pos"])
    positions = torch.where(cols[None] <= torch.tensor([[4], [2]]), nxt[:, None] + cols,
                            tt.PAD_POS)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (S, K + 1)))
    real, rows = pa.paged_attention, []

    def checked(q, cache, block_tables, qpos):
        out = real(q, cache, block_tables, qpos)
        for r in range(block_tables.shape[0]):
            last = max(1, min(N_PAGES, int(qpos[r, 0]) // PS + 1))
            cut = pa.paged_attention_ref(q[r:r + 1], cache, block_tables[r:r + 1, :last],
                                         qpos[r:r + 1])
            torch.testing.assert_close(cut, out[r:r + 1], rtol=1e-5, atol=1e-6)
        rows.append(block_tables.shape[0])
        return out

    monkeypatch.setattr(pa, "paged_attention", checked)
    mod = server._module
    pv = mk()
    lv, _ = mod(tokens, positions=positions, caches=pv, block_tables=tables, verify=True)
    assert rows == [S * (K + 1)] * server._cfg.n_layers
    pc = mk()
    lc, _ = mod(tokens, positions=positions, caches=pc, block_tables=tables)
    real_cols = positions != tt.PAD_POS
    torch.testing.assert_close(lv[real_cols], lc[real_cols], rtol=1e-5, atol=1e-5)
    for a, b in zip(pv, pc):
        assert torch.equal(a[-1], b[-1])


# ------------------------------------------------------------ the batcher
@pytest.fixture(scope="module")
def expected(jax_pair):
    j, _ = jax_pair
    return [j.generate([p], max_new_tokens=8)["tokens"][0] for p in PROMPTS]


@pytest.mark.parametrize("k", [4, 1])
def test_ngram_greedy_equals_jax_generate(server, expected, k):
    outs, st = run_batch(server, PROMPTS, spec_mode="ngram", spec_k=k)
    assert outs == expected
    assert st["spec_mode"] == "ngram" and st["spec_k"] == k
    assert st["spec_slot_steps_total"] > 0 and st["pages_in_use"] == 0


def test_int8_kv_greedy_equals_jax_generate(jax_pair):
    _, params = jax_pair
    j8 = jax_server(kv_cache_dtype="int8")   # the same seed: the same weights
    p8 = port_server(params, kv_cache_dtype="int8")
    want = [j8.generate([p], max_new_tokens=8)["tokens"][0] for p in PROMPTS]
    outs, _ = run_batch(p8, PROMPTS, spec_mode="ngram", spec_k=4)
    assert outs == want


def test_perfect_drafter_equals_jax_generate(server, expected):
    outs, st = run_batch(server, PROMPTS, spec_mode="draft", spec_k=4)
    assert outs == expected
    # every proposal of a copy of the target verifies
    assert st["spec_accept_rate"] == pytest.approx(1.0)
    assert st["spec_tokens_per_forward"] > 2.0


def test_random_draft_like_the_target_is_a_copy():
    """A draft configured like the target, both random from the server
    seed, is the target bit for bit (the JAX package's perfect drafter)."""
    s = LLMServer(device="cpu", init_random=True, draft_model="transformer",
                  draft_model_kwargs=KW, **COMMON)
    s.load()
    target, draft = s._module.state_dict(), s._draft_module.state_dict()
    assert target.keys() == draft.keys()
    assert all(torch.equal(target[n], draft[n]) for n in target)


def test_seeded_sampled_spec_equals_plain_batcher(jax_pair):
    _, params = jax_pair
    s = port_server(params, temperature=0.8, top_k=20)
    prompts, seeds = [[5, 9, 17, 2], [40, 3, 22], [7, 7, 7, 7, 7]], [42, 1234, 7]
    plain, _ = run_batch(s, prompts, seeds=seeds)
    spec, st = run_batch(s, prompts, seeds=seeds, spec_mode="ngram", spec_k=4)
    assert spec == plain
    assert plain == [s.generate([p], max_new_tokens=8, seed=sd)["tokens"][0]
                     for p, sd in zip(prompts, seeds)]
    assert st["spec_slot_steps_total"] > 0


def test_eos_inside_an_accepted_block(jax_pair):
    """With the perfect drafter whole blocks of 5 verify (tokens 1-5, 6-10,
    after the prefill's), so a token first seen at 6 or later and made the
    EOS lands inside one: the drain cuts the credit AT the EOS and drops
    the rest of the block."""
    j, params = jax_pair
    free = j.generate([REP], max_new_tokens=16)["tokens"][0]
    at = next(i for i, t in enumerate(free) if i >= 6 and t not in free[:i])
    assert (at - 1) % (K + 1) != K, "the EOS would end its block"
    eos, cut = free[at], free[:at]
    dparams = {"params": jax.tree_util.tree_map(np.asarray, j._draft_params["params"])}
    s = port_server(params, dparams, eos_id=eos, draft_model="transformer",
                    draft_model_kwargs=KW)
    assert s.generate([REP], max_new_tokens=16)["tokens"][0] == cut
    outs, st = run_batch(s, [REP], n=16, spec_mode="draft", spec_k=4)
    assert outs[0] == cut
    # the device advanced past what the host surfaced
    assert st["spec_tokens_per_forward"] * st["spec_slot_steps_total"] > len(cut) + 1


def test_midstream_admit_with_steps_in_flight(server, jax_pair, expected):
    extra = [[12, 13], [80, 2, 5]]
    want = expected + [jax_pair[0].generate([p], max_new_tokens=8)["tokens"][0] for p in extra]
    outs, st = run_batch(server, PROMPTS + extra, spec_mode="ngram", spec_k=4)
    assert outs == want
    # six requests through two slots: later admissions found steps in flight
    assert st["admit_inflight"] >= 1 and st["pages_in_use"] == 0


def test_repetitive_text_beats_1_5_tokens_per_forward():
    """The JAX package's bar at K = 4: > 1.5 tokens a verify forward on
    repetitive text. Random weights at these widths do not continue REP
    repetitively (both batchers read 1.13 tokens a forward on it), so the
    model is made a bigram model (every layer's wo and w2 zeroed): its
    greedy text is a walk over tokens that enters a cycle, and the prompt
    is 11 tokens of that walk (the cycle and its start again), which
    prompt lookup then continues. The port's tokens equal the JAX
    generate() and its counters equal the JAX batcher's."""
    j = jax_server()
    p = j._params["params"]
    for name in p:
        if name.startswith("layer_"):
            p[name]["attention"]["wo"] = jnp.zeros_like(p[name]["attention"]["wo"])
            p[name]["ffn"]["w2"] = jnp.zeros_like(p[name]["ffn"]["w2"])
    prompt = j.generate([REP], max_new_tokens=len(REP))["tokens"][0]
    assert len(set(prompt)) < len(prompt), prompt   # the walk has closed its cycle
    want = j.generate([prompt], max_new_tokens=18)["tokens"][0]

    async def jax_run():
        b = JaxBatcher(j, layout="paged", spec_mode="ngram", spec_k=4, **BKW)
        out = await b.submit(prompt, max_new_tokens=18)
        stats = b.spec_stats()
        await b.close()
        return out, stats

    jout, jst = asyncio.run(jax_run())
    outs, st = run_batch(port_server(tree(j)), [prompt], n=18, spec_mode="ngram", spec_k=4)
    assert outs[0] == want == jout
    assert st["spec_tokens_per_forward"] > 1.5, st
    assert st["spec_accept_rate"] > 0.0
    for key, value in jst.items():
        assert st[key] == (value if isinstance(value, str) else pytest.approx(value)), key


# ------------------------------------------------------------ refusals
def test_fuse_steps_with_speculation_rejected(server):
    with pytest.raises(ValueError, match="decode_fuse_steps"):
        ContinuousBatcher(server, device="cpu", fuse_steps=4, spec_mode="ngram", **BKW)


def test_draft_vocab_mismatch_rejected():
    with pytest.raises(ValueError, match="vocab"):
        LLMServer(device="cpu", init_random=True, spec_mode="draft", draft_model="transformer",
                  draft_model_kwargs=dict(KW, vocab_size=64), **COMMON).load()


def test_draft_model_uri_names_checkpoint_loading(tmp_path):
    """``draft_model_uri`` loads the draft's checkpoint (config.json +
    params.msgpack; tests/test_torch_llm_checkpoint.py holds it to
    ``draft_params`` and the JAX server); a missing one raises the storage
    error naming the path."""
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.servers.torchserver import export_checkpoint
    from seldon_core_tpu_torch.storage import StorageError

    draft = get_model("transformer", device="cpu", **KW)
    draft.init_params(torch.Generator().manual_seed(5))
    export_checkpoint(str(tmp_path / "draft"), "transformer", {"params": draft.param_tree()},
                      kwargs=KW)
    s = LLMServer(device="cpu", spec_mode="draft", draft_model_uri=f"file://{tmp_path}/draft",
                  init_random=True, **COMMON)
    s.load()
    for a, b in zip(s._draft_module.state_dict().values(), draft.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(StorageError, match="does not exist"):
        LLMServer(device="cpu", spec_mode="draft", draft_model_uri=str(tmp_path / "none"),
                  init_random=True, **COMMON).load()


def test_lora_and_dense_spec_steps_name_their_slices(server):
    """The adapted (``lora=True``) spec step is served under the JAX key and
    refuses a call without the adapter pool (tests/test_torch_lora_batcher.py
    serves it); so is the dense layout's, which verifies over a slot pool
    (``tests/test_torch_dense_batcher.py`` serves it) and refuses a paged
    pool's block tables."""
    prog = server._get_spec_step(S, K, MAX_LEN, n_pages=N_PAGES, lora=True)
    assert ("specstep", S, K, MAX_LEN, "ngram", "paged", N_PAGES, True) in server._decode_cache
    with pytest.raises(ValueError, match="adapters none"):
        prog(None, torch.zeros(S, dtype=torch.long), None, None, None,
             torch.zeros((S, N_PAGES), dtype=torch.int32),
             torch.zeros((S, MAX_LEN + 1), dtype=torch.long), torch.zeros(S, dtype=torch.int32))
    dense = server._get_spec_step(S, K, MAX_LEN, layout="dense")
    assert ("specstep", S, K, MAX_LEN, "ngram", "dense", 0, False) in server._decode_cache
    pool = server._module.init_slot_caches(S, MAX_LEN, device="cpu")
    state = (torch.zeros(S, dtype=torch.long), torch.zeros(S, dtype=torch.int32),
             torch.zeros(S, dtype=torch.long), None)
    hist, cap = torch.zeros((S, MAX_LEN + 1), dtype=torch.long), torch.zeros(S, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_tables"):
        dense(pool, *state, torch.zeros((S, N_PAGES), dtype=torch.int32), hist, cap)
    out = dense(pool, *state, None, hist, cap)
    assert tuple(out.shape) == (S, K + 2) and torch.equal(out[:, K + 1], torch.ones(S).long())


def test_spec_knobs_validated_at_load():
    for kw, match in ((dict(spec_mode="warp-drive"), "spec_mode"),
                      (dict(spec_mode="ngram", spec_k=-1), "spec_k"),
                      (dict(spec_mode="ngram", spec_ngram=-2), "spec_ngram"),
                      (dict(spec_mode="draft"), "draft model")):
        with pytest.raises(ValueError, match=match):
            LLMServer(device="cpu", init_random=True, **dict(COMMON, **kw)).load()
