"""The port's fused paged decode step (``decode_fuse_steps``: K steps a
dispatch) held against its own ``generate()`` and against the JAX package,
on the CPU at llama-tiny widths with the JAX params crossed over. On the CPU
the step program runs eagerly; its CUDA graph is tested on the card
(``tests/test_torch_kernels_cuda.py``).

- the port's batcher with K in {2, 3, 4} at pipeline depth 1 and 2 gives
  exactly ``generate()``'s greedy tokens, and at K = 4 a seeded request
  gives ``generate(seed=)``'s sampled tokens;
- an EOS inside a fused block, and a budget that is not a multiple of K,
  come back exact; the host lag counts steps, not dispatches;
- ``_pick_k`` is 1 while a request waits or a prefill is mid-flight;
- the K-step program equals K one-step programs bit for bit, and the JAX
  package's ``_get_decode_step_paged(k=4)`` token for token;
- the port's fused batcher (K = 4) equals the JAX ``ContinuousBatcher(
  fuse_steps=4)`` on the same params and prompts (greedy)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.transformer import init_paged_kv_caches as jax_init_paged
from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxContinuousBatcher
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import TRASH_PAGE, init_paged_kv_caches
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher, _PrefillJob
from seldon_core_tpu_torch.runtime.scheduler import PendingRequest
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          max_seq_len=128, dtype="float32", tie_embeddings=True)
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, eos_id=-1, seed=3,
              len_buckets=(16, 32), batch_buckets=(1, 4))
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11], "hello world", [7]]
BATCH = dict(max_slots=2, max_len=48, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def jax_pair():
    s = JaxLLMServer(init_random=True, temperature=0.0, **COMMON)
    s.load()
    return s, {"params": jax.tree_util.tree_map(np.asarray, s._params["params"])}


def port_server(params, **extra) -> LLMServer:
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


@pytest.fixture(scope="module")
def server(jax_pair):
    return port_server(jax_pair[1], temperature=0.0)


@pytest.fixture(scope="module")
def sampled_server(jax_pair):
    return port_server(jax_pair[1], temperature=0.8, top_k=20)


def run_batch(server, prompts, n, seeds=None, **kw):
    server._decode_host_lag.clear()
    b = ContinuousBatcher(server, device="cpu", **dict(BATCH, **kw))
    try:
        futs = [b.submit(p, n, seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        return [f.result(120) for f in futs], b
    finally:
        b.close()


def solo(server, prompts, n, seeds=None):
    return [server.generate([p], max_new_tokens=n,
                            seed=None if seeds is None else seeds[i])["tokens"][0]
            for i, p in enumerate(prompts)]


def test_decode_fuse_steps_is_served(server):
    s = LLMServer(device="cpu", decode_fuse_steps=4, **COMMON)
    assert s.decode_fuse_steps == 4
    b = ContinuousBatcher(server, device="cpu", fuse_steps=3, **BATCH)
    assert b.fuse_steps == 3 and b._graphs == {}   # the CPU runs the program eagerly
    with pytest.raises(ValueError, match="decode_fuse_steps"):
        LLMServer(device="cpu", decode_fuse_steps=-1, **COMMON)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_fused_batcher_greedy_equals_generate(server, k, depth):
    """Four requests on two slots (two admitted mid-stream, the 11-byte
    prompt in two prefill chunks): every token equals the private
    ``generate()``'s, and fused dispatches ran (a drain saw a K-step
    record)."""
    outs, b = run_batch(server, PROMPTS, 12, fuse_steps=k, pipeline_depth=depth)
    assert outs == solo(server, PROMPTS, 12)
    assert max(server._decode_host_lag) >= k
    assert b.page_stats()["kv_pages_in_use"] == 0


def test_fused_batcher_seeded_equals_generate_seed(sampled_server):
    seeds = [42, 1234, 7, 99]
    outs, _ = run_batch(sampled_server, PROMPTS, 12, seeds=seeds, fuse_steps=4,
                        pipeline_depth=2, max_slots=4)
    assert outs == solo(sampled_server, PROMPTS, 12, seeds)
    assert max(sampled_server._decode_host_lag) >= 4


@pytest.mark.parametrize("case", ["eos_inside_block", "budget_not_multiple_of_k"])
def test_fused_block_cut_at_eos_and_budget(jax_pair, server, case):
    """A fused block runs past a sequence's EOS on the device; the host cuts
    at the first EOS. A budget that is not a multiple of K comes back exact
    (K falls back to 1 at the budget's edge)."""
    p = [5, 9, 17]
    if case == "eos_inside_block":
        probe = server.generate([p], max_new_tokens=10)["tokens"][0]
        s, k, n = port_server(jax_pair[1], temperature=0.0, eos_id=probe[4]), 3, 10
    else:
        s, k, n = server, 4, 10
    expected = s.generate([p], max_new_tokens=n)["tokens"][0]
    if case == "eos_inside_block":
        assert len(expected) < n   # the EOS really truncates
    outs, _ = run_batch(s, [p], n, fuse_steps=k, pipeline_depth=2, max_slots=1)
    assert outs == [expected]


def test_host_lag_counts_steps(server):
    """Depth 2 of K = 4 blocks: the host trailed by more than 4 steps."""
    outs, _ = run_batch(server, PROMPTS[:2], 16, fuse_steps=4, pipeline_depth=2)
    assert outs == solo(server, PROMPTS[:2], 16)
    assert max(server._decode_host_lag) > 4
    assert len(server._decode_dispatch_times) > 0 and len(server._decode_sync_times) > 0


def test_pick_k_is_one_while_pending_or_prefilling(server):
    b = ContinuousBatcher(server, device="cpu", fuse_steps=4, **BATCH)
    slot = b._slots[0]
    slot.active, slot.true_len, slot.max_new, slot.disp_new = True, 5, 20, 1
    assert b._pick_k() == 4
    b._pending.push(PendingRequest(ids=[1, 2], max_new=4, fut=None, t_arrival=0.0))
    assert b._pick_k() == 1
    b._pending.drain_all()
    b._prefill = _PrefillJob(1, [1, 2], 0, 8, PendingRequest(ids=[1, 2], max_new=4, fut=None))
    assert b._pick_k() == 1
    b._prefill = None
    slot.disp_new = 17   # room for 3 steps
    assert b._pick_k() == 1
    slot.disp_new = 16
    assert b._pick_k() == 4
    b.fuse_steps = 1
    assert b._pick_k() == 1


def _step_inputs(server, slots=3, n_pages=4, ps=8):
    """Pools of 14 pages, slot i's table row pages 2 + 4i .., the last slot
    all TRASH (a free slot riding along), positions 0, 5, 9."""
    pools = init_paged_kv_caches(server._cfg, 2 + slots * n_pages, ps, device="cpu")
    bt = torch.tensor([[2 + n_pages * i + j for j in range(n_pages)] for i in range(slots)],
                      dtype=torch.int32)
    bt[-1] = TRASH_PAGE
    last_tok = torch.tensor([5, 17, 40], dtype=torch.int64)
    next_pos = torch.tensor([0, 5, 9], dtype=torch.int32)
    keys = torch.tensor([11, 22, 33], dtype=torch.int64)
    return pools, last_tok, next_pos, keys, bt


def test_k_step_program_equals_k_single_steps(sampled_server):
    """The K = 4 program (cached under the JAX package's key) and four
    K = 1 calls from identical copies give the same tokens, state and pools
    bit for bit, sampled at temperature 0.8; the state is updated in
    place."""
    s = sampled_server
    prog4 = s._get_decode_step_paged(3, 4, 4)
    assert s._get_decode_step_paged(3, 4, 4) is prog4
    assert ("pagedstep", 3, 4, 4, False) in s._decode_cache
    pools, last_tok, next_pos, keys, bt = _step_inputs(s)
    copies = ([tuple(t.clone() for t in layer) for layer in pools], last_tok.clone(),
              next_pos.clone(), keys.clone())
    with torch.no_grad():
        toks4 = prog4(pools, last_tok, next_pos, keys, 0.8, bt)
        prog1 = s._get_decode_step_paged(3, 4, 1)
        toks1 = torch.cat([prog1(*copies, 0.8, bt) for _ in range(4)], dim=1)
    assert toks4.shape == (3, 4) and torch.equal(toks4, toks1)
    assert torch.equal(next_pos, torch.tensor([4, 9, 13], dtype=torch.int32))
    for a, b in zip((last_tok, next_pos, keys), copies[1:]):
        assert torch.equal(a, b)
    assert torch.equal(last_tok, toks4[:, -1])
    for la, lb in zip(pools, copies[0]):
        for a, b in zip(la, lb):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pagedstep"):
        prog4(pools, last_tok[:2], next_pos[:2], keys[:2], 0.8, bt[:2])


def test_k_step_program_equals_jax(jax_pair, server):
    """The port's K = 4 program and the JAX package's
    ``_get_decode_step_paged(k=4)`` from the same (empty) pools, tables and
    state: the same greedy tokens, positions and position rows, K/V within
    float32 reach (1e-5)."""
    jserver, _ = jax_pair
    pools, last_tok, next_pos, keys, bt = _step_inputs(server)
    jpools = jax_init_paged(jserver._cfg, pools[0][0].shape[0], 8)
    jfn = jserver._get_decode_step_paged(3, 4, 4)
    jpools, jtok, jpos, _, jtoks = jfn(jserver._params, jpools, jnp.asarray(last_tok.numpy()),
                                       jnp.asarray(next_pos.numpy()),
                                       jnp.zeros((3, 2), jnp.uint32),
                                       jnp.asarray(0.0, jnp.float32),
                                       jnp.asarray(bt.numpy()))
    with torch.no_grad():
        toks = server._get_decode_step_paged(3, 4, 4)(pools, last_tok, next_pos, keys, 0.0, bt)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(last_tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(next_pos.numpy(), np.asarray(jpos))
    for layer, jlayer in zip(pools, jpools):
        k, v, pos = layer
        jk, jv, jp = (np.asarray(t) for t in jlayer)
        np.testing.assert_array_equal(pos.numpy(), jp)
        np.testing.assert_allclose(k.numpy(), jk, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), jv, atol=1e-5)


def test_fused_batcher_equals_jax_batcher(jax_pair, server):
    """The port's paged batcher and the JAX package's, both with
    fuse_steps=4 and pipeline depth 2 over the same params: the same greedy
    tokens for every request."""
    jserver, _ = jax_pair

    async def jax_run():
        b = JaxContinuousBatcher(jserver, layout="paged", fuse_steps=4, pipeline_depth=2,
                                 **BATCH)
        outs = await asyncio.gather(*[b.submit(p, max_new_tokens=12) for p in PROMPTS])
        await b.close()
        return outs

    expected = asyncio.run(jax_run())
    outs, _ = run_batch(server, PROMPTS, 12, fuse_steps=4, pipeline_depth=2)
    assert outs == [list(map(int, o)) for o in expected]
