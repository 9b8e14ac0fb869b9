"""Batched LoRA and speculative decoding through the port's paged batcher
over a serving mesh (ranks sharing the CPU), against the unsharded port and
the JAX package on the CPU, float32:

- LoRA at tp = 2 (three adapters and the identity in one batch, the JAX
  ``tests/test_adapters.py`` widths): greedy tokens equal tp = 1's and the
  JAX batcher's on the same weights and factors; a rank's views of the one
  pool see a row written in place; the identity through the sharded
  adapted forward is bitwise the unadapted forward;
- n-gram and draft speculation at tp = 2 and on {seq 2, model 2}: greedy
  tokens equal plain greedy on the same mesh and JAX's ``generate()``; the
  draft stays one unsharded model."""

import asyncio

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.models.transformer import Transformer
from seldon_core_tpu_torch.parallel.topology import Topology
from seldon_core_tpu_torch.runtime.adapters import projection_dims
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.servers.llmserver import LLMServer

TIMEOUT = 120
TP2 = {"data": 1, "model": 2}
SEQ2 = {"data": 1, "seq": 2, "model": 2}


def _mesh(axes):
    return Topology(devices=["cpu"] * int(np.prod(list(axes.values())))).mesh(axes)


def _tree(j):
    return {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}


# ------------------------------------------------------------------ LoRA
LKW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
           max_seq_len=96, dtype="float32")
RANK = 4
LCOMMON = dict(model="transformer", model_kwargs=LKW, max_new_tokens=8, len_buckets=(16,),
               batch_buckets=(1,), temperature=0.0, eos_id=-1, seed=3, lora_rank=RANK,
               lora_max_adapters=6)
PROMPTS = [[5, 9, 17, 3], [11, 2, 63, 40, 7], [29, 29, 4], [77, 13, 8, 1, 90, 33]]
NAMES = ["tenant-0", "tenant-1", "tenant-2"]
ADAPTERS = NAMES + [None]


def _load_adapters(server):
    rng = np.random.default_rng(1234)
    cfg = server._cfg
    for name in NAMES:
        w = {p: (rng.normal(size=(cfg.n_layers, din, RANK)) * 0.25,
                 rng.normal(size=(cfg.n_layers, RANK, dout)) * 0.25)
             for p, (din, dout) in projection_dims(cfg).items()}
        server.adapter_registry.load(name, w, alpha=2 * RANK)


def _lora_serve(server, prompts, adapters):
    b = ContinuousBatcher(server, max_slots=len(prompts), max_len=40, len_buckets=(8,),
                          page_size=8, device="cpu")
    try:
        futs = [b.submit(p, max_new_tokens=6, adapter=a, tenant=a or "base")
                for p, a in zip(prompts, adapters)]
        return [f.result(TIMEOUT) for f in futs]
    finally:
        b.close()


def _jax_lora_serve(server, prompts, adapters):
    async def go():
        b = JaxBatcher(server, max_slots=len(prompts), max_len=40, len_buckets=(8,),
                       layout="paged", page_size=8)
        outs = await asyncio.gather(*[b.submit(p, max_new_tokens=6, adapter=a,
                                               tenant=a or "base")
                                      for p, a in zip(prompts, adapters)])
        await b.close()
        return outs

    return asyncio.run(go())


@pytest.fixture(scope="module")
def lora_servers():
    j = JaxLLMServer(init_random=True, **LCOMMON)
    j.load()
    _load_adapters(j)
    out = {"jax": j}
    for name, mesh_kw in (("tp1", {}), ("tp2", dict(mesh=_mesh(TP2)))):
        p = LLMServer(device="cpu", **LCOMMON, **mesh_kw)
        p.load(params=_tree(j))
        _load_adapters(p)
        out[name] = p
    return out


def test_lora_tp2_equals_tp1_and_jax(lora_servers):
    s = lora_servers
    got = _lora_serve(s["tp2"], PROMPTS, ADAPTERS)
    assert s["tp2"]._module.heads_split and s["tp2"]._module.mlp_split
    assert got == _lora_serve(s["tp1"], PROMPTS, ADAPTERS)
    assert got == _jax_lora_serve(s["jax"], PROMPTS, ADAPTERS)
    base = _lora_serve(s["tp2"], PROMPTS[:3], [None] * 3)
    assert all(m != b for m, b in zip(got[:3], base))   # the adapters are real


def test_lora_identity_bitwise_and_rank_views(lora_servers):
    """Id 0 through the sharded adapted forward is the unadapted forward
    bit for bit; each rank's factors are views of the one pool (B's
    columns of q / w1 / w3, A's rows of o / w2), so an in-place row write
    reaches every rank."""
    p = lora_servers["tp2"]
    m, reg = p._module, p.adapter_registry
    tokens = torch.tensor([PROMPTS[1], PROMPTS[3][:5]])
    with torch.no_grad():
        plain, _ = m(tokens)
        ident, _ = m(tokens, adapters=reg.pool(), adapter_ids=torch.zeros(2, dtype=torch.int64))
    assert torch.equal(plain, ident)
    views = m._rank_adapters(reg.pool())
    for r, view in enumerate(views):
        for proj, ab in view.items():
            if proj == "scale":
                continue
            A, B = ab
            PA, PB = reg.pool()[proj]
            assert A.untyped_storage().data_ptr() == PA.untyped_storage().data_ptr()
            assert B.untyped_storage().data_ptr() == PB.untyped_storage().data_ptr()
            half = (PA.shape[2] // 2) if proj in ("wo", "w2") else (PB.shape[3] // 2)
            if proj in ("wo", "w2"):
                assert torch.equal(A, PA[:, :, r * half:(r + 1) * half])
            else:
                assert torch.equal(B, PB[..., r * half:(r + 1) * half])
    row = reg.resolve(NAMES[0])
    before = views[1]["w2"][0][row].clone()
    reg.pool()["w2"][0][row].mul_(2.0)
    assert torch.equal(views[1]["w2"][0][row], before * 2.0)
    reg.pool()["w2"][0][row].div_(2.0)


# ----------------------------------------------------------- speculation
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
            max_seq_len=128, dtype="float32", tie_embeddings=True)
SCOMMON = dict(model="transformer", model_kwargs=TINY, max_new_tokens=8, len_buckets=(16, 32),
               batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3)


@pytest.fixture(scope="module")
def spec_jax():
    j = JaxLLMServer(init_random=True, **SCOMMON)
    j.load()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 255, size=int(n)).tolist() for n in (5, 9, 4, 7)]
    prompts = [p + p[:3] + p for p in prompts]   # repeats for the n-gram proposer
    return j, prompts, j.generate(prompts)["tokens"]


@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("mesh", ["tp2", "seq2-tp2"])
def test_spec_over_a_mesh_equals_plain_greedy(mesh, mode, spec_jax):
    j, prompts, want = spec_jax
    kw = dict(spec_mode=mode, spec_k=3)
    if mode == "draft":
        kw.update(draft_model="transformer", draft_model_kwargs=dict(TINY, n_layers=1))
    s = LLMServer(device="cpu", mesh=_mesh(TP2 if mesh == "tp2" else SEQ2), **SCOMMON, **kw)
    s.load(params=_tree(j))
    if mode == "draft":
        assert isinstance(s._draft_module, Transformer)   # one unsharded draft
    got = {}
    for name, spec in (("spec", None), ("plain", "off")):
        b = ContinuousBatcher(s, device="cpu", max_slots=4, prefill_chunk=8, page_size=8,
                              spec_mode=spec)
        try:
            got[name] = [f.result(TIMEOUT) for f in [b.submit(p, 8) for p in prompts]]
            if spec is None:
                stats = b.spec_stats()
            assert b.page_stats()["kv_pages_in_use"] == 0
        finally:
            b.close()
    assert stats["spec_mode"] == mode and stats["spec_slot_steps_total"] > 0
    assert got["spec"] == got["plain"] == want
