"""LLM checkpoints in the port (``LLMServer(model_uri=...)`` and
``draft_model_uri``, ``seldon_core_tpu_torch/servers/llmserver.py``) against
the JAX package on the CPU. The JAX package's ``export_checkpoint(use_orbax=
False)`` writes a tiny transformer (2 layers, dim 32) into a temporary
directory; nothing is downloaded:

- the port's ``LLMServer(model_uri=dir)`` serves the same greedy tokens as
  the JAX ``LLMServer(model_uri=dir)`` (``generate()`` and the batcher),
  and as the port's own ``load(params=...)`` on the same arrays;
- a checkpoint holding only the ``params`` collection loads; ``model`` and
  ``model_kwargs`` override the file's;
- ``quantize="int8"`` from a checkpoint equals the JAX int8 server's tokens
  and the port's int8 ``load(params=...)`` bit for bit;
- ``draft_model_uri`` serves as ``draft_params`` does (and as the JAX
  server with the same draft checkpoint);
- an orbax ``params/`` directory raises naming the format; no checkpoint
  and no ``model=`` raises the JAX package's message; a missing path raises
  the storage error."""

import json

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.servers.jaxserver import export_checkpoint
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.storage import StorageError

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
DRAFT_KW = dict(KW, n_layers=1)
SERVE = dict(max_new_tokens=8, len_buckets=(16,), batch_buckets=(1, 4), temperature=0.0,
             eos_id=-1, seed=3)
PROMPTS = [[5, 9, 17, 3], [11, 2, 63, 40, 7], [29, 29, 4]]


def _tree(server):
    return jax.tree_util.tree_map(np.asarray, server._params)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(dir of the full variables dict, dir of the params-only tree, dir of
    the draft, the JAX server whose weights they hold, its draft's tree)."""
    root = tmp_path_factory.mktemp("ckpt")
    j = JaxLLMServer(model="transformer", model_kwargs=KW, init_random=True, **SERVE)
    j.load()
    full = export_checkpoint(str(root / "full"), "transformer", j._params, kwargs=KW,
                             use_orbax=False)
    bare = export_checkpoint(str(root / "bare"), "transformer", {"params": j._params["params"]},
                             kwargs=KW, use_orbax=False)
    d = JaxLLMServer(model="transformer", model_kwargs=DRAFT_KW, init_random=True,
                     **dict(SERVE, seed=11))
    d.load()
    draft = export_checkpoint(str(root / "draft"), "transformer", d._params, kwargs=DRAFT_KW,
                              use_orbax=False)
    return full, bare, draft, j, _tree(d)


def _batcher_tokens(server):
    b = ContinuousBatcher(server, max_slots=3, max_len=40, len_buckets=(8,), page_size=8,
                          device="cpu")
    try:
        return [f.result(60) for f in [b.submit(p, max_new_tokens=6) for p in PROMPTS]]
    finally:
        b.close()


def test_model_uri_serves_the_jax_servers_tokens(ckpt):
    full, _, _, j, _ = ckpt
    jref = JaxLLMServer(model_uri=full, **SERVE)
    jref.load()
    want = jref.generate(PROMPTS)["tokens"]
    assert want == j.generate(PROMPTS)["tokens"]
    p = LLMServer(model_uri=f"file://{full}", device="cpu", **SERVE)
    p.load()
    assert p.model_name is None and p._cfg.n_layers == 2 and p._cfg.dtype == torch.float32
    assert p.generate(PROMPTS)["tokens"] == want
    same = LLMServer(model="transformer", model_kwargs=KW, device="cpu", **SERVE)
    same.load(params=_tree(j))
    batched = _batcher_tokens(p)
    assert batched == _batcher_tokens(same)
    assert batched == [t[:6] for t in want]


def test_params_only_tree_and_overrides_load(ckpt):
    full, bare, _, j, _ = ckpt
    p = LLMServer(model_uri=bare, device="cpu", **SERVE)
    p.load()
    assert p.generate(PROMPTS)["tokens"] == j.generate(PROMPTS)["tokens"]
    jbare = JaxLLMServer(model_uri=bare, **SERVE)      # the JAX retry with the subtree
    jbare.load()
    assert jbare.generate(PROMPTS[:1])["tokens"] == p.generate(PROMPTS[:1])["tokens"]
    # model / model_kwargs override the file's (here: the same registry
    # model, and a kwarg the file does not fix)
    o = LLMServer(model_uri=full, model="transformer", model_kwargs={"fused_norm": True},
                  device="cpu", **SERVE)
    o.load()
    assert o._cfg.fused_norm and o._cfg.dim == 32
    assert o.generate(PROMPTS)["tokens"] == j.generate(PROMPTS)["tokens"]


def test_int8_from_checkpoint_equals_jax_int8(ckpt):
    full, _, _, j, _ = ckpt
    jq = JaxLLMServer(model_uri=full, quantize="int8", **SERVE)
    jq.load()
    p = LLMServer(model_uri=full, quantize="int8", device="cpu", **SERVE)
    p.load()
    assert type(p._module.layer_0.attention.wq).__name__ == "QuantizedTensor"
    assert p.generate(PROMPTS)["tokens"] == jq.generate(PROMPTS)["tokens"]
    # leaf by leaf equals the whole float tree quantized after loading
    q = LLMServer(model="transformer", model_kwargs=KW, quantize="int8", device="cpu", **SERVE)
    q.load(params=_tree(j))
    for (n1, t1), (n2, t2) in zip(p._module.state_dict().items(),
                                  q._module.state_dict().items()):
        assert n1 == n2 and torch.equal(t1, t2), n1
    jqt = jax.tree_util.tree_map(np.asarray, jq._params["params"])
    np.testing.assert_array_equal(p._module.layer_1.ffn.w2.q.numpy(),
                                  np.asarray(jqt["layer_1"]["ffn"]["w2"].q))


def test_draft_model_uri_serves_as_draft_params(ckpt):
    full, _, draft, _, dtree = ckpt
    common = dict(spec_mode="draft", spec_k=2, device="cpu", **SERVE)
    by_uri = LLMServer(model_uri=full, draft_model_uri=draft, **common)
    by_uri.load()
    by_params = LLMServer(model_uri=full, draft_model="transformer",
                          draft_model_kwargs=DRAFT_KW, **common)
    by_params.load(draft_params=dtree)
    for a, b in zip(by_uri._draft_module.state_dict().values(),
                    by_params._draft_module.state_dict().values()):
        assert torch.equal(a, b)
    assert by_uri._draft_cfg.n_layers == 1
    got = _batcher_tokens(by_uri)
    assert got == _batcher_tokens(by_params)
    jref = JaxLLMServer(model_uri=full, draft_model_uri=draft,
                        **dict(SERVE, spec_mode="draft", spec_k=2))
    jref.load()
    assert got == [t[:6] for t in jref.generate(PROMPTS)["tokens"]]


def test_checkpoint_refusals(ckpt, tmp_path):
    (tmp_path / "params").mkdir()
    (tmp_path / "config.json").write_text(json.dumps({"model": "transformer", "kwargs": KW}))
    with pytest.raises(SeldonError, match="orbax"):
        LLMServer(model_uri=str(tmp_path), device="cpu", **SERVE).load()
    with pytest.raises(SeldonError, match="needs model_uri or model="):
        LLMServer(device="cpu", **SERVE).load()
    with pytest.raises(SeldonError, match="No weights"):
        LLMServer(model="transformer", model_kwargs=KW, device="cpu", **SERVE).load()
    with pytest.raises(StorageError, match="does not exist"):
        LLMServer(model_uri=str(tmp_path / "missing"), device="cpu", **SERVE).load()
    with pytest.raises(StorageError, match="does not exist"):
        LLMServer(model_uri=ckpt[0], draft_model_uri=str(tmp_path / "missing"),
                  spec_mode="draft", device="cpu", **SERVE).load()
