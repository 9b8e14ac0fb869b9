"""The port's training path (``seldon_core_tpu_torch/parallel/train.py``,
``models/sharded.py``'s ``train_blocks``, K2's autograd Function) against
the JAX package's, on the CPU: JAX over its 8 virtual devices
(``tests/conftest.py``), the port over co-located ranks (``["cpu"] * 8``),
the same weights (JAX's ``init_train_state`` carried over with
``params_from_jax``), llama-tiny in float32.

- the train step on ``__graft_entry__._factor_axes(8)``'s mesh with
  ``n_experts=2`` (tensor, sequence and expert parallel at once), and on
  {data 2, seq 2, model 2} with ``fused_norm`` off and on and with ring
  attention: the loss within 1e-5 relative of ``jax.value_and_grad``'s,
  every leaf's gradient within 1e-4 * max|g| + 1e-7 of JAX's, ``grad_norm``
  within 1e-5 relative of ``optax.global_norm`` of them (the sums reassociate across ranks;
  float32);
- the optimizers alone: fed JAX's gradients, ``adamw`` and ``adam`` give
  optax's params and moments within 1e-6 over two updates;
- three steps of ``adam(1e-2)``: the loss sequence within 1e-3 relative of
  JAX's ``make_train_step``;
- checkpoints: save, restore into a fresh mesh placement, and the next
  step is bit-equal to the run that never stopped; each leaf is restored
  into its ranks' shards;
- K2's Function: its gradients equal ``jax.grad`` of
  ``residual_rmsnorm_ref`` (float32 within 1e-5, bf16 within two bf16
  ulps of the largest gradient), its forward the plain version's bits;
- the entry points refuse what they cannot train: no card without
  ``device="cpu"``, an int8 model, a batch 'seq' does not split.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.linen import partitioning as nn_partitioning

import __graft_entry__ as graft
from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.ops.fused_norm import residual_rmsnorm_ref as jax_residual_rmsnorm_ref
from seldon_core_tpu.parallel import train as jtrain
from seldon_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seldon_core_tpu.parallel.sharding import _rules_for_mesh
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.models.convert import params_from_jax
from seldon_core_tpu_torch.ops import fused_norm
from seldon_core_tpu_torch.parallel import train as ptrain
from seldon_core_tpu_torch.parallel.topology import Topology

SEQ = 16
MESH = {"data": 2, "seq": 2, "model": 2}


def _tokens(batch, seed=0):
    return np.random.default_rng(seed).integers(0, 255, size=(batch, SEQ), dtype=np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_run(axes, model_kw, tokens, tx, devices):
    """JAX's params, loss, gradients (``jax.value_and_grad`` under the mesh
    and the training rules, as ``make_train_step``'s ``step_fn`` takes
    them) and their ``optax.global_norm`` (its ``grad_norm``)."""
    mesh = jax_make_mesh(axes, devices[:8])
    kw = dict(model_kw)
    if kw.get("attention_impl") == "ring":
        kw["mesh"] = mesh
    model = jax_get_model("llama-tiny", **kw)
    state = jtrain.init_train_state(model, tx, mesh, jnp.zeros_like(tokens))
    params = _np(state.params)
    batch = jtrain.shard_batch(jnp.asarray(tokens), mesh)
    rules = tuple(_rules_for_mesh(mesh, jtrain.TRAIN_RULES))
    with mesh, nn_partitioning.axis_rules(rules):
        loss, grads = jax.jit(jax.value_and_grad(jtrain.next_token_loss(model)))(state.params,
                                                                                 batch)
    return params, float(loss), _flat(_np(grads)), float(optax.global_norm(grads))


_JAX_RUNS = {}


def _jax_case(case, devices):
    """``_jax_run`` of a case, once a module (the optimizer tests reuse
    the dense case's gradients)."""
    if case not in _JAX_RUNS:
        axes, model_kw = CASES[case]
        _JAX_RUNS[case] = _jax_run(axes, model_kw, _tokens(2 * axes.get("data", 1)),
                                   optax.adamw(1e-2), devices)
    return _JAX_RUNS[case]


def _port_state(params, axes, model_kw, tx):
    model = get_model("llama-tiny", device="cpu", **model_kw)
    params_from_jax({"params": params}, model)
    mesh = None if axes is None else Topology(devices=["cpu"] * 8).mesh(axes)
    return ptrain.init_train_state(model, tx, mesh, device="cpu")


def _port_grads(state, tokens):
    shards = ptrain.trained_tensors(state.params)
    loss = ptrain.next_token_loss(state.params, tokens)
    grads = torch.autograd.grad(loss, [t for _, t, _ in shards])
    return float(loss.detach()), ptrain.logical_leaves(shards, grads)


# (mesh, the JAX model's options); the port runs each with fused_norm off
# and on where the JAX case has it on: off the TPU the JAX package's fused
# block is the unfused expression (``residual_rmsnorm_ref``), so one JAX
# run holds both of the port's paths (the plain add + RMSNorm, and K2's
# Function with its explicit backward)
CASES = {
    "factor_axes8-moe": (graft._factor_axes(8), dict(n_experts=2)),
    "dsm-full": (MESH, dict(fused_norm=True)),
    "dsm-ring": (MESH, dict(attention_impl="ring", fused_norm=True)),
}


@pytest.mark.parametrize("case,fused", [("factor_axes8-moe", False), ("dsm-full", False),
                                        ("dsm-full", True), ("dsm-ring", True)])
def test_train_step_equals_jax(case, fused, eight_devices):
    axes, model_kw = CASES[case]
    params, jloss, jgrads, jnorm = _jax_case(case, eight_devices)
    state = _port_state(params, axes, dict(model_kw, fused_norm=fused), ptrain.adamw(1e-2))
    t = torch.as_tensor(_tokens(2 * axes.get("data", 1)))
    loss, grads = _port_grads(state, t)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        want = jgrads[name]
        tol = 1e-4 * np.abs(want).max() + 1e-7
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol, err_msg=name)
    state, metrics = ptrain.make_train_step(ptrain.adamw(1e-2))(state, t)
    assert state.step == 1
    assert abs(float(metrics["grad_norm"]) - jnorm) <= 1e-5 * jnorm
    assert abs(float(metrics["loss"]) - jloss) <= 1e-5 * abs(jloss)


@pytest.mark.parametrize("kv_heads,axes", [(2, MESH), (1, {"model": 2})],
                         ids=["gqa", "one-kv-head"])
def test_sharded_grads_equal_unsharded_and_copies_stay_equal(kv_heads, axes):
    """A replicated leaf's partial gradients meet in one shard: the sharded
    gradients equal the unsharded model's, ``grad_norm`` counts each leaf
    once, and after a step every rank's copy of a leaf is still the one
    tensor. With one KV head and 'model' 2, each rank selects the head its
    query heads share (one tensor for both ranks)."""
    model = get_model("transformer", device="cpu", vocab_size=256, dim=64, n_layers=2,
                      n_heads=4, n_kv_heads=kv_heads, ffn_dim=128, dtype="float32",
                      tie_embeddings=True)
    model.init_params(torch.Generator().manual_seed(1))
    t = torch.as_tensor(_tokens(4, seed=1))
    n = int(np.prod(list(axes.values())))
    sharded = ptrain.init_train_state(model, ptrain.adam(1e-2),
                                      Topology(devices=["cpu"] * n).mesh(axes), device="cpu")
    whole = ptrain.init_train_state(model, ptrain.adam(1e-2), device="cpu")
    _, gs = _port_grads(sharded, t)
    _, gw = _port_grads(whole, t)
    for name in gw:
        np.testing.assert_allclose(gs[name].numpy(), gw[name].numpy(), rtol=0,
                                   atol=1e-5 * gw[name].abs().max().item() + 1e-7, err_msg=name)
    step = ptrain.make_train_step(ptrain.adam(1e-2))
    sharded, ms = step(sharded, t)
    _, mw = step(whole, t)
    assert float(ms["grad_norm"]) == pytest.approx(float(mw["grad_norm"]), rel=1e-5)
    ranks = sharded.params.ranks
    norms = [m.layers()[0].ffn_norm.weight for m in ranks]
    assert all(w is norms[0] for w in norms)
    # one update, not one a copy: the unsharded model's step moved it alike
    assert not torch.equal(norms[0], torch.ones_like(norms[0]))
    torch.testing.assert_close(norms[0], model.layer_0.ffn_norm.weight, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizer_alone_equals_optax(name, eight_devices):
    params, _, grads, _ = _jax_case("dsm-full", eight_devices)
    flat = _flat(params)
    names = sorted(flat)
    jtx = getattr(optax, name)(1e-2)
    ptx = getattr(ptrain, name)(1e-2)
    jp = {k: jnp.asarray(flat[k]) for k in names}
    pp = [torch.tensor(flat[k]) for k in names]
    jstate, pstate = jtx.init(jp), ptx.init(pp)
    for scale in (1.0, -0.5):   # two updates, the second with other gradients
        jg = {k: jnp.asarray(grads[k] * scale) for k in names}
        pg = [torch.tensor(grads[k] * scale) for k in names]
        updates, jstate = jtx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        pupdates, pstate = ptx.update(pg, pstate, pp)
        ptrain.apply_updates(pp, pupdates)
    adam_state = jstate[0]
    assert pstate.count == int(adam_state.count) == 2
    for i, k in enumerate(names):
        np.testing.assert_allclose(pp[i].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(pstate.mu[i].numpy(), np.asarray(adam_state.mu[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(pstate.nu[i].numpy(), np.asarray(adam_state.nu[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_three_steps_loss_sequence_equals_jax(eight_devices):
    tokens = np.tile(np.arange(SEQ, dtype=np.int32)[None, :], (4, 1))
    mesh = jax_make_mesh(MESH, eight_devices[:8])
    model = jax_get_model("llama-tiny")
    state = jtrain.init_train_state(model, optax.adam(1e-2), mesh, jnp.zeros_like(tokens))
    params = _np(state.params)
    step = jtrain.make_train_step(model, optax.adam(1e-2), mesh)
    batch = jtrain.shard_batch(jnp.asarray(tokens), mesh)
    jlosses = []
    for _ in range(3):
        state, m = step(state, batch)
        jlosses.append(float(m["loss"]))
    pstate = _port_state(params, MESH, {}, ptrain.adam(1e-2))
    pstep = ptrain.make_train_step(ptrain.adam(1e-2))
    t = ptrain.shard_batch(tokens, pstate.params.mesh)
    plosses = []
    for _ in range(3):
        pstate, m = pstep(pstate, t)
        plosses.append(float(m["loss"]))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    assert plosses[-1] < plosses[0]


def test_checkpoint_roundtrip_next_step_bit_equal(tmp_path):
    mesh = Topology(devices=["cpu"] * 8).mesh(MESH)
    model = get_model("llama-tiny", device="cpu", fused_norm=True)
    t = torch.as_tensor(_tokens(4, seed=2))
    tx = ptrain.adamw(1e-2)
    state = ptrain.init_train_state(model, tx, mesh, seed=3, device="cpu")
    step = ptrain.make_train_step(tx)
    for _ in range(3):
        state, m = step(state, t)
    path = ptrain.save_train_state(state, str(tmp_path / "state.pt"))
    with pytest.raises(FileExistsError):
        ptrain.save_train_state(state, path, overwrite=False)
    state, m_next = step(state, t)   # the run to reproduce

    fresh = get_model("llama-tiny", device="cpu", fused_norm=True)   # uninitialised values
    restored = ptrain.restore_train_state(path, fresh, tx, mesh, device="cpu")
    assert restored.step == 3 and restored.opt_state.count == 3
    wq = restored.params.ranks[1].layer_0.attention.wq
    assert wq.shape[1] == model.layer_0.attention.wq.shape[1] // 2   # a shard, not the leaf
    restored, m_restored = step(restored, t)
    assert torch.equal(m_restored["loss"], m_next["loss"])
    assert torch.equal(m_restored["grad_norm"], m_next["grad_norm"])
    for (_, a, _), (_, b, _) in zip(ptrain.trained_tensors(restored.params),
                                    ptrain.trained_tensors(state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,wdtype", [("float32", "float32"), ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
def test_k2_function_grads_equal_jax(dtype, wdtype):
    rng = np.random.default_rng(4)
    x, h, dy, do = (rng.standard_normal((3, 5, 64)).astype(np.float32) for _ in range(4))
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt, jwdt = jnp.dtype(dtype), jnp.dtype(wdtype)

    def jloss(x, h, w):
        y, o = jax_residual_rmsnorm_ref(x, h, w, 1e-5)
        return (jnp.sum(y.astype(jnp.float32) * dy) + jnp.sum(o.astype(jnp.float32) * do))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x, jdt), jnp.asarray(h, jdt),
                                              jnp.asarray(w, jwdt))
    tdt, twdt = getattr(torch, dtype), getattr(torch, wdtype)
    tx, th = (torch.tensor(a).to(tdt).requires_grad_() for a in (x, h))
    tw = torch.tensor(w).to(twdt).requires_grad_()
    y, o = fused_norm.fused_residual_rmsnorm(tx, th, tw, 1e-5)
    assert y.grad_fn is not None and o.grad_fn is not None
    y_ref, o_ref = fused_norm.residual_rmsnorm_ref(tx, th, tw, 1e-5)
    assert torch.equal(y, y_ref) and torch.equal(o, o_ref)
    ((y.float() * torch.tensor(dy)).sum() + (o.float() * torch.tensor(do)).sum()).backward()
    for got, want in zip((tx.grad, th.grad, tw.grad), jg):
        want = np.asarray(want.astype(jnp.float32))
        scale = np.abs(want).max()
        tol = 1e-5 * scale if dtype == wdtype == "float32" else 2 * 2.0 ** -8 * scale
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    assert tx.grad.dtype == tdt and tw.grad.dtype == twdt


def test_k2_without_grad_is_the_plain_call():
    x, h = torch.randn(4, 32), torch.randn(4, 32)
    w = torch.ones(32, requires_grad=True)
    with torch.no_grad():
        y, o = fused_norm.fused_residual_rmsnorm(x, h, w, 1e-5)
    assert y.grad_fn is None and o.grad_fn is None
    y, o = fused_norm.fused_residual_rmsnorm(x, h, w.detach(), 1e-5)
    assert y.grad_fn is None


def test_entry_points_refuse(monkeypatch):
    model = get_model("llama-tiny", device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not split"):
        st = ptrain.init_train_state(model, ptrain.adam(1e-2),
                                     Topology(devices=["cpu"] * 2).mesh({"seq": 2}), device="cpu")
        ptrain.next_token_loss(st.params, torch.zeros((2, 15), dtype=torch.long))
    with pytest.raises(ValueError, match="does not split"):
        ptrain.shard_batch(np.zeros((3, 16), np.int32), Topology(devices=["cpu"] * 2).mesh(
            {"data": 2}))
    q = get_model("llama-tiny", device="cpu")
    q.init_params(torch.Generator().manual_seed(0))
    q.quantize_()
    with pytest.raises(TypeError, match="int8"):
        ptrain.init_train_state(q, ptrain.adam(1e-2), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ptrain.init_train_state(model, ptrain.adam(1e-2))
