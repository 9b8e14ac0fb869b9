"""The port's GPipe schedule (``seldon_core_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``parallel/pipeline.py``, on the CPU: JAX over
its 8 virtual devices (``tests/conftest.py``), the port over co-located
ranks of the same mesh; the same float32 stages (a residual MLP block, the
JAX package's test stage) and inputs from numpy.

- ``pipeline_apply`` on {data, pipe} at (stages, microbatches) (2, 4), (4,
  2), (4, 8): within 1e-5 of JAX's, and bit-equal to the port's stages
  applied in order to the same microbatches;
- its gradients through the schedule within 1e-5 of ``jax.grad`` of JAX's
  pipeline, on {data 1, pipe 2, model 4};
- ``make_pipeline_train_step`` with ``adam(1e-2)``: the loss sequence of 8
  steps within 1e-4 relative of JAX's, and falling;
- the two refusals word for word: a batch that does not divide into the
  microbatches, a stage count that is not the 'pipe' axis's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from seldon_core_tpu.parallel import pipeline as jpipe
from seldon_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seldon_core_tpu_torch.parallel import pipeline as ppipe
from seldon_core_tpu_torch.parallel import train as ptrain
from seldon_core_tpu_torch.parallel.topology import Topology

D = 16


def jax_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def torch_stage(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def _stages(seed, n):
    rng = np.random.default_rng(seed)
    return [{"w1": rng.normal(0, 0.3, size=(D, 32)).astype(np.float32),
             "b1": rng.normal(0, 0.1, size=(32,)).astype(np.float32),
             "w2": rng.normal(0, 0.3, size=(32, D)).astype(np.float32)} for _ in range(n)]


def _meshes(axes, devices):
    jmesh = jax_make_mesh(axes, devices[:8])
    return jmesh, Topology(devices=["cpu"] * 8).mesh(axes)


def _torch_tree(stages):
    return ppipe.stack_stage_params([{k: torch.tensor(v) for k, v in s.items()} for s in stages])


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 2), (4, 8)])
def test_pipeline_equals_jax_and_sequential(n_stages, n_micro, eight_devices):
    jmesh, pmesh = _meshes({"data": -1, "pipe": n_stages}, eight_devices)
    stages = _stages(0, n_stages)
    dp = pmesh.axis_size("data")
    x = np.random.default_rng(1).normal(size=(dp * n_micro * 2, D)).astype(np.float32)
    want = jpipe.pipeline_apply(jax_stage, jpipe.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in stages]), jnp.asarray(x), jmesh,
        n_microbatches=n_micro)
    tx = torch.tensor(x)
    got = ppipe.pipeline_apply(torch_stage, _torch_tree(stages), tx, pmesh,
                               n_microbatches=n_micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    seq = []
    for mb in torch.chunk(tx, dp * n_micro):
        for s in stages:
            mb = torch_stage({k: torch.tensor(v) for k, v in s.items()}, mb)
        seq.append(mb)
    assert torch.equal(got, torch.cat(seq))


def test_pipeline_gradients_equal_jax(eight_devices):
    jmesh, pmesh = _meshes({"data": 1, "pipe": 2, "model": 4}, eight_devices)
    stages = _stages(1, 2)
    x = np.random.default_rng(2).normal(size=(8, D)).astype(np.float32)
    jstacked = jpipe.stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                         for s in stages])
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jpipe.pipeline_apply(
        jax_stage, p, jnp.asarray(x), jmesh, n_microbatches=4) ** 2)))(jstacked)
    tree = _torch_tree(stages)
    for v in tree.values():
        v.requires_grad_(True)
    out = ppipe.pipeline_apply(torch_stage, tree, torch.tensor(x), pmesh, n_microbatches=4)
    (out ** 2).mean().backward()
    for k, v in tree.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrads[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_pipeline_training_equals_jax(eight_devices):
    jmesh, pmesh = _meshes({"data": 2, "pipe": 4}, eight_devices)
    stages = _stages(2, 4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, D)).astype(np.float32)
    y = rng.normal(size=(16, D)).astype(np.float32)

    jparams = jpipe.stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                        for s in stages])
    jtx = optax.adam(1e-2)
    jopt = jtx.init(jparams)
    jstep = jpipe.make_pipeline_train_step(jax_stage, lambda out, b: jnp.mean((out - b["y"]) ** 2),
                                           jtx, jmesh, n_microbatches=4)
    tree = _torch_tree(stages)
    for v in tree.values():
        v.requires_grad_(True)
    ptx = ptrain.adam(1e-2)
    popt = ptx.init(tree)
    pstep = ppipe.make_pipeline_train_step(torch_stage,
                                           lambda out, b: torch.mean((out - b["y"]) ** 2), ptx,
                                           pmesh, n_microbatches=4)
    jlosses, plosses = [], []
    for _ in range(8):
        jparams, jopt, loss = jstep(jparams, jopt, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        jlosses.append(float(loss))
        tree, popt, loss = pstep(tree, popt, {"x": torch.tensor(x), "y": torch.tensor(y)})
        plosses.append(float(loss))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    assert plosses[-1] < plosses[0]


@pytest.mark.parametrize("what", ["batch", "stages"])
def test_refusals_equal_jax(what, eight_devices):
    jmesh, pmesh = _meshes({"data": 2, "pipe": 4}, eight_devices)
    n = 4 if what == "batch" else 2
    stages = _stages(0, n)
    rows = 7 if what == "batch" else 16
    with pytest.raises(ValueError) as jerr:
        jpipe.pipeline_apply(jax_stage, jpipe.stack_stage_params(
            [{k: jnp.asarray(v) for k, v in s.items()} for s in stages]),
            jnp.zeros((rows, D)), jmesh, n_microbatches=4)
    with pytest.raises(ValueError) as perr:
        ppipe.pipeline_apply(torch_stage, _torch_tree(stages), torch.zeros((rows, D)), pmesh,
                             n_microbatches=4)
    assert str(perr.value) == str(jerr.value)
