"""The port's ring attention (``seldon_core_tpu_torch/ops/ring_attention.py``)
against the JAX package's ``ring_attention``, on the CPU: JAX's with no
mesh and under ``shard_map`` over 'seq' 2 and 4 of its 8 virtual devices
(``tests/conftest.py``), the port's over co-located ranks of the same
shape; the same float32 inputs from numpy.

- causal and not; GQA (h 4, kvh 2: only the unrepeated K/V ride the ring);
  one row whose query attends nothing (its output zeros): the output within
  1e-5 of JAX's, and its q / k / v gradients (of a fixed random weighting
  of the output) within 1e-5 of ``jax.grad``'s;
- the port's mesh path equals its own one-block path (the ring is exact);
- a mesh whose 'seq' does not split the positions raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from seldon_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seldon_core_tpu_torch.ops.ring_attention import ring_attention
from seldon_core_tpu_torch.parallel.topology import Topology

B, S, H, KVH, D = 2, 16, 4, 2, 8
MESHES = {"none": None, "seq2": {"data": 2, "seq": 2, "model": 2}, "seq4": {"seq": 4, "model": 2}}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KVH, D)).astype(np.float32) for _ in range(2))
    qpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kvpos = qpos.copy()
    kvpos[0] += 1          # row 0's query at position 0 sees no key: a fully masked row
    w = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, qpos, kvpos, w


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ring_attention_and_grads_equal_jax(mesh, causal, eight_devices):
    q, k, v, qpos, kvpos, w = _inputs(len(mesh) + causal)
    axes = MESHES[mesh]
    jmesh = None if axes is None else jax_make_mesh(axes, eight_devices[:int(np.prod(
        list(axes.values())))])
    pmesh = None if axes is None else Topology(devices=["cpu"] * 8).mesh(axes)

    def jloss(q, k, v):
        out = jax_ring_attention(q, k, v, jnp.asarray(qpos), jnp.asarray(kvpos), mesh=jmesh,
                                 causal=causal)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ring_attention(tq, tk, tv, torch.tensor(qpos), torch.tensor(kvpos), mesh=pmesh,
                         causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    if causal:
        assert np.all(out.detach().numpy()[0, 0] == 0)   # the fully masked row
    (out * torch.tensor(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_mesh_ring_equals_one_block():
    q, k, v, qpos, kvpos, _ = _inputs(9)
    args = [torch.tensor(a) for a in (q, k, v, qpos, kvpos)]
    one = ring_attention(*args)
    for axes in MESHES.values():
        if axes is not None:
            ring = ring_attention(*args, mesh=Topology(devices=["cpu"] * 8).mesh(axes))
            torch.testing.assert_close(ring, one, rtol=0, atol=1e-6)


def test_positions_that_do_not_split_raise():
    q, k, v, qpos, kvpos, _ = _inputs(3)
    args = [torch.tensor(a)[:, :S - 1] for a in (q, k, v, qpos, kvpos)]
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(*args, mesh=Topology(devices=["cpu"] * 2).mesh({"seq": 2}))
