"""Pipeline parallelism over the 'pipe' mesh axis: the GPipe schedule.

Port of ``seldon_core_tpu/parallel/pipeline.py``. Layers are grouped into S
stages, one a rank along 'pipe'; the batch splits into M microbatches; at
step t of the M + S - 1 steps, stage s runs its layers on the microbatch it
holds (t - s, where 0 <= t - s < M) and hands the activation to stage s + 1.
The JAX package runs every stage every step under ``shard_map`` + ``scan``
and masks the idle ones out; the port's single controller runs only the
stages that hold a microbatch, in the same schedule, so the result is the
stages applied one after another to the same microbatches, bit for bit.

On a co-located mesh (every rank on one device) the hop to the next stage
is a copy on that device. The backward is autograd through the schedule
(the JAX package's is ``jax.grad`` of it): ``make_pipeline_train_step``
differentiates the pipelined forward.

Composes with data parallelism: the batch's rows split over 'data' into
contiguous blocks, and each block runs its own pipeline.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from seldon_core_tpu_torch.parallel.train import _flat, apply_updates


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(per_stage_params: list) -> Any:
    """[S] list of per-stage trees (dicts of tensors) -> one tree whose
    leaves carry a leading stage dim."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor, mesh,
                   n_microbatches: int, axis: str = "pipe", data_axis: str = "data"):
    """Run S pipeline stages over the batch.

    stage_fn(params, x) -> y with y.shape == x.shape (stages keep the
    activation's shape); stage_params: a tree whose leaves have a leading
    dim S (``stack_stage_params``); x: [B, ...], B divisible into
    n_microbatches per data shard. Returns [B, ...]: the stages applied in
    order to each microbatch, bit for bit."""
    S = dict(mesh.shape)[axis]
    M = int(n_microbatches)
    dp = dict(mesh.shape).get(data_axis, 1)
    if x.shape[0] % (M * dp):
        raise ValueError(
            f"batch {x.shape[0]} must divide into {M} microbatches per "
            f"{dp} data shard(s)"
        )
    n_stages = _flat(stage_params)[0].shape[0]
    if n_stages != S:
        # a mismatch that still divides would silently run a subset of stages
        raise ValueError(
            f"stage_params has {n_stages} stages but the '{axis}' axis has "
            f"{S} devices (one stage per device)"
        )
    mesh.require_colocated()
    per_stage = [_tree_map(lambda a, s=s: a[s], stage_params) for s in range(S)]
    outs = []
    for x_local in torch.chunk(x, dp, dim=0):
        xs = torch.chunk(x_local, M, dim=0)
        held: Dict[int, torch.Tensor] = {}     # stage -> the activation it received
        done = [None] * M
        for t in range(M + S - 1):
            sent = {}
            for s in range(S):
                if not 0 <= t - s < M:
                    continue
                y = stage_fn(per_stage[s], xs[t] if s == 0 else held[s])
                if s == S - 1:
                    done[t - s] = y.to(x.dtype)
                else:
                    sent[s + 1] = y.clone()        # the hop to the next stage
            held = sent
        outs.append(torch.cat(done, dim=0))
    return torch.cat(outs, dim=0)


def make_pipeline_train_step(stage_fn: Callable, loss_fn: Callable, tx, mesh,
                             n_microbatches: int, axis: str = "pipe"):
    """Pipeline-parallel training: the gradient of the pipelined forward.
    ``loss_fn(outputs, batch) -> scalar``. Returns ``run(params, opt_state,
    batch) -> (params, opt_state, loss)``; ``params`` is the stage-stacked
    tree (its leaves requiring gradients), updated in place with the
    optimizer's moments."""

    def run(params, opt_state, batch):
        leaves = _flat(params)
        out = pipeline_apply(stage_fn, params, batch["x"], mesh, n_microbatches, axis=axis)
        loss = loss_fn(out, batch)
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = tx.update(grads, opt_state, leaves)
        apply_updates(leaves, updates)
        return params, opt_state, loss.detach()

    return run


__all__ = ["make_pipeline_train_step", "pipeline_apply", "stack_stage_params"]
