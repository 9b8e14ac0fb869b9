"""The training step: loss, gradients and an AdamW or Adam update, over a
co-located mesh or on one device.

Port of ``seldon_core_tpu/parallel/train.py``. The JAX package jits an
optax step over a ``jax.sharding.Mesh`` and leaves the collectives to
GSPMD. The port trains a ``Transformer`` (``models/transformer.py``) or,
over a mesh, its ``ShardedTransformer`` (``models/sharded.py``), whose
cache-less ``train_blocks`` runs the rank loop under ``TRAIN_RULES``: rows
over 'data', positions over 'seq', heads / mlp / vocab over 'model',
experts over 'expert'. Autograd differentiates that loop; the collectives
are ordinary tensor work on the one device, so their transposes come with
it. A shard that several ranks hold is one ``nn.Parameter``, so its
partial gradients accumulate into one gradient and one update keeps every
copy equal.

What changes with the framework:

- ``TrainState.params`` is the module being trained (its parameters, or
  its shards, are the leaves), and the step updates it and the optimizer's
  moments in place, where the JAX package donated the state's buffers to
  the jitted step and got new ones back. The step returns the state with
  ``step`` one higher.
- The optimizers are ``adamw`` and ``adam``, the counterparts of the two
  optax transforms the JAX package and its tests use, with optax's
  defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0; ``adamw``'s weight
  decay 1e-4 on every leaf) and optax's order of operations, in float32.
  The learning rate (and adamw's decay) are the settings; the rest are
  optax's defaults as constants.
- ``next_token_loss`` is the loss itself, ``loss_fn(params, tokens)``: the
  mean cross-entropy of the logits at t against the token at t + 1. Over
  'seq' a rank's last position takes its target from the next rank's
  first token: the targets are cut from the whole batch, not the rank's.
- ``grad_norm`` is ``optax.global_norm`` of the logical gradients: each
  leaf counted once, not once a copy.
- Checkpoints: the card's machine has no orbax, so ``save_train_state``
  writes one file of its own (``torch.save`` of the step, the logical
  leaves and the optimizer's moments, read back with ``weights_only``), and
  ``restore_train_state`` places each leaf straight into the mesh's ranks.
- Every entry point takes ``device``, default ``"cuda"``, and raises
  without a card; the model must already lie on that device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.parallel.mesh import same_device

# The JAX package's training rule table (a copy): unlike serving, training
# shards activations along the sequence axis too.
TRAIN_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "data"),
    ("seq", "seq"),
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("expert", "expert"),
)

CHECKPOINT_FORMAT = "seldon_core_tpu_torch.train_state/1"


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module
    opt_state: Any


# ----------------------------------------------------------------- optimizers
class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the first and
    second moments, one tensor a trained tensor."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def _flat(tree) -> List[torch.Tensor]:
    """The tensors of a list, or of a (nested) dict in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _flat(v)]


# optax's adam / adamw defaults (eps_root 0: the square root of nu_hat itself)
B1, B2, EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return float(1.0 - torch.tensor(decay, dtype=torch.float32) ** count)


class Adam:
    """optax's ``adam`` (``weight_decay=None``) or ``adamw``, at optax's
    defaults (``B1``, ``B2``, ``EPS``): ``init(params)`` and
    ``update(grads, state, params) -> (updates, state)``, then
    ``apply_updates``. Params and grads are lists of tensors (or a dict of
    them, taken in its order). Per tensor, in optax's order: mu = (1 - b1) g
    + b1 mu; nu = (1 - b2) g^2 + b2 nu; count + 1; the update is -lr (mu_hat
    / (sqrt(nu_hat) + eps) + weight_decay * p) with mu_hat = mu / (1 -
    b1^count), nu_hat likewise. The moments are updated in place (the
    returned state holds the same tensors), one tensor at a time: beside
    the returned updates, the temporaries are one leaf's."""

    def __init__(self, learning_rate: float, weight_decay: Optional[float] = None):
        self.learning_rate = float(learning_rate)
        self.weight_decay = weight_decay

    def init(self, params) -> AdamState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in _flat(params)]
        return AdamState(0, zeros, [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> Tuple[List[torch.Tensor], AdamState]:
        count = state.count + 1
        bc1, bc2 = _bias_correction(B1, count), _bias_correction(B2, count)
        updates = []
        for g, mu, nu, p in zip(_flat(grads), state.mu, state.nu, _flat(params)):
            g = g.float()
            mu.mul_(B1).add_((1.0 - B1) * g)
            nu.mul_(B2).add_((1.0 - B2) * g.square())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.weight_decay is not None:
                u = u + self.weight_decay * p.float()
            updates.append(u * -self.learning_rate)
        return updates, AdamState(count, state.mu, state.nu)


def adam(learning_rate: float) -> Adam:
    """optax's ``adam`` with its defaults."""
    return Adam(learning_rate)


def adamw(learning_rate: float, weight_decay: float = 1e-4) -> Adam:
    """optax's ``adamw`` with its defaults: weight decay 1e-4 on every leaf
    (``torch.optim.AdamW``'s default is 0.01)."""
    return Adam(learning_rate, weight_decay)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """optax's ``apply_updates``, in place: each param += its update (cast
    to the param's dtype)."""
    for p, u in zip(_flat(params), _flat(updates)):
        p.add_(u.to(p.dtype))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: sqrt of the sum of squares over every
    tensor, in float32."""
    return torch.sqrt(sum((t.float().square().sum() for t in tensors),
                          torch.zeros((), dtype=torch.float32, device=tensors[0].device)))


# ------------------------------------------------------------------ the model
def trained_tensors(params: nn.Module) -> List[Tuple[str, torch.Tensor, Tuple[slice, ...]]]:
    """Every trained tensor of ``params``: (its logical leaf's name, the
    tensor, its index in the leaf). A ``Transformer``'s parameters are
    whole leaves; a ``ShardedTransformer``'s are its distinct shards
    (``leaf_shards``)."""
    if hasattr(params, "leaf_shards"):
        return [(name, t, index) for name, shards in params.leaf_shards().items()
                for t, index in shards]
    return [(name, p, (slice(None),) * p.dim()) for name, p in params.named_parameters()]


def _check_float(model: nn.Module) -> None:
    from seldon_core_tpu_torch.ops.quantize import QuantizedTensor

    if any(isinstance(m, QuantizedTensor) for m in model.modules()):
        raise TypeError("the model holds int8 weights (quantize_): only a float model trains")


def next_token_loss(params: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """The causal LM loss of the module ``params`` (a ``Transformer``, or a
    ``ShardedTransformer`` through ``train_blocks``) on ``tokens`` [b, s]:
    the mean over b * (s - 1) of the float32 cross-entropy of the logits at
    t against the token at t + 1. A block of positions [p0, p1) takes its
    targets from ``tokens[:, p0 + 1:p1 + 1]``, the next block's first token
    included; the last position has none."""
    b, s = tokens.shape
    if hasattr(params, "train_blocks"):
        blocks = params.train_blocks(tokens)
    else:
        blocks = [(slice(None), slice(0, s), params(tokens)[0])]
    total = None
    for rows, cols, logits in blocks:
        n = min(cols.stop, s - 1) - cols.start   # positions that have a target
        if n <= 0:
            continue
        targets = tokens[rows, cols.start + 1:cols.start + 1 + n].long()
        part = F.cross_entropy(logits[:, :n].reshape(-1, logits.shape[-1]).float(),
                               targets.reshape(-1), reduction="sum")
        total = part if total is None else total + part
    return total / (b * (s - 1))


def init_train_state(model: nn.Module, tx: Adam, mesh=None, seed: Optional[int] = None,
                     device=None) -> TrainState:
    """The training state of ``model`` (a float ``Transformer`` on
    ``device``): with ``seed``, its weights drawn first
    (``Transformer.init_params``); over ``mesh`` (co-located on
    ``device``), its leaves cut into the ranks by ``TRAIN_RULES`` (the
    model itself is left as it was); then every trained tensor set to require
    gradients, the module to training mode, and the optimizer's state made
    (the moments' placement the params')."""
    dev = resolve_device(device)
    _check_float(model)
    off = sorted({str(p.device) for p in model.parameters() if not same_device(p.device, dev)})
    if off:
        raise ValueError(f"the model's parameters lie on {off}, not on the device {dev}")
    if seed is not None:
        model.init_params(torch.Generator(device=dev).manual_seed(int(seed)))
    params = model
    if mesh is not None:
        mesh.require_colocated(dev)
        params = model.shard(mesh, TRAIN_RULES)
    params.requires_grad_(True)
    params.train()
    return TrainState(0, params, tx.init([t for _, t, _ in trained_tensors(params)]))


def make_train_step(tx: Adam, loss_fn: Optional[Callable] = None
                    ) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, Dict[str, Any]]]:
    """``run(state, tokens) -> (state, {"loss", "grad_norm"})``: the loss
    (``loss_fn(params, tokens)``, default ``next_token_loss``) and its
    gradients by autograd, the optimizer's update applied in place, the
    global norm of the gradients, ``step`` one higher. The metrics are
    float32 tensors on the device (read them when the host needs them)."""
    loss_fn = loss_fn or next_token_loss

    def run(state: TrainState, tokens: torch.Tensor):
        tensors = [t for _, t, _ in trained_tensors(state.params)]
        loss = loss_fn(state.params, tokens)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, grads)]
        updates, opt_state = tx.update(grads, state.opt_state, tensors)
        apply_updates(tensors, updates)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return run


def shard_batch(tokens, mesh, batch_axis: str = "data", seq_axis: str = "seq") -> torch.Tensor:
    """``tokens`` [batch, seq] as a tensor on the mesh's device, checked to
    split over ``batch_axis`` and ``seq_axis`` where the mesh has them (the
    rank loop cuts each rank's block from it)."""
    mesh.require_colocated()
    t = torch.as_tensor(tokens, device=mesh.rank_devices()[0])
    for dim, axis in ((0, batch_axis), (1, seq_axis)):
        n = mesh.axis_size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"tokens of shape {tuple(t.shape)}: dim {dim} does not split over "
                             f"the {n} '{axis}' ranks")
    return t


# ----------------------------------------------------------------- checkpoints
def logical_leaves(shards, tensors) -> Dict[str, torch.Tensor]:
    """``{leaf name: the whole leaf on the CPU}`` put together from
    ``tensors``, one at each place of ``shards`` (``trained_tensors``): the
    params themselves, their gradients, or a moment of the optimizer."""
    out: Dict[str, torch.Tensor] = {}
    parts: Dict[str, list] = {}
    for (name, _, index), t in zip(shards, tensors):
        parts.setdefault(name, []).append((index, t))
    for name, group in parts.items():
        t0 = group[0][1]
        shape = [max((ix[d].stop if ix[d].stop is not None else t.shape[d]) for ix, t in group)
                 for d in range(t0.dim())]
        leaf = torch.empty(shape, dtype=t0.dtype)
        for index, t in group:
            leaf[index] = t.detach().cpu()
        out[name] = leaf
    return out


def save_train_state(state: TrainState, path: str, overwrite: bool = True) -> str:
    """Write ``state`` to the file ``path``: its step, the logical leaves
    (each put together from its shards) and the optimizer's count and
    moments, the same way. ``overwrite=False`` refuses an existing path."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists (overwrite=False)")
    shards = trained_tensors(state.params)
    opt = state.opt_state
    blob = {"format": CHECKPOINT_FORMAT, "step": int(state.step), "count": int(opt.count),
            "leaves": logical_leaves(shards, [t for _, t, _ in shards]),
            "mu": logical_leaves(shards, opt.mu), "nu": logical_leaves(shards, opt.nu)}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(path: str, model: nn.Module, tx: Adam, mesh=None,
                        device=None) -> TrainState:
    """The state ``save_train_state`` wrote, on ``model`` over ``mesh``:
    ``init_train_state`` builds the placement (the model's values are
    overwritten), then each shard is copied from its slice of the saved
    leaf, and the moments likewise."""
    blob = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if blob.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path}: not a training state of this format ({blob.get('format')!r})")
    state = init_train_state(model, tx, mesh, device=device)
    shards = trained_tensors(state.params)
    opt = state.opt_state
    with torch.no_grad():
        for i, (name, t, index) in enumerate(shards):
            for dst, src in ((t, blob["leaves"]), (opt.mu[i], blob["mu"]), (opt.nu[i], blob["nu"])):
                dst.copy_(src[name][index])
    return TrainState(blob["step"], state.params, AdamState(blob["count"], opt.mu, opt.nu))


__all__ = ["Adam", "AdamState", "B1", "B2", "EPS", "CHECKPOINT_FORMAT", "TRAIN_RULES", "TrainState", "adam",
           "adamw", "apply_updates", "global_norm", "init_train_state", "logical_leaves",
           "make_train_step", "next_token_loss", "restore_train_state", "save_train_state", "shard_batch",
           "trained_tensors"]
