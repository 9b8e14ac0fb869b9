"""TorchServer: the port's counterpart of the JAX package's ``JAXServer``
(``seldon_core_tpu/servers/jaxserver.py``), selected for
``UnitImplementation.JAX_SERVER`` by ``servers.make_prepackaged_server``.

Checkpoint layout at ``model_uri`` (what the JAX package's
``export_checkpoint(use_orbax=False)`` writes, and this module's
``export_checkpoint`` too):

    config.json     {"model": "<registry name>", "kwargs": {...},
                     "input_shape": [...], "input_dtype": "float32",
                     "class_names": [...]}
    params.msgpack  flax-serialized variables ({"params": ...}, plus
                    "batch_stats" for an unfused ResNet)

Serving path: request ndarray -> cast to ``input_dtype`` -> pad the batch to
its bucket -> the model's forward on ``device`` -> slice back to the true
batch -> host numpy. ``torch_fn`` hands the same forward to the graph
engine, which composes it with its neighbours on the device. For a folded ResNet the forward is
``models/resnet_infer.resnet_serve_forward`` with every identity chain on
the hand-written K3 kernel: ``JAXServer`` serves XLA's graph of the flax
module, and the port, which has no XLA, runs its own eager forward, in
which the kernel is how the chain is computed (``pallas_stages=()`` on the
same weights is the cuDNN chain, the kernel's yardstick).

A mesh (``mesh``, or ``tensor_parallel`` = tp building ``{"data": -1,
"model": tp}`` over ``topology``, default the process topology) shards the
model as ``JAXServer``'s ``shard_apply`` does (``parallel/sharding.py``):
a transformer checkpoint runs the sharded cache-less forward
(``models/sharded.py``); a ResNet declares no logical axes, so it
replicates (``strict_sharding`` then raises, as in the JAX package) and
each 'data' rank runs K3 on its block of the batch, whose buckets round up
to multiples of the 'data' axis; a ViT shards its heads, mlp and classes
over 'model' (``models/vit.ShardedViT``). The mesh's ranks must share the
server's device (two-card meshes: ROADMAP Queue A 9b). The port reads no
orbax checkpoint (the card's machine has no orbax).

Load-time transforms, in ``JAXServer``'s order and with its precedence
(``param_dtype`` from config.json over the constructor's, ``quantize``
from the constructor over config.json's):

- ``param_dtype``: every float32 leaf (biases and running statistics
  included) cast to the dtype, ``"auto"`` meaning the module's compute
  dtype; a float32 target changes nothing;
- ``quantize="int8"``: weight-only int8 of every float leaf of two or more
  dims (``ops/quantize.quantize_params``), after the cast, so a cast leaf's
  ``orig_dtype`` is the cast dtype. Under bf16 compute the products run on
  K4; a folded ResNet keeps its codes on the device and dequantizes them
  into K3's and cuDNN's operands each forward (``models/resnet_infer``).

The MLP and the ViT size some parameters from the input, as flax's
``init`` does from its example: ``load()`` gives them the checkpoint's
``input_shape`` (``size_from_input``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch import storage
from seldon_core_tpu_torch.codec.staging import DEFAULT_BUCKETS, stage_to_device
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.ops.quantize import quantize_params
from seldon_core_tpu_torch.parallel.topology import build_serving_mesh

logger = logging.getLogger(__name__)


class TorchServer(SeldonComponent):
    """One model from a checkpoint directory, served on ``device`` (default
    "cuda": raises without a card; "cpu" only when asked). Constructor
    arguments are ``JAXServer``'s, plus ``device``; ``quantize="int8"``
    and ``param_dtype`` as the module docstring says. Where ``JAXServer``
    runs XLA's graph of the flax module, a folded ResNet here runs the
    port's eager forward with every identity chain on the K3 kernel;
    ``resnet_infer.resnet_serve_forward(module, x, pallas_stages=())`` is
    the same weights through the cuDNN chain."""

    def __init__(
        self,
        model_uri: str = "",
        model: Optional[str] = None,
        mesh: Optional[Any] = None,
        topology: Optional[Any] = None,
        param_sharding_rules: Optional[Any] = None,
        batch_buckets: Optional[Sequence[int]] = None,
        strict_sharding: bool = False,
        tensor_parallel: int = 0,
        quantize: str = "",
        param_dtype: str = "",
        device: Optional[str] = None,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.mesh = mesh
        self.topology = topology
        self.param_sharding_rules = param_sharding_rules
        self.strict_sharding = bool(strict_sharding)
        # spec-reachable: a typed unit parameter builds the ('data', 'model')
        # serving mesh at load()
        self.tensor_parallel = int(tensor_parallel)
        # "int8": weight-only int8 (ops/quantize.py); "auto" or a dtype:
        # the load-time cast of every float32 leaf
        self.quantize = str(quantize or "")
        self.param_dtype = param_dtype
        self.model_name = model
        self.device = resolve_device(device)
        self.batch_buckets = tuple(batch_buckets) if batch_buckets else DEFAULT_BUCKETS
        self.ready = False
        self._module = None
        self._run = None
        self._config: Dict[str, Any] = {}
        self._load_lock = threading.Lock()

    # ------------------------------------------------------------------
    def load(self) -> None:
        """config.json -> ``get_model(name, **kwargs)`` on the device ->
        params.msgpack -> ``params_from_jax``; for a folded model, the
        serving operands are built here, not per request."""
        with self._load_lock:
            if self.ready:
                return
            from seldon_core_tpu_torch.models import get_model
            from seldon_core_tpu_torch.models.checkpoint import load_params
            from seldon_core_tpu_torch.models.convert import params_from_jax

            path = storage.download(self.model_uri)
            cfg_path = os.path.join(path, "config.json")
            if not os.path.exists(cfg_path):
                raise SeldonError(f"TorchServer checkpoint missing config.json at {path}",
                                  status_code=500)
            with open(cfg_path) as f:
                self._config = json.load(f)
            name = self.model_name or self._config["model"]
            self.mesh, self.topology = build_serving_mesh(self.device, self.mesh, self.topology,
                                                          self.tensor_parallel)
            module = get_model(name, device=self.device, **self._config.get("kwargs", {}))
            if hasattr(module, "size_from_input"):
                shape = self._config.get("input_shape")
                if shape is None:
                    raise SeldonError(f"config.json needs input_shape to size {name!r}",
                                      status_code=500)
                module.size_from_input(shape)
            params_from_jax(load_params(path), module)
            param_dtype = self._config.get("param_dtype", self.param_dtype)
            module_dtype = getattr(module, "dtype", None)
            if param_dtype and (param_dtype != "auto" or module_dtype is not None):
                # only "auto" needs the module's compute dtype
                cast_params_(module, param_dtype, module_dtype or torch.float32)
            quantize = self.quantize or self._config.get("quantize", "")
            if quantize:
                if quantize != "int8":
                    raise SeldonError(f"unsupported quantize={quantize!r} (int8 only)",
                                      status_code=500)
                if hasattr(module, "quantize_"):
                    module.quantize_()
                else:
                    quantize_params(module)
            if getattr(module, "fused", False) and hasattr(module, "serving_operands"):
                module.serving_operands(self.device)
            self._apply_kwargs = self._config.get("apply_kwargs", {})
            if self.mesh is not None:
                from seldon_core_tpu_torch.parallel.sharding import shard_apply

                dp = self.mesh.axis_size("data")
                if dp > 1:
                    self.batch_buckets = tuple(sorted({-(-b // dp) * dp
                                                       for b in self.batch_buckets}))
                self._run, module = shard_apply(_apply, module, self.mesh,
                                                rules=self.param_sharding_rules,
                                                strict=self.strict_sharding)
            else:
                self._run = lambda x, **kw: _apply(module, x, **kw)
            self._module = module
            self.ready = True
            logger.info("TorchServer loaded model %s from %s on %s", name, path, self.device)

    # ------------------------------------------------------------------
    def predict(self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
        if not self.ready:
            self.load()
        arr = np.asarray(X)
        if arr.dtype != self.input_dtype:
            arr = arr.astype(self.input_dtype)
        x, true_n = stage_to_device(arr, self.device, pad=True, buckets=self.batch_buckets)
        with torch.no_grad():
            out = self._run(x, **self._apply_kwargs)
        return out[:true_n].float().cpu().numpy()

    def torch_fn(self):
        """The fusion hook (``jax_fn`` of ``JAXServer``): ``(fn, module)``
        where ``fn(module, x)`` is ``predict``'s forward on a float32 tensor
        already on ``device``, without the bucket padding (as ``jax_fn``
        applies the model to the batch it is given): the cast and quantized
        model's too. It records autograd for an ``x`` that requires a
        gradient (``analytics/explainers.SaliencyExplainer``)."""
        if not self.ready:
            self.load()
        apply_kwargs, run = self._apply_kwargs, self._run

        def fn(module, x):
            return run(x, **apply_kwargs)

        return fn, self._module

    def class_names(self):
        return self._config.get("class_names")

    @property
    def input_dtype(self) -> np.dtype:
        """Declared request dtype from the checkpoint config."""
        return np.dtype(self._config.get("input_dtype", "float32"))


@torch.no_grad()
def cast_params_(module: torch.nn.Module, param_dtype: str, module_dtype) -> torch.nn.Module:
    """``JAXServer``'s ``_cast_params`` on a module, in place: every float32
    parameter and BatchNorm running statistic becomes ``param_dtype``
    (``"auto"``: ``module_dtype``, the compute dtype); a float32 target
    changes nothing."""
    from seldon_core_tpu_torch.models.resnet import BatchNorm
    from seldon_core_tpu_torch.models.transformer import to_torch_dtype

    target = to_torch_dtype(module_dtype if param_dtype == "auto" else param_dtype)
    if target == torch.float32:
        return module
    for name, p in list(module.named_parameters()):
        if p.dtype == torch.float32:
            path, _, attr = name.rpartition(".")
            owner = module.get_submodule(path) if path else module
            setattr(owner, attr, torch.nn.Parameter(p.to(target), requires_grad=False))
    for m in module.modules():
        if isinstance(m, BatchNorm):
            for b in ("mean", "var"):
                if getattr(m, b).dtype == torch.float32:
                    setattr(m, b, getattr(m, b).to(target))
    return module


def _apply(module, x, **kwargs):
    """The forward's output (a transformer's logits without its caches)."""
    out = module(x, **kwargs)
    return out[0] if isinstance(out, tuple) else out


def export_checkpoint(
    out_dir: str,
    model: str,
    params: Any,
    kwargs: Optional[Dict[str, Any]] = None,
    input_shape: Optional[Sequence[int]] = None,
    input_dtype: str = "float32",
    apply_kwargs: Optional[Dict[str, Any]] = None,
    class_names: Optional[Sequence[str]] = None,
    use_orbax: bool = False,
) -> str:
    """Write a checkpoint directory ``JAXServer`` and ``TorchServer`` both
    serve: config.json plus params.msgpack in flax's encoding. ``params``
    is a nested dict of arrays or tensors (flax's variables dict). The port
    writes no orbax checkpoint: ``use_orbax=True`` raises."""
    if use_orbax:
        raise NotImplementedError("the port writes no orbax checkpoint (no orbax on the card's "
                                  "machine): use use_orbax=False")
    from seldon_core_tpu_torch.models.checkpoint import dumps

    os.makedirs(out_dir, exist_ok=True)
    cfg: Dict[str, Any] = {"model": model, "kwargs": kwargs or {}, "input_dtype": input_dtype}
    if input_shape is not None:
        cfg["input_shape"] = list(input_shape)
    if apply_kwargs:
        cfg["apply_kwargs"] = apply_kwargs
    if class_names:
        cfg["class_names"] = list(class_names)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as f:
        f.write(dumps(params))
    return out_dir


__all__ = ["TorchServer", "cast_params_", "export_checkpoint"]
