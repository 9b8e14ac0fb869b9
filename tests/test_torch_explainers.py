"""The port's ``SaliencyExplainer`` (``seldon_core_tpu_torch/analytics/
explainers.py``) held against the JAX package's on the CPU, over the same
JAX-written checkpoints and the same seeded inputs, and K3's explicit
backward (``ops/fused_resnet``) against autograd through its plain version.

Attributions are compared by their relative Frobenius distance: the MLP
(float32, no hidden layer) within 1e-5; ``vit-tiny`` in float32 and int8
within 1e-4 (float32 sums in another order through two attention blocks);
a folded bottleneck ResNet in float32 whose identity chains run through
``fused_identity_chain`` (and so through K3's backward) within 1e-3. The
400 errors and ``tags()`` word for word, and the CLI's ``microservice``
serving the explainer by its class path over REST."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.analytics.explainers import SaliencyExplainer as JaxExplainer
from seldon_core_tpu.contracts.payload import SeldonError as JaxError
from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models.resnet import fold_batchnorm as jax_fold_batchnorm
from seldon_core_tpu.servers.jaxserver import export_checkpoint as jax_export
from seldon_core_tpu_torch.analytics.explainers import SaliencyExplainer
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.ops import fused_resnet
from seldon_core_tpu_torch.transport.cli import build_component
from seldon_core_tpu_torch.transport.rest import make_component_app, start

from test_torch_torchserver import _live as live_resnet
from test_torch_torchserver import _post
from test_torch_vit import images, write_ckpt


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def explain_both(path, x, **kw):
    want = JaxExplainer(model_uri=path, **kw).predict(x, [])
    port = SaliencyExplainer(model_uri=path, device="cpu", **kw)
    return port.predict(x, []), want, port


@pytest.mark.parametrize("steps", [1, 8])
def test_mlp_saliency_matches_jax(tmp_path, steps):
    path, _ = write_ckpt(tmp_path / "ckpt", "mlp", "float32", kwargs=dict(features=[]))
    x = images("mlp", n=5)
    got, want, port = explain_both(path, x, steps=steps)
    assert np.abs(want).max() > 0 and rel(got, want) <= 1e-5
    assert port.tags() == JaxExplainer(model_uri=path, steps=steps).tags()
    # a class index as the target, as a unit parameter's string
    got, want, _ = explain_both(path, x, steps=steps, target="2")
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_vit_saliency_matches_jax(tmp_path, quantize):
    extra = dict(quantize=quantize) if quantize else {}
    path, _ = write_ckpt(tmp_path / "ckpt", "vit-tiny", "float32", **extra)
    got, want, _ = explain_both(path, images("vit-tiny"))
    assert np.abs(want).max() > 0 and rel(got, want) <= 1e-4


def _small_resnets():
    """A two-stage bottleneck ResNet (8 filters, two blocks a stage: one
    identity chain each), registered under one name in both packages."""
    from seldon_core_tpu.models.registry import register_model as jax_register
    from seldon_core_tpu.models.resnet import ResNet as JaxResNet
    from seldon_core_tpu_torch.models.registry import register_model
    from seldon_core_tpu_torch.models.resnet import ResNet

    jax_register("resnet-2x2", lambda num_classes=10, dtype="float32", fused=False: JaxResNet(
        stage_sizes=(2, 2), num_classes=num_classes, num_filters=8, dtype=jnp.dtype(dtype),
        fused=fused))
    register_model("resnet-2x2", lambda num_classes=10, dtype="float32", fused=False,
                   device=None: ResNet((2, 2), num_classes=num_classes, num_filters=8,
                                       dtype=dtype, fused=fused, device=device))


def test_folded_resnet_saliency_through_k3_matches_jax(tmp_path, monkeypatch):
    """float32 compute, so the comparison sees the gradient, not bf16
    rounding; each stage's identity chain goes through
    ``fused_identity_chain`` and its backward."""
    _small_resnets()
    kw = {"num_classes": 10, "fused": True, "dtype": "float32"}
    init_model = jax_get_model("resnet-2x2")
    raw = jax.jit(init_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    folded = jax.tree.map(np.asarray, jax_fold_batchnorm(live_resnet(raw)))
    assert all(np.abs(folded["params"][f"BottleneckBlock_{i}"]["Conv_2"]["kernel"]).max() > 0
               for i in range(4))
    jax_export(str(tmp_path / "rn"), "resnet-2x2", folded, kwargs=kw, input_shape=[16, 16, 3],
               use_orbax=False)
    calls = []
    real = fused_resnet.identity_chain_backward
    monkeypatch.setattr(fused_resnet, "identity_chain_backward",
                        lambda *a: calls.append(1) or real(*a))
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(np.float32)
    got, want, _ = explain_both(str(tmp_path / "rn"), x)
    assert len(calls) == 2   # one chain a stage
    assert np.abs(want).max() > 0 and rel(got, want) <= 1e-3


def test_bad_inputs_answer_400_as_jax(tmp_path):
    path, _ = write_ckpt(tmp_path / "ckpt", "mlp", "float32")
    port, jexp = SaliencyExplainer(model_uri=path, device="cpu"), JaxExplainer(model_uri=path)
    for exp, err in ((port, SeldonError), (jexp, JaxError)):
        with pytest.raises(err) as e:
            exp.predict(np.array([["a", "b", "c", "d"]]), [])
        assert e.value.status_code == 400
    assert str(e.value) == "saliency explanations need numeric inputs"
    # a checkpoint that declares integer inputs has no input gradient
    cfg_path = tmp_path / "ckpt" / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg_path.write_text(json.dumps(dict(cfg, input_dtype="int32")))
    msgs = []
    for exp, err in ((SaliencyExplainer(model_uri=path, device="cpu"), SeldonError),
                     (JaxExplainer(model_uri=path), JaxError)):
        with pytest.raises(err) as e:
            exp.predict(np.ones((1, 4)), [])
        assert e.value.status_code == 400
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "saliency needs a float-input model, checkpoint declares int32"


def test_microservice_serves_the_explainer_over_rest(tmp_path, monkeypatch):
    path, _ = write_ckpt(tmp_path / "ckpt", "mlp", "float32")
    monkeypatch.setenv("PREDICTIVE_UNIT_PARAMETERS", json.dumps(
        [{"name": "model_uri", "value": path, "type": "STRING"},
         {"name": "steps", "value": "3", "type": "INT"}]))
    comp = build_component("seldon_core_tpu_torch.analytics.explainers.SaliencyExplainer", "cpu")
    assert isinstance(comp, SaliencyExplainer) and comp.ready and comp.steps == 3
    x = images("mlp", n=2)
    httpd, _ = start(make_component_app(comp, device="cpu"))
    try:
        code, body = _post(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                           json.dumps({"data": {"ndarray": x.tolist()}}).encode())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert code == 200
    want = JaxExplainer(model_uri=path, steps=3).predict(x, [])
    assert rel(np.asarray(body["data"]["ndarray"]), want) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_backward_equals_autograd_through_plain(dtype):
    """K3's Function on a CPU tensor: its forward the plain version, its
    backward ``identity_chain_backward``; on one saved input both equal
    autograd through ``identity_chain_ref``. A weight that asks for a
    gradient raises."""
    g = torch.Generator().manual_seed(0)
    c, f = 16, 8
    blocks = [dict(w1=(torch.randn(c, f, generator=g) / 4).to(dtype),
                   b1=torch.rand(f, generator=g) * 0.1 + 0.05,
                   w2=(torch.randn(3, 3, f, f, generator=g) / 8).to(dtype),
                   b2=torch.randn(f, generator=g) * 0.1,
                   w3=(torch.randn(f, c, generator=g) / 3).to(dtype),
                   b3=torch.randn(c, generator=g) * 0.1) for _ in range(2)]
    x = torch.relu(torch.randn(2, 5, 5, c, generator=g)).to(dtype)
    dy = torch.randn(2, 5, 5, c, generator=g).to(dtype)
    xa = x.clone().requires_grad_()
    y = fused_resnet.fused_identity_chain(xa, blocks)
    assert y.grad_fn is not None and "Differentiable" in type(y.grad_fn).__name__
    (got,) = torch.autograd.grad(y, xa, dy)
    xb = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(fused_resnet.identity_chain_ref(xb, blocks), xb, dy)
    assert torch.equal(got, want) and got.abs().max() > 0
    torch.testing.assert_close(y, fused_resnet.identity_chain_ref(x, blocks), rtol=0, atol=0)
    with torch.no_grad():
        assert fused_resnet.fused_identity_chain(xa, blocks).grad_fn is None
    blocks[1]["b3"].requires_grad_()
    with pytest.raises(ValueError, match="not trained"):
        fused_resnet.fused_identity_chain(xa, blocks)
