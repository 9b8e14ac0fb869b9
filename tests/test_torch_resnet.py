"""Port of the ResNet family (seldon_core_tpu_torch/models/resnet.py,
resnet_infer.py) held against the JAX package on the CPU.

The fixture is ResNet-18 (the JAX package's bottleneck variant) at 64x64
with 10 classes, its flax init made live: every BatchNorm's scale, bias,
running mean and variance is redrawn from a numpy seed before folding, so
no residual branch is switched off (flax zero-inits each block's last BN
scale, which folds every Conv_2 to zero and makes an identity block the
identity). Both sides get the same weights through numpy.

Tolerance for logits: within FWD_TOL of max|logit| (the two frameworks
round bf16 convolutions' sums in different orders through 8 blocks), top-1
equal in every row whose reference top two are further apart than that.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models.resnet import fold_batchnorm as jax_fold_batchnorm
from seldon_core_tpu.models.resnet import fold_space_to_depth as jax_fold_space_to_depth
from seldon_core_tpu.models.resnet_infer import resnet_serve_forward as jax_serve_forward
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.models.convert import params_from_jax
from seldon_core_tpu_torch.models.resnet import fold_batchnorm, fold_space_to_depth
from seldon_core_tpu_torch.models.resnet_infer import resnet_serve_forward
from seldon_core_tpu_torch.ops import fused_resnet

FWD_TOL = 0.03
STAGES = (2, 2, 2, 2)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def make_live(variables, seed=0):
    """Redraw every BatchNorm's scale, bias, mean and var (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])

    def walk(p, s):
        for k in sorted(p):
            if isinstance(p[k], dict) and "scale" in p[k]:
                n = p[k]["scale"].shape
                p[k] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def rn():
    init_model = jax_get_model("resnet18", num_classes=10)
    raw = jax.jit(init_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    live = make_live(raw)
    folded = to_numpy(jax_fold_batchnorm(live))
    for i in range(sum(STAGES)):  # live residual branches, w3 != 0
        assert np.abs(folded["params"][f"BottleneckBlock_{i}"]["Conv_2"]["kernel"]).max() > 0
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3)).astype(np.float32)
    fused = jax_get_model("resnet18", num_classes=10, fused=True)
    ref_fused = np.asarray(jax.jit(fused.apply)(folded, x))
    ref_unfused = np.asarray(jax.jit(init_model.apply)(live, x))
    return dict(live=live, folded=folded, x=x, ref_fused=ref_fused, ref_unfused=ref_unfused)


def check_logits(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    bound = FWD_TOL * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > bound
    assert np.all((got.argmax(-1) == ref.argmax(-1))[clear])
    return np.abs(got - ref).max()


def port_model(tree, **kw):
    m = get_model("resnet18", num_classes=10, device="cpu", **kw)
    return params_from_jax(tree, m)


def test_fold_batchnorm_matches_jax(rn):
    got = fold_batchnorm(rn["live"])
    want = rn["folded"]
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, leaf in flat_g:
        np.testing.assert_allclose(leaf, flat_w[path], rtol=2e-6, atol=1e-7)


def test_fold_space_to_depth_matches_jax(rn):
    got = fold_space_to_depth(rn["folded"])["params"]["conv_init_s2d"]
    want = to_numpy(jax_fold_space_to_depth(rn["folded"]))["params"]["conv_init_s2d"]
    np.testing.assert_array_equal(got["kernel"], want["kernel"])
    np.testing.assert_array_equal(got["bias"], want["bias"])


@pytest.mark.parametrize("variant", ["unfused", "fused", "fused_s2d"])
def test_forward_matches_jax(rn, variant):
    x = torch.from_numpy(rn["x"])
    if variant == "unfused":
        out = port_model(rn["live"])(x)
        ref = rn["ref_unfused"]
    elif variant == "fused":
        out = port_model(rn["folded"], fused=True)(x)
        ref = rn["ref_fused"]
    else:
        tree = fold_space_to_depth(rn["folded"])
        jm = jax_get_model("resnet18", num_classes=10, fused=True, stem_s2d=True)
        ref = np.asarray(jax.jit(jm.apply)(tree, rn["x"]))
        out = port_model(tree, fused=True, stem_s2d=True)(x)
    assert out.dtype == torch.float32
    check_logits(out.numpy(), ref)


@pytest.mark.parametrize("stages", [(), (0, 1, 2, 3)])
def test_serve_forward_matches_flax_module(rn, stages):
    """The port's resnet_serve_forward, over the folded variables or the
    folded module, equals the flax module on live weights; the K3 stages
    run through the kernel wrapper (its plain version on the CPU)."""
    x = torch.from_numpy(rn["x"])
    before = fused_resnet.fused_identity_chain.launches
    out = resnet_serve_forward(rn["folded"], x, stage_sizes=STAGES, pallas_stages=stages)
    check_logits(out.numpy(), rn["ref_fused"])
    module_out = resnet_serve_forward(port_model(rn["folded"], fused=True), x,
                                      pallas_stages=stages)
    check_logits(module_out.numpy(), rn["ref_fused"])
    assert fused_resnet.fused_identity_chain.launches == before


def test_reference_serve_forward_padding_fault(rn):
    """Pins a fault of the JAX package's resnet_serve_forward: it pads each
    stage's strided 3x3 conv (1, 1) where flax SAME pads (0, 1). On live
    weights it leaves the module beyond the tolerance; the port follows the
    module (JAXServer serves the module)."""
    x = rn["x"]
    jax_serve = np.asarray(jax_serve_forward(rn["folded"], x, stage_sizes=STAGES))
    ref = rn["ref_fused"]
    assert np.abs(jax_serve - ref).max() > 3 * FWD_TOL * np.abs(ref).max()
    out = resnet_serve_forward(rn["folded"], torch.from_numpy(x), stage_sizes=STAGES)
    check_logits(out.numpy(), ref)


def test_params_from_jax_checks_names_and_shapes(rn):
    folded = rn["folded"]
    m = get_model("resnet18", num_classes=10, fused=True, device="cpu")
    extra = {"params": dict(folded["params"], stray={"kernel": np.zeros(3, np.float32)})}
    with pytest.raises(KeyError, match="no counterpart"):
        params_from_jax(extra, m)
    missing = {"params": {k: v for k, v in folded["params"].items() if k != "head"}}
    with pytest.raises(KeyError, match="does not fill"):
        params_from_jax(missing, m)
    bad = {"params": dict(folded["params"], head={"kernel": np.zeros((3, 10), np.float32),
                                                  "bias": np.zeros(10, np.float32)})}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, m)
    unfused = get_model("resnet18", num_classes=10, device="cpu")
    with pytest.raises(KeyError, match="does not fill"):  # no batch_stats
        params_from_jax({"params": rn["live"]["params"]}, unfused)
    with pytest.raises(KeyError, match="collections"):
        params_from_jax(dict(rn["live"], cache={}), unfused)


def test_batch_stats_fill_buffers(rn):
    m = port_model(rn["live"])
    want = rn["live"]["batch_stats"]["BottleneckBlock_3"]["BatchNorm_1"]["var"]
    np.testing.assert_array_equal(m.BottleneckBlock_3.BatchNorm_1.var.numpy(), want)


def test_inference_only_and_option_errors():
    m = get_model("resnet18", num_classes=10, fused=True, device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        m(torch.zeros((1, 32, 32, 3)), train=True)
    with pytest.raises(ValueError, match="stem_s2d"):
        get_model("resnet18", stem_s2d=True, device="cpu")


def test_serving_operands_built_once_and_rebuilt_on_change():
    m = get_model("resnet18", num_classes=10, fused=True, device="cpu")
    m.init_params(torch.Generator().manual_seed(0))
    ops = m.serving_operands("cpu")
    assert m.serving_operands("cpu") is ops
    k3 = ops["blocks"][1]["k3"]
    assert k3["w1"].dtype == torch.bfloat16 and k3["b1"].dtype == torch.float32
    assert k3["w2"].shape == (3, 3, 64, 64) and k3["w2"].is_contiguous()
    assert k3["w3"].abs().max() > 0
    with torch.no_grad():
        m.BottleneckBlock_1.Conv_2.kernel.mul_(2.0)
    assert m.serving_operands("cpu") is not ops


def test_init_params_is_live_and_seeded():
    a = get_model("resnet18", num_classes=10, fused=True, device="cpu")
    b = get_model("resnet18", num_classes=10, fused=True, device="cpu")
    a.init_params(torch.Generator().manual_seed(3))
    b.init_params(torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert all(blk.Conv_2.kernel.abs().max() > 0 for blk in a.blocks())
    out = a(torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(4)))
    assert out.shape == (2, 10) and torch.isfinite(out).all()
