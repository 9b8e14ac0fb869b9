"""The port's VAE, seq2seq and isolation-forest detectors
(``seldon_core_tpu_torch/analytics/outliers.py``) and its copy of JAX's
Threefry normal (``analytics/threefry.py``) held against the JAX package
on the CPU, on the same seeded numpy inputs.

Tolerances: the random words bit for bit; the normals within 4 float32
ulps (XLA's ``log1p`` and fused multiply-adds round differently from
numpy's, observed at most 3); scores on JAX-fitted params converted with
``detector_params_from_jax`` within 1e-5 relative (float32 products in
another order); one training step's loss and updated params within 1e-5
relative (1e-6 absolute for params near zero); the isolation forest's
scores equal to 1e-12 (the same sklearn forest on the same data)."""

import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from seldon_core_tpu.analytics import IsolationForestOutlierDetector as JaxForest
from seldon_core_tpu.analytics import Seq2SeqOutlierDetector as JaxSeq2Seq
from seldon_core_tpu.analytics import VAEOutlierDetector as JaxVAE
from seldon_core_tpu_torch.analytics import threefry
from seldon_core_tpu_torch.analytics.outliers import (IsolationForestOutlierDetector,
                                                      Seq2SeqOutlierDetector, VAEOutlierDetector,
                                                      detector_params_from_jax, seq2seq_loss,
                                                      train_step, vae_loss)
from seldon_core_tpu_torch.parallel.train import adam


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def assert_rel(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def np_params(det):
    return jax.tree.map(np.asarray, det._params)


@pytest.fixture(scope="module")
def fitted_vae():
    rng = np.random.default_rng(0)
    det = JaxVAE(hidden_dim=16, latent_dim=2, seed=3).fit(rng.normal(size=(64, 4)), epochs=20)
    return det


@pytest.fixture(scope="module")
def fitted_seq2seq():
    rng = np.random.default_rng(1)
    return JaxSeq2Seq(timesteps=4, hidden_dim=8, seed=2).fit(rng.normal(size=(48, 3)),
                                                            epochs=20)


@pytest.mark.parametrize("shape", [(1, 2), (8, 2), (257, 2), (5, 16)])
def test_threefry_normal_matches_jax(shape):
    key = jax.random.PRNGKey(0)
    np.testing.assert_array_equal(threefry.random_bits(threefry.key_of_seed(0), shape),
                                  np.asarray(jax.random.bits(key, shape)))
    want = np.asarray(jax.random.normal(key, shape))
    got = threefry.normal(0, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert ulps(got, want).max() <= 4
    # another key: the words of seed 7
    np.testing.assert_array_equal(threefry.random_bits(threefry.key_of_seed(7), shape),
                                  np.asarray(jax.random.bits(jax.random.PRNGKey(7), shape)))


def test_vae_scores_match_jax(fitted_vae):
    port = VAEOutlierDetector(hidden_dim=16, latent_dim=2, device="cpu").adopt(
        detector_params_from_jax(np_params(fitted_vae)))
    rng = np.random.default_rng(5)
    for rows in (1, 9, 33):
        x = rng.normal(size=(rows, 4))
        assert_rel(port.score(x), fitted_vae.score(x))
    # the eps the port draws is JAX's normal of PRNGKey(0), row for row
    assert ulps(port.score_eps(9).numpy(),
                np.asarray(jax.random.normal(jax.random.PRNGKey(0), (9, 2)))).max() <= 4


def test_vae_eps_fault_pinned_in_both_packages(fitted_vae):
    """ROADMAP Queue C: the score samples z with a fixed key, so row 3's
    score depends on its index in the batch: solo differs from its place
    in a batch of 8, in each package, and the packages agree both ways."""
    port = VAEOutlierDetector(hidden_dim=16, latent_dim=2, device="cpu").adopt(
        detector_params_from_jax(np_params(fitted_vae)))
    x = np.random.default_rng(9).normal(size=(8, 4))
    for det in (fitted_vae, port):
        solo, batch = det.score(x[3:4])[0], det.score(x)[3]
        assert abs(solo - batch) > 1e-4 * abs(batch)
    assert_rel(port.score(x[3:4]), fitted_vae.score(x[3:4]))
    assert_rel(port.score(x), fitted_vae.score(x))


def test_seq2seq_scores_match_jax(fitted_seq2seq):
    port = Seq2SeqOutlierDetector(timesteps=4, hidden_dim=8, device="cpu").adopt(
        detector_params_from_jax(np_params(fitted_seq2seq)))
    rng = np.random.default_rng(6)
    for x in (rng.normal(size=(13, 3)), rng.normal(size=(4, 3)), rng.normal(size=(5, 4, 3))):
        assert_rel(port.score(x), fitted_seq2seq.score(x))
    batches = [rng.normal(size=(r, 3)) for r in (6, 9)]
    for det in (port, fitted_seq2seq):
        det.stack_segments([6, 9])
    assert_rel(port.score(np.concatenate(batches)), fitted_seq2seq.score(np.concatenate(batches)))


def _jax_step(module, loss_fn, params, lr, *inputs):
    """The JAX package's jitted fit step, rebuilt around its module: two
    optax adam steps; the loss before each."""
    tx = optax.adam(lr)

    @jax.jit
    def step(params, opt, *inputs):
        loss, grads = jax.value_and_grad(loss_fn)(params, *inputs)
        updates, opt = tx.update(grads, opt)
        return optax.apply_updates(params, updates), opt, loss

    opt = tx.init(params)
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, *inputs)
        losses.append(float(loss))
    return params, losses


def _port_step(port, loss_fn, lr, *inputs):
    net = port._ready()
    tx = adam(lr)
    opt = tx.init(list(net.parameters()))
    losses = []
    for _ in range(2):
        opt, loss = train_step(net, tx, opt, loss_fn, *inputs)
        losses.append(float(loss))
    return {k: v.detach().numpy() for k, v in net.state_dict().items()}, losses


def _assert_params(got, want_tree):
    want = detector_params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_rel(got[k], want[k], atol=1e-6)


def test_vae_train_step_matches_jax(fitted_vae):
    module = fitted_vae._module(4)
    params = fitted_vae._params
    x = np.random.default_rng(11).normal(size=(16, 4)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    kl_weight = 1e-3

    def loss_fn(params, x, rng):  # the JAX package's loss (analytics/outliers.py)
        recon, mu, logvar = module.apply(params, x, rng)
        mse = jnp.mean(jnp.sum((recon - x) ** 2, axis=-1))
        kl = -0.5 * jnp.mean(jnp.sum(1 + logvar - mu**2 - jnp.exp(logvar), axis=-1))
        return mse + kl_weight * kl

    want, want_losses = _jax_step(module, loss_fn, params, 1e-3, jnp.asarray(x), rng)
    eps = torch.from_numpy(np.array(jax.random.normal(rng, (16, 2))))
    port = VAEOutlierDetector(hidden_dim=16, latent_dim=2, device="cpu").adopt(
        detector_params_from_jax(np_params(fitted_vae)))
    got, losses = _port_step(port, vae_loss, 1e-3, torch.from_numpy(x), eps, kl_weight)
    assert_rel(losses, want_losses)
    _assert_params(got, want)


def test_seq2seq_train_step_matches_jax(fitted_seq2seq):
    module = fitted_seq2seq._module(3)
    windows = np.random.default_rng(12).normal(size=(6, 4, 3)).astype(np.float32)

    def loss_fn(params, x):
        return jnp.mean((module.apply(params, x) - x) ** 2)

    want, want_losses = _jax_step(module, loss_fn, fitted_seq2seq._params, 1e-2,
                                  jnp.asarray(windows))
    port = Seq2SeqOutlierDetector(timesteps=4, hidden_dim=8, device="cpu").adopt(
        detector_params_from_jax(np_params(fitted_seq2seq)))
    got, losses = _port_step(port, seq2seq_loss, 1e-2, torch.from_numpy(windows))
    assert_rel(losses, want_losses)
    _assert_params(got, want)


def test_port_fit_flags_planted_outliers():
    """The port's own fits (init and eps from torch.Generator(seed)):
    planted rows at 8 sigma score above every clean row; a second fit with
    the same seed is bit-equal."""
    rng = np.random.default_rng(2)
    clean = rng.normal(size=(128, 4)).astype(np.float32)
    planted = clean[:4] + 8.0
    for make in (lambda: VAEOutlierDetector(hidden_dim=16, seed=1, device="cpu").fit(
                     clean, epochs=60, lr=1e-2),
                 lambda: Seq2SeqOutlierDetector(timesteps=4, hidden_dim=8, seed=1,
                                                device="cpu").fit(clean, epochs=30)):
        det = make()
        s_clean = det.score(clean[4:])
        s_out = det.score(np.concatenate([planted, clean[4:]]))[:4]
        assert s_out.min() > s_clean.max()
        np.testing.assert_array_equal(make().score(clean[:8]), det.score(clean[:8]))


def test_isolation_forest_matches_jax():
    rng = np.random.default_rng(4)
    train = rng.normal(size=(200, 3))
    x = np.concatenate([rng.normal(size=(8, 3)), rng.normal(size=(2, 3)) + 6.0])
    want = JaxForest(n_estimators=20, seed=5).fit(train)
    got = IsolationForestOutlierDetector(n_estimators=20, seed=5).fit(train)
    np.testing.assert_allclose(got.score(x), want.score(x), rtol=0, atol=1e-12)
    got.transform_input(x, [])
    want.transform_input(x, [])
    assert got.tags() == want.tags() and got.tags()["is_outlier"][-2:] == [1, 1]


def test_isolation_forest_names_missing_sklearn(monkeypatch, tmp_path):
    """The card's machine has neither sklearn nor joblib: fit() and load()
    raise naming them, and an unfitted score says what it needs."""
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    monkeypatch.setitem(sys.modules, "joblib", None)
    det = IsolationForestOutlierDetector()
    with pytest.raises(ImportError, match="sklearn"):
        det.fit(np.zeros((4, 2)))
    with pytest.raises(ImportError, match="joblib"):
        IsolationForestOutlierDetector(model_uri=str(tmp_path)).load()
    with pytest.raises(RuntimeError, match="needs fit"):
        det.score(np.zeros((1, 2)))


def test_seq2seq_stacked_matches_solo():
    """As the JAX package's test: per-segment framing makes a stacked call
    score each request's rows as its solo call does, within 4 float32 ulps
    (another batch size, another order of float32 sums); the segment list
    is consumed once."""
    rng = np.random.default_rng(11)
    det = Seq2SeqOutlierDetector(timesteps=4, hidden_dim=8, seed=1, device="cpu")
    det.fit(rng.normal(size=(40, 3)), epochs=10)
    batches = [rng.normal(size=(r, 3)) for r in (6, 4, 9, 1)]
    solo = [det.score(b) for b in batches]
    det.stack_segments([b.shape[0] for b in batches])
    stacked = det.score(np.concatenate(batches, axis=0))
    off = 0
    for b, s in zip(batches, solo):
        got = stacked[off:off + b.shape[0]]
        assert got.shape == s.shape and ulps(got, s).max() <= 4
        off += b.shape[0]
    plain = det.score(np.concatenate(batches, axis=0))
    assert np.max(np.abs(plain - stacked) / np.abs(stacked)) > 1e-4


def test_seq2seq_stale_segment_counts_fall_back_to_solo():
    rng = np.random.default_rng(3)
    det = Seq2SeqOutlierDetector(timesteps=4, hidden_dim=8, seed=1, device="cpu")
    det.fit(rng.normal(size=(16, 2)), epochs=5)
    X = rng.normal(size=(8, 2))
    want = det.score(X)
    det.stack_segments([3, 3])  # sums to 6 != 8
    np.testing.assert_array_equal(det.score(X), want)


def test_seq2seq_save_load_roundtrip(tmp_path):
    """fit -> save() -> load() via model_uri through the port's storage:
    the adopted detector scores identically; an unfitted pickle and a JAX
    package pickle are refused."""
    rng = np.random.default_rng(7)
    det = Seq2SeqOutlierDetector(timesteps=4, hidden_dim=8, seed=2, threshold=0.4, device="cpu")
    det.fit(rng.normal(size=(24, 3)), epochs=5)
    det.save(str(tmp_path / "fitted"))
    served = Seq2SeqOutlierDetector(model_uri=f"file://{tmp_path / 'fitted'}", device="cpu")
    served.load()
    assert served.threshold == det.threshold
    X = rng.normal(size=(9, 3))
    np.testing.assert_array_equal(served.score(X), det.score(X))
    with open(tmp_path / "detector.pkl", "wb") as f:
        pickle.dump(Seq2SeqOutlierDetector(device="cpu"), f)
    with pytest.raises(RuntimeError, match="fitted"):
        Seq2SeqOutlierDetector(model_uri=str(tmp_path), device="cpu").load()
    jax_dir = tmp_path / "jax"
    JaxSeq2Seq(timesteps=4, hidden_dim=8).fit(rng.normal(size=(8, 3)), epochs=1).save(
        str(jax_dir))
    with pytest.raises(RuntimeError, match="does not contain"):
        Seq2SeqOutlierDetector(model_uri=str(jax_dir), device="cpu").load()


def test_vae_pickles_as_numpy(fitted_vae):
    port = VAEOutlierDetector(hidden_dim=16, latent_dim=2, device="cpu").adopt(
        detector_params_from_jax(np_params(fitted_vae)))
    x = np.random.default_rng(8).normal(size=(5, 4))
    want = port.score(x)
    state = port.__getstate__()
    assert state["_net"] is None and "_eps" not in state
    assert all(isinstance(v, np.ndarray) for v in state["_params"].values())
    np.testing.assert_array_equal(pickle.loads(pickle.dumps(port)).score(x), want)
    port.transform_input(x, [])
    assert port.tags()["outlier_score"] == [float(s) for s in want]


def test_detectors_raise_without_a_card_or_a_fit(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for cls in (VAEOutlierDetector, Seq2SeqOutlierDetector):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                cls()
    for det in (VAEOutlierDetector(device="cpu"), Seq2SeqOutlierDetector(device="cpu")):
        with pytest.raises(RuntimeError, match="needs fit"):
            det.score(np.zeros((2, 4)))
