"""Outlier-detection TRANSFORMER components of the port: the shared surface
and the online Mahalanobis detector, ported from
``seldon_core_tpu/analytics/outliers.py`` (the reference's
`components/outlier-detection/mahalanobis/CoreMahalanobis.py`).

A detector sits in the graph as a TRANSFORMER that passes its features
through unchanged and tags each row's outlier score into ``meta.tags``
(``outlier_score``, ``is_outlier``) with two gauges; ``row_slice`` hands
each request of a stacked batch its own rows' scores.

The Mahalanobis score-then-fold step runs in torch on the detector's
device (the card unless the caller asks for the CPU), in float32 as the
JAX package's jitted step does: masked moments over a batch zero-padded to
a row bucket, ``torch.linalg.inv_ex(cov + reg_eps * I)`` (the inverse
without the error check that would wait on the device; the JAX package's
``inv`` checks nothing either), and the effective sample count clipped at
``n_clip``. The one wait on the device is the copy of the scores back to
the host. The running state pickles as numpy.

The VAE and seq2seq detectors are ``nn.Module``s in flax's layout, scored
in float32 on the detector's device and fitted there with the port's own
Adam (``parallel/train.adam``, optax's defaults); their init and the
VAE's per-epoch eps come from an explicit ``torch.Generator(seed)``. Their
weights pickle as numpy, and a JAX detector's fitted flax params cross
over through ``detector_params_from_jax``. The VAE's score draws its eps
as the JAX package's does, ``jax.random.normal(PRNGKey(0), (rows,
latent))`` (``analytics/threefry.py``), so its scores equal JAX's; that
sample makes a row's score depend on its index in the batch, in both
packages (ROADMAP Queue C). The isolation forest stays sklearn on the
host, as in the JAX package; where sklearn or joblib is missing (the
card's machine) ``fit()`` and ``load()`` raise naming it.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch.analytics import threefry
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.components.metrics import create_gauge
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.utils import bucket

logger = logging.getLogger(__name__)


class _OutlierTransformer(SeldonComponent):
    """Shared surface: score a batch in transform_input, keep features
    unchanged, expose scores via tags()/metrics()."""

    def __init__(self, threshold: float = 0.0, **kwargs: Any):
        super().__init__(**kwargs)
        self.threshold = float(threshold)
        self._last_scores: Optional[np.ndarray] = None
        # RLock: transform_input holds it while calling score(), which locks
        # again in subclasses that update running state (Mahalanobis)
        self._lock = threading.RLock()

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()

    def score(self, X: np.ndarray) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def transform_input(self, X, names: Sequence[str], meta: Optional[Dict] = None):
        arr = np.atleast_2d(np.asarray(X, dtype=np.float64))
        with self._lock:
            self._last_scores = np.asarray(self.score(arr), dtype=np.float64)
        return X

    def tags(self) -> Dict[str, Any]:
        if self._last_scores is None:
            return {}
        flags = self._last_scores > self.threshold
        return {
            "outlier_score": [float(s) for s in self._last_scores],
            "is_outlier": [int(f) for f in flags],
        }

    def metrics(self) -> List[Dict[str, Any]]:
        if self._last_scores is None:
            return []
        return [
            create_gauge("outlier_score_max", float(np.max(self._last_scores))),
            create_gauge("n_outliers", float(np.sum(self._last_scores > self.threshold))),
        ]

    def row_slice(self, lo: int, hi: int):
        """(tags, metrics) of rows [lo, hi) of the last scored batch: a
        caller that stacks k requests into one score() call hands each its
        own rows' scores (scoring is row-independent given the running
        state; the state update is batch-wise). For a solo request (lo=0,
        hi=n) this equals tags()/metrics()."""
        with self._lock:
            if self._last_scores is None or hi > len(self._last_scores):
                return {}, []
            s = np.array(self._last_scores[lo:hi])
        flags = s > self.threshold
        tags = {
            "outlier_score": [float(x) for x in s],
            "is_outlier": [int(f) for f in flags],
        }
        mets = [
            create_gauge("outlier_score_max", float(np.max(s))),
            create_gauge("n_outliers", float(np.sum(flags))),
        ]
        return tags, mets


class MahalanobisOutlierDetector(_OutlierTransformer):
    """Online Mahalanobis distance (`mahalanobis/CoreMahalanobis.py:191`):
    scores each batch against the running mean/covariance *before* folding
    the batch into the statistics, with an effective-sample clip ``n_clip``
    so the estimator tracks drift. The state is three float32 tensors on
    ``device``: the mean [d], the covariance [d, d] and the count []."""

    # batches are zero-padded to these row counts (the JAX package's
    # buckets, so both fold the same padded shapes); past the top bucket,
    # to its multiple
    _ROW_BUCKETS = (1, 16, 256)

    def __init__(
        self,
        threshold: float = 3.0,
        n_components: int = 0,
        n_clip: int = 1000,
        reg_eps: float = 1e-6,
        device: Any = None,
        **kwargs: Any,
    ):
        super().__init__(threshold=threshold, **kwargs)
        self.n_components = int(n_components)
        self.n_clip = int(n_clip)
        self.reg_eps = float(reg_eps)
        self.device = resolve_device(device)
        self._state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None

    def _fresh_state(self, d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dev = self.device
        return (torch.zeros((d,), dtype=torch.float32, device=dev),
                torch.eye(d, dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))

    @torch.no_grad()
    def _step(self, state, X: torch.Tensor, rows: int):
        """Scores of the padded batch ``X`` against ``state`` and the state
        with its ``rows`` real rows folded in; padded rows are a no-op for
        the moments (masked) and their scores are sliced off by the
        caller."""
        mean, cov, n = state
        d = X.shape[1]
        dev = X.device
        n_valid = torch.full((), float(rows), dtype=torch.float32, device=dev)
        mask = (torch.arange(X.shape[0], device=dev) < n_valid).to(X.dtype)
        Xc = X - mean
        prec = torch.linalg.inv_ex(cov + self.reg_eps * torch.eye(d, dtype=X.dtype, device=dev))[0]
        scores = torch.sqrt(torch.clamp(torch.einsum("bi,ij,bj->b", Xc, prec, Xc), min=0.0))
        b = n_valid
        bs = torch.clamp(b, min=1.0)
        batch_mean = torch.sum(X * mask[:, None], dim=0) / bs
        delta = batch_mean - mean
        n_new = n + b
        new_mean = mean + delta * (b / n_new)
        Xb = (X - batch_mean) * mask[:, None]
        batch_cov = (Xb.T @ Xb) / bs
        w_old = n / n_new
        w_b = b / n_new
        new_cov = w_old * cov + w_b * batch_cov + w_old * w_b * torch.outer(delta, delta)
        n_new = torch.clamp(n_new, max=float(self.n_clip))
        return scores, (new_mean, new_cov, n_new)

    def score(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        if self.n_components and X.shape[1] > self.n_components:
            # a cheap projection instead of the reference's sklearn PCA
            X = X[:, : self.n_components]
        rows, d = X.shape
        padded = next((b for b in self._ROW_BUCKETS if b >= rows), None)
        if padded is None:
            top = self._ROW_BUCKETS[-1]
            padded = -(-rows // top) * top
        if padded != rows:
            X = np.concatenate([X, np.zeros((padded - rows, d), X.dtype)], axis=0)
        Xt = torch.from_numpy(X.astype(np.float32)).to(self.device)
        with self._lock:
            if self._state is None:
                self._state = self._fresh_state(d)
            scores, self._state = self._step(self._state, Xt, rows)
        return scores[:rows].cpu().numpy()

    def reset_stats(self) -> None:
        """Zero the running statistics (the readiness-time prewarm: score a
        dummy batch so the first real evaluation finds the device's solver
        initialised, then reset)."""
        with self._lock:
            if self._state is None:
                return
            self._state = self._fresh_state(int(self._state[0].shape[0]))

    def score_frozen(self, X: np.ndarray) -> np.ndarray:
        """Score WITHOUT folding the batch into the running statistics (the
        state is saved before the score-then-fold step and restored after):
        a canary's candidate window scored against the baseline must not
        pull the baseline toward itself. Not atomic against a concurrent
        ``score``; the canary router serialises both under its lock."""
        with self._lock:
            saved = self._state
        scores = self.score(X)
        with self._lock:
            self._state = saved
        return scores

    # device tensors pickle as numpy, and come back on the detector's device
    def __getstate__(self):
        state = super().__getstate__()
        if state.get("_state") is not None:
            state["_state"] = tuple(s.cpu().numpy() for s in state["_state"])
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        if self._state is not None:
            self._state = tuple(torch.from_numpy(np.asarray(s)).to(self.device)
                                for s in self._state)



class IsolationForestOutlierDetector(_OutlierTransformer):
    """sklearn isolation forest (`isolation-forest/CoreIsolationForest.py:116`)
    on the host, as in the JAX package: fit offline on clean data (or load a
    joblib artifact from ``model_uri`` through the port's ``storage``);
    score = -decision_function, so higher means more anomalous. sklearn
    and joblib are imported at use: where they are missing, ``fit()`` and
    ``load()`` raise naming them."""

    def __init__(
        self,
        threshold: float = 0.0,
        model_uri: str = "",
        n_estimators: int = 100,
        contamination: float = 0.01,
        seed: int = 0,
        **kwargs: Any,
    ):
        super().__init__(threshold=threshold, **kwargs)
        self.model_uri = model_uri
        self.n_estimators = int(n_estimators)
        self.contamination = float(contamination)
        self.seed = int(seed)
        self._clf = None

    def load(self) -> None:
        if self._clf is not None or not self.model_uri:
            return
        try:
            import joblib
        except ImportError as e:
            raise ImportError("IsolationForestOutlierDetector.load() needs joblib (and "
                              "scikit-learn, 'sklearn'), which is not installed") from e
        from seldon_core_tpu_torch import storage

        path = storage.download(self.model_uri)
        candidate = os.path.join(path, "model.joblib")
        self._clf = joblib.load(candidate if os.path.exists(candidate) else path)

    def fit(self, X: np.ndarray) -> "IsolationForestOutlierDetector":
        try:
            from sklearn.ensemble import IsolationForest
        except ImportError as e:
            raise ImportError("IsolationForestOutlierDetector.fit() needs scikit-learn (the "
                              "'sklearn' module), which is not installed") from e
        self._clf = IsolationForest(
            n_estimators=self.n_estimators,
            contamination=self.contamination,
            random_state=self.seed,
        ).fit(np.asarray(X))
        return self

    def score(self, X: np.ndarray) -> np.ndarray:
        if self._clf is None:
            self.load()
        if self._clf is None:
            raise RuntimeError("IsolationForestOutlierDetector needs fit() or model_uri")
        return -self._clf.decision_function(np.asarray(X))


# ----------------------------------------------------------------- the nets
def _dense(d_in: int, d_out: int, g: torch.Generator, bias: bool = True) -> nn.Linear:
    """flax's default ``Dense``: a lecun-normal kernel (variance 1 / fan_in,
    truncated at 2 sigma) and a zero bias, drawn on the CPU from ``g``."""
    layer = nn.Linear(d_in, d_out, bias=bias)
    std = (1.0 / d_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=g)
        if bias:
            layer.bias.zero_()
    return layer


class _VAENet(nn.Module):
    """The JAX package's flax VAE: ``Dense_0`` -> relu -> ``Dense_1`` (mu)
    and ``Dense_2`` (logvar); z = mu + exp(logvar / 2) * eps; ``Dense_3``
    -> relu -> ``Dense_4``. ``Linear.weight`` is flax's kernel transposed."""

    def __init__(self, d: int, hidden: int, latent: int, g: torch.Generator):
        super().__init__()
        self.Dense_0 = _dense(d, hidden, g)
        self.Dense_1 = _dense(hidden, latent, g)
        self.Dense_2 = _dense(hidden, latent, g)
        self.Dense_3 = _dense(latent, hidden, g)
        self.Dense_4 = _dense(hidden, d, g)

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        h = torch.relu(self.Dense_0(x))
        mu, logvar = self.Dense_1(h), self.Dense_2(h)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self.Dense_4(torch.relu(self.Dense_3(z))), mu, logvar


class _GRUCell(nn.Module):
    """flax's ``GRUCell`` (0.12), unrolled over a sequence from a zero
    carry: r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)), n =
    tanh(in(x) + r * hn(h)), h' = (1 - z) n + z h; ``hr`` and ``hz`` have
    no bias. Input kernels lecun-normal, recurrent ones orthogonal."""

    def __init__(self, d_in: int, hidden: int, g: torch.Generator):
        super().__init__()
        self.ir = _dense(d_in, hidden, g)
        self.iz = _dense(d_in, hidden, g)
        self.add_module("in", _dense(d_in, hidden, g))
        self.hr = _dense(hidden, hidden, g, bias=False)
        self.hz = _dense(hidden, hidden, g, bias=False)
        self.hn = _dense(hidden, hidden, g)
        with torch.no_grad():
            for layer in (self.hr, self.hz, self.hn):
                nn.init.orthogonal_(layer.weight, generator=g)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """[B, T, F] -> the carries [B, T, H]; the input products run once
        for every step."""
        xr, xz, xn = self.ir(xs), self.iz(xs), getattr(self, "in")(xs)
        h = xs.new_zeros(xs.shape[0], self.hr.weight.shape[0])
        outs = []
        for t in range(xs.shape[1]):
            r = torch.sigmoid(xr[:, t] + self.hr(h))
            z = torch.sigmoid(xz[:, t] + self.hz(h))
            n = torch.tanh(xn[:, t] + r * self.hn(h))
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1)


class _Seq2SeqNet(nn.Module):
    """The JAX package's flax seq2seq autoencoder: ``GRUCell_0`` encodes,
    its last carry is repeated ``timesteps`` times into ``GRUCell_1``, then
    ``Dense_0``; the output is reversed in time."""

    def __init__(self, d: int, hidden: int, g: torch.Generator):
        super().__init__()
        self.GRUCell_0 = _GRUCell(d, hidden, g)
        self.GRUCell_1 = _GRUCell(hidden, hidden, g)
        self.Dense_0 = _dense(hidden, d, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        code = self.GRUCell_0(x)[:, -1]
        dec = self.GRUCell_1(code[:, None, :].expand(-1, x.shape[1], -1))
        return self.Dense_0(dec).flip(1)


def detector_params_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX detector's fitted flax params (its ``_params``: ``{"params":
    ...}`` or the bare dict, leaves as numpy arrays) as the port's state
    dict: ``Dense_i/kernel`` [in, out] is ``Dense_i.weight`` [out, in],
    ``GRUCell_0/ir/bias`` is ``GRUCell_0.ir.bias``. Feed it to the port
    detector's ``adopt``."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}

    def walk(node: Dict[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
            elif key == "kernel":
                out[prefix + "weight"] = np.ascontiguousarray(np.asarray(value, np.float32).T)
            elif key == "bias":
                out[prefix + "bias"] = np.asarray(value, np.float32).copy()
            else:
                raise KeyError(f"unexpected flax leaf {prefix}{key}")

    walk(tree, "")
    return out


def train_step(net: nn.Module, tx, opt_state, loss_fn: Callable, *inputs) -> Tuple[Any, torch.Tensor]:
    """One Adam step of ``loss_fn(net, *inputs)`` on ``net``'s parameters,
    in place: the JAX package's jitted ``train_step`` (value_and_grad, then
    ``tx.update`` and ``apply_updates``). Returns the new optimizer state
    and the loss (a 0-dim tensor, before the update)."""
    from seldon_core_tpu_torch.parallel.train import apply_updates

    params = list(net.parameters())
    with torch.enable_grad():
        loss = loss_fn(net, *inputs)
        grads = torch.autograd.grad(loss, params)
    updates, opt_state = tx.update(list(grads), opt_state, params)
    apply_updates(params, updates)
    return opt_state, loss.detach()


def vae_loss(net: nn.Module, x: torch.Tensor, eps: torch.Tensor, kl_weight: float) -> torch.Tensor:
    """The JAX package's VAE loss: per-row summed squared error, averaged,
    plus ``kl_weight`` times the KL term."""
    recon, mu, logvar = net(x, eps)
    mse = torch.mean(torch.sum((recon - x) ** 2, dim=-1))
    kl = -0.5 * torch.mean(torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))
    return mse + kl_weight * kl


def seq2seq_loss(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's seq2seq loss: the batch's mean squared error."""
    return torch.mean((net(x) - x) ** 2)


class _NetDetector(_OutlierTransformer):
    """A detector whose model is an ``nn.Module`` on ``device``: ``_net``
    once fitted or adopted; a pickle carries the weights as numpy
    (``_params``), and the net is rebuilt from them on this detector's
    device at its first score."""

    def __init__(self, threshold: float, seed: int, device: Any, **kwargs: Any):
        super().__init__(threshold=threshold, **kwargs)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._d: Optional[int] = None
        self._net: Optional[nn.Module] = None
        self._params: Optional[Dict[str, np.ndarray]] = None

    def _new_net(self, g: torch.Generator) -> nn.Module:  # pragma: no cover - abstract
        raise NotImplementedError

    def _d_of(self, params: Dict[str, np.ndarray]) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def adopt(self, params: Dict[str, Any]) -> "_NetDetector":
        """Take fitted weights in the port's names (a state dict, e.g.
        ``detector_params_from_jax`` of a JAX detector's ``_params``)."""
        self._params = {k: np.asarray(v, np.float32) for k, v in params.items()}
        self._d = self._d_of(self._params)
        self._net = None
        return self

    def params(self) -> Dict[str, np.ndarray]:
        """The fitted weights as numpy, in the port's names."""
        if self._net is not None:
            return {k: v.detach().cpu().numpy() for k, v in self._net.state_dict().items()}
        if self._params is None:
            raise RuntimeError(f"{type(self).__name__} needs fit() before scoring")
        return dict(self._params)

    def _ready(self) -> nn.Module:
        if self._net is None:
            if self._params is None:
                raise RuntimeError(f"{type(self).__name__} needs fit() before scoring")
            net = self._new_net(torch.Generator().manual_seed(self.seed))
            net.load_state_dict({k: torch.from_numpy(v) for k, v in self._params.items()})
            self._net = net.to(self.device)
        return self._net

    def _fit_net(self) -> Tuple[nn.Module, torch.Generator]:
        """A freshly initialised net on the device, and the generator it was
        drawn from (the fit's further draws continue it)."""
        g = torch.Generator().manual_seed(self.seed)
        return self._new_net(g).to(self.device), g

    def __getstate__(self):
        state = super().__getstate__()
        if state.get("_net") is not None:
            state["_params"] = self.params()
        state["_net"] = None
        return state


class VAEOutlierDetector(_NetDetector):
    """Variational autoencoder reconstruction-error detector
    (`vae/{CoreVAE.py:181,OutlierVAE.py:118}`), the JAX package's flax MLP
    VAE as an ``nn.Module``; score = per-row reconstruction MSE in float32
    on ``device``. The score's eps is ``jax.random.normal(PRNGKey(0),
    (rows, latent))``, as in the JAX package (not the mean path: a row's
    score depends on its index in the batch), made once per row count and
    kept on the device."""

    def __init__(
        self,
        threshold: float = 0.1,
        latent_dim: int = 2,
        hidden_dim: int = 64,
        seed: int = 0,
        device: Any = None,
        **kwargs: Any,
    ):
        super().__init__(threshold, seed, device, **kwargs)
        self.latent_dim = int(latent_dim)
        self.hidden_dim = int(hidden_dim)
        self._eps: Dict[int, torch.Tensor] = {}

    def _new_net(self, g: torch.Generator) -> nn.Module:
        return _VAENet(self._d, self.hidden_dim, self.latent_dim, g)

    def _d_of(self, params: Dict[str, np.ndarray]) -> int:
        return int(params["Dense_4.bias"].shape[0])

    def score_eps(self, rows: int) -> torch.Tensor:
        """The score's eps for a batch of ``rows``: JAX's
        ``random.normal(PRNGKey(0), (rows, latent))`` on the device."""
        eps = self._eps.get(rows)
        if eps is None:
            eps = torch.from_numpy(threefry.normal(0, (rows, self.latent_dim))).to(self.device)
            self._eps[rows] = eps
        return eps

    def fit(self, X: np.ndarray, epochs: int = 200, lr: float = 1e-3,
            kl_weight: float = 1e-3) -> "VAEOutlierDetector":
        """Full-batch Adam over ``X`` for ``epochs`` steps on the device;
        each epoch's eps is drawn from the generator that drew the init."""
        from seldon_core_tpu_torch.parallel.train import adam

        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        self._d = X.shape[1]
        net, g = self._fit_net()
        tx = adam(lr)
        opt_state = tx.init(list(net.parameters()))
        x = torch.from_numpy(X).to(self.device)
        loss = torch.zeros(())
        for _ in range(epochs):
            eps = torch.randn((X.shape[0], self.latent_dim), generator=g).to(self.device)
            opt_state, loss = train_step(net, tx, opt_state, vae_loss, x, eps, kl_weight)
        self._net, self._params = net, None
        logger.info("VAE fit done: final loss %.5f", float(loss))
        return self

    @torch.no_grad()
    def score(self, X: np.ndarray) -> np.ndarray:
        net = self._ready()
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        x = torch.from_numpy(X).to(self.device)
        recon, _, _ = net(x, self.score_eps(X.shape[0]))
        return torch.mean((recon - x) ** 2, dim=-1).cpu().numpy()

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_eps", None)
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        self._eps = {}


class Seq2SeqOutlierDetector(_NetDetector):
    """Sequence reconstruction detector (`seq2seq-lstm/CoreSeq2SeqLSTM.py:214`):
    the JAX package's flax GRU encoder-decoder as an ``nn.Module``, whose
    reconstruction MSE flags anomalous stretches of a series.

    Input contract: a 3-D batch [B, T, F] scores per sequence; a 2-D batch
    [N, F] (the graph payload case) is framed into non-overlapping
    ``timesteps`` windows (the tail padded by repetition) and each row
    inherits its window's score. ``stack_segments`` frames a stacked call
    per request, so no window straddles two requests; the window batch is
    repeat-padded to a bucket of ``_W_BUCKETS``.

    ``save()`` pickles the fitted detector as ``detector.pkl``; ``load()``
    adopts one from ``model_uri`` through the port's ``storage``. The
    pickle is the port's class: a JAX package pickle does not load here
    (its class is the JAX package's); carry such a detector's weights with
    ``detector_params_from_jax`` and ``adopt`` instead."""

    _W_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

    def __init__(
        self,
        threshold: float = 0.1,
        timesteps: int = 8,
        hidden_dim: int = 32,
        seed: int = 0,
        model_uri: str = "",
        device: Any = None,
        **kwargs: Any,
    ):
        super().__init__(threshold, seed, device, **kwargs)
        self.timesteps = int(timesteps)
        self.hidden_dim = int(hidden_dim)
        self.model_uri = model_uri
        self._pending_segments: Optional[List[int]] = None

    def _new_net(self, g: torch.Generator) -> nn.Module:
        return _Seq2SeqNet(self._d, self.hidden_dim, g)

    def _d_of(self, params: Dict[str, np.ndarray]) -> int:
        return int(params["Dense_0.bias"].shape[0])

    def load(self) -> None:
        """Adopt a fitted detector pickled by ``save()`` from model_uri."""
        if self._net is not None or self._params is not None or not self.model_uri:
            return
        from seldon_core_tpu_torch import storage

        path = storage.download(self.model_uri)
        candidate = os.path.join(path, "detector.pkl")
        with open(candidate if os.path.exists(candidate) else path, "rb") as f:
            fitted = pickle.load(f)
        if not isinstance(fitted, Seq2SeqOutlierDetector) or fitted._params is None:
            raise RuntimeError(
                f"{self.model_uri} does not contain a fitted "
                "Seq2SeqOutlierDetector (save() one after fit())")
        for attr in ("threshold", "timesteps", "hidden_dim", "seed", "_params", "_d"):
            setattr(self, attr, getattr(fitted, attr))
        self._net = None  # rebuilt on this detector's device at the first score

    def save(self, out_dir: str) -> str:
        """Pickle this fitted detector as <out_dir>/detector.pkl (the
        artifact ``load()`` consumes)."""
        if self._net is None and self._params is None:
            raise RuntimeError("fit() before save()")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "detector.pkl")
        with open(path, "wb") as f:
            pickle.dump(self, f)
        return path

    def stack_segments(self, counts: Sequence[int]) -> None:
        """The NEXT 2-D score() call's rows are the concatenation of
        ``len(counts)`` requests with these row counts. Consumed once;
        without it a call is one segment (solo semantics)."""
        self._pending_segments = [int(c) for c in counts]

    def _frame(self, X: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """[N, F] -> ([W, T, F], row->window index map); 3-D passes through."""
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 3:
            if X.shape[1] != self.timesteps:
                raise ValueError(
                    f"3-D input must have sequence length {self.timesteps} "
                    f"(the decoder's unroll length), got {X.shape[1]}")
            return X, None
        X = np.atleast_2d(X)
        n, d = X.shape
        T = self.timesteps
        pad = (-n) % T
        if pad:
            X = np.concatenate([X, np.repeat(X[-1:], pad, axis=0)], axis=0)
        windows = X.reshape(-1, T, d)
        row_to_window = np.repeat(np.arange(len(windows)), T)[:n]
        return windows, row_to_window

    def fit(self, X: np.ndarray, epochs: int = 200, lr: float = 1e-2) -> "Seq2SeqOutlierDetector":
        """Full-batch Adam over the framed windows for ``epochs`` steps."""
        from seldon_core_tpu_torch.parallel.train import adam

        windows, _ = self._frame(X)
        self._d = windows.shape[-1]
        net, _ = self._fit_net()
        tx = adam(lr)
        opt_state = tx.init(list(net.parameters()))
        x = torch.from_numpy(windows).to(self.device)
        loss = torch.zeros(())
        for _ in range(epochs):
            opt_state, loss = train_step(net, tx, opt_state, seq2seq_loss, x)
        self._net, self._params = net, None
        logger.info("Seq2Seq fit done: final loss %.6f", float(loss))
        return self

    @torch.no_grad()
    def score(self, X: np.ndarray) -> np.ndarray:
        net = self._ready()
        segs, self._pending_segments = self._pending_segments, None
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 3 or not segs or sum(segs) != np.atleast_2d(X).shape[0]:
            windows, row_map = self._frame(X)
        else:
            X = np.atleast_2d(X)
            parts, maps, off, woff = [], [], 0, 0
            for c in segs:
                w, m = self._frame(X[off:off + c])
                parts.append(w)
                maps.append(m + woff)
                off += c
                woff += len(w)
            windows = np.concatenate(parts, axis=0)
            row_map = np.concatenate(maps)
        w = len(windows)
        padded = bucket(w, self._W_BUCKETS)
        if padded != w:
            windows = np.concatenate(
                [windows, np.repeat(windows[-1:], padded - w, axis=0)], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(windows)).to(self.device)
        per_window = torch.mean((net(x) - x) ** 2, dim=(1, 2)).cpu().numpy()[:w]
        if row_map is None:
            return per_window
        return per_window[row_map]


__all__ = ["IsolationForestOutlierDetector", "MahalanobisOutlierDetector",
           "Seq2SeqOutlierDetector", "VAEOutlierDetector", "detector_params_from_jax",
           "seq2seq_loss", "train_step", "vae_loss"]
