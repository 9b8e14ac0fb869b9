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

The isolation-forest, VAE and seq2seq detectors arrive with the analytics
slice of the port.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.components.metrics import create_gauge
from seldon_core_tpu_torch.device import resolve_device


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


__all__ = ["MahalanobisOutlierDetector"]
