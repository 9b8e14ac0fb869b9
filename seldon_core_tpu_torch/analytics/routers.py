"""Multi-armed-bandit ROUTER components, copied from
``seldon_core_tpu/analytics/routers.py`` (the reference's
`components/routers/epsilon-greedy/EpsilonGreedy.py:9-136` and
`components/routers/thompson-sampling/ThompsonSampling.py`): stateful graph
nodes that choose a child branch a request and learn from the feedback the
engine replays down the branch that served it.

State is plain numpy and the draws come from ``np.random.default_rng(seed)``
in the JAX package's order, so a seeded router routes exactly as the JAX
package's does. The per-branch statistics surface in-band through
``metrics()`` and ``tags()``. A router pickles (``runtime/persistence``
snapshots it) and shares its counters with its serving replicas through
``ReplicaSync``: its own counts stay local, the other replicas' arrive as
peer sums, and every decision reads both.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.components.metrics import create_counter, create_gauge


class _BanditRouter(SeldonComponent):
    """Shared bookkeeping: per-branch pulls and reward sums under a lock
    (feedback and routes arrive concurrently), and their metrics and tags."""

    def __init__(self, n_branches: int = 2, seed: Optional[int] = None, **kwargs: Any):
        super().__init__(**kwargs)
        self.n_branches = int(n_branches)
        if self.n_branches < 1:
            raise ValueError(f"n_branches must be >= 1, got {n_branches}")
        self.pulls = np.zeros(self.n_branches, dtype=np.int64)
        self.reward_sum = np.zeros(self.n_branches, dtype=np.float64)
        self.fail_sum = np.zeros(self.n_branches, dtype=np.float64)
        # the other replicas' counts (ReplicaSync installs their sum): this
        # replica's feedback lands in the arrays above, decisions read both
        self.peer_pulls = np.zeros(self.n_branches, dtype=np.int64)
        self.peer_reward_sum = np.zeros(self.n_branches, dtype=np.float64)
        self.peer_fail_sum = np.zeros(self.n_branches, dtype=np.float64)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._last_branch: Optional[int] = None

    # a lock does not pickle: dropped, and made anew on restore
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        # a snapshot from before replica sync lacks the peer arrays
        for name in ("peer_pulls", "peer_reward_sum", "peer_fail_sum"):
            if name not in self.__dict__:
                dtype = np.int64 if name == "peer_pulls" else np.float64
                setattr(self, name, np.zeros(self.n_branches, dtype=dtype))

    def send_feedback(self, features: np.ndarray, feature_names: Sequence[str], reward: float,
                      truth: Optional[np.ndarray], routing: Optional[int] = None) -> None:
        if routing is None or not (0 <= int(routing) < self.n_branches):
            return
        branch = int(routing)
        with self._lock:
            self.pulls[branch] += 1
            # rewards are success fractions in [0, 1], the reference's
            # convention for its bandit case study
            r = min(max(float(reward), 0.0), 1.0)
            self.reward_sum[branch] += r
            self.fail_sum[branch] += 1.0 - r

    # ------------------------------------------------------- replica sync
    def stats_snapshot(self) -> Dict[str, Any]:
        """This replica's own statistics (not its peers')."""
        with self._lock:
            return {"pulls": self.pulls.copy(), "reward_sum": self.reward_sum.copy(),
                    "fail_sum": self.fail_sum.copy()}

    def reset_local_stats(self) -> None:
        """Zero this replica's own counters (a fresh replica booted from a
        shared-key snapshot: those counts are another replica's and must not
        be republished under this one's key)."""
        with self._lock:
            self.pulls = np.zeros(self.n_branches, dtype=np.int64)
            self.reward_sum = np.zeros(self.n_branches, dtype=np.float64)
            self.fail_sum = np.zeros(self.n_branches, dtype=np.float64)

    def _valid_snapshot(self, s: Dict[str, Any]) -> bool:
        try:
            return all(np.asarray(s[k]).shape == (self.n_branches,)
                       for k in ("pulls", "reward_sum", "fail_sum"))
        except (KeyError, TypeError):
            return False

    def load_stats_snapshot(self, s: Dict[str, Any]) -> bool:
        """Install a snapshot as this replica's own counters (a boot resume);
        False, and nothing changed, for one of another branch count."""
        if not self._valid_snapshot(s):
            return False
        with self._lock:
            self.pulls = np.asarray(s["pulls"], dtype=np.int64).copy()
            self.reward_sum = np.asarray(s["reward_sum"], dtype=np.float64).copy()
            self.fail_sum = np.asarray(s["fail_sum"], dtype=np.float64).copy()
        return True

    def apply_peer_stats(self, snapshots: Sequence[Dict[str, Any]]) -> None:
        """The peer contribution becomes the sum of ``snapshots`` (each one
        other replica's ``stats_snapshot()``); a snapshot of another branch
        count (a stale key) is skipped."""
        pulls = np.zeros(self.n_branches, dtype=np.int64)
        reward = np.zeros(self.n_branches, dtype=np.float64)
        fail = np.zeros(self.n_branches, dtype=np.float64)
        for s in snapshots:
            if not self._valid_snapshot(s):
                continue
            pulls += np.asarray(s["pulls"], dtype=np.int64)
            reward += np.asarray(s["reward_sum"], dtype=np.float64)
            fail += np.asarray(s["fail_sum"], dtype=np.float64)
        with self._lock:
            self.peer_pulls = pulls
            self.peer_reward_sum = reward
            self.peer_fail_sum = fail

    def _totals(self):
        """Local + peer (pulls, reward sums, fail sums); the caller holds
        the lock."""
        return (self.pulls + self.peer_pulls, self.reward_sum + self.peer_reward_sum,
                self.fail_sum + self.peer_fail_sum)

    def branch_means(self) -> np.ndarray:
        with self._lock:
            pulls, reward, _ = self._totals()
            return reward / np.maximum(pulls, 1)

    def tags(self) -> Dict[str, Any]:
        return {"bandit": type(self).__name__,
                "branch_means": [round(float(m), 6) for m in self.branch_means()]}

    def metrics(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        with self._lock:
            # consume the route marker: the counter ticks once a route, not
            # once a metrics collection (feedback collects too)
            branch, self._last_branch = self._last_branch, None
        if branch is not None:
            out.append(create_counter(f"bandit_route_branch_{branch}", 1.0))
        for i, m in enumerate(self.branch_means()):
            out.append(create_gauge(f"bandit_branch_{i}_mean_reward", float(m)))
        return out


class EpsilonGreedy(_BanditRouter):
    """epsilon-greedy: with probability ``epsilon`` a uniform random branch,
    else the branch of the highest mean reward (`EpsilonGreedy.py:9-136`)."""

    def __init__(self, n_branches: int = 2, epsilon: float = 0.1, seed: Optional[int] = None,
                 best_branch: int = 0, **kwargs: Any):
        super().__init__(n_branches=n_branches, seed=seed, **kwargs)
        if not 0.0 <= float(epsilon) <= 1.0:
            raise ValueError(f"epsilon must be in [0,1], got {epsilon}")
        self.epsilon = float(epsilon)
        # the exploit choice before any feedback (the reference's
        # `best_branch` init parameter)
        if not 0 <= int(best_branch) < self.n_branches:
            raise ValueError(f"best_branch {best_branch} out of range for {self.n_branches} "
                             f"branches")
        self.best_branch = int(best_branch)

    def route(self, X: np.ndarray, names: Sequence[str]) -> int:
        with self._lock:
            pulls, reward, _ = self._totals()
            if self._rng.random() < self.epsilon:
                branch = int(self._rng.integers(self.n_branches))
            elif pulls.sum() == 0:
                branch = self.best_branch
            else:
                branch = int(np.argmax(reward / np.maximum(pulls, 1)))
            self._last_branch = branch
            return branch


class ThompsonSampling(_BanditRouter):
    """Thompson sampling with a Beta posterior a branch
    (`ThompsonSampling.py`): a route draws theta_i ~ Beta(alpha_i, beta_i)
    and takes the argmax; feedback adds reward and failure mass to the
    routed branch's posterior."""

    def __init__(self, n_branches: int = 2, alpha: float = 1.0, beta: float = 1.0,
                 seed: Optional[int] = None, **kwargs: Any):
        super().__init__(n_branches=n_branches, seed=seed, **kwargs)
        if alpha <= 0 or beta <= 0:
            raise ValueError("alpha and beta priors must be positive")
        self.alpha0 = float(alpha)
        self.beta0 = float(beta)

    def route(self, X: np.ndarray, names: Sequence[str]) -> int:
        with self._lock:
            _, reward, fail = self._totals()
            theta = self._rng.beta(self.alpha0 + reward, self.beta0 + fail)
            branch = int(np.argmax(theta))
            self._last_branch = branch
            return branch


__all__ = ["EpsilonGreedy", "ThompsonSampling"]
