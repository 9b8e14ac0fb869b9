"""Component state persistence of the port, copied from
``seldon_core_tpu/runtime/persistence.py``.

The reference pickles a stateful router's live object to Redis
(`python/seldon_core/persistence.py:21-85`: a periodic pickle under
``persistence_{DEPLOYMENT}_{PREDICTOR}_{UNIT}``, restored on boot). Here the
store is pluggable: a directory (``FileStateStore``, atomic renames), or
Redis when ``REDIS_SERVICE_HOST`` names a server. ``ReplicaSync`` shares a
router's feedback counters between serving replicas as a G-counter.

Where ``REDIS_SERVICE_HOST`` is set and the ``redis`` package is absent,
``make_store`` raises naming it; it does not fall back to the file store.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Optional

logger = logging.getLogger(__name__)

DEFAULT_PERIOD_S = 60.0  # the reference's default (`persistence.py:68-85`)


def state_key(env: Optional[dict] = None) -> str:
    env = env if env is not None else dict(os.environ)
    return "persistence_{}_{}_{}".format(env.get("DEPLOYMENT_NAME", "dep"),
                                         env.get("PREDICTOR_ID", "pred"),
                                         env.get("PREDICTIVE_UNIT_ID", "unit"))


class StateStore:
    def save(self, key: str, obj: Any) -> None:
        raise NotImplementedError

    def restore(self, key: str) -> Optional[Any]:
        raise NotImplementedError

    def list(self, prefix: str) -> list:
        """Keys starting with ``prefix`` (replica discovery)."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def save_if_absent(self, key: str, obj: Any) -> bool:
        """Create atomically; False when the key exists (a one-shot claim)."""
        raise NotImplementedError


class FileStateStore(StateStore):
    """One pickle a key under ``root`` (default ``PERSISTENCE_DIR``, else
    ``seldon-tpu-state`` in the temporary directory)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get("PERSISTENCE_DIR") or os.path.join(
            tempfile.gettempdir(), "seldon-tpu-state")
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".pkl")

    def save(self, key: str, obj: Any) -> None:
        # a temporary name of this process: replicas on a shared volume save
        # one key at once, and a shared temporary file would tear
        tmp = f"{self._path(key)}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, self._path(key))

    def restore(self, key: str) -> Optional[Any]:
        try:
            with open(self._path(key), "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            # a concurrent expiry may delete between list and open
            return None

    def list(self, prefix: str) -> list:
        return sorted(fn[:-len(".pkl")] for fn in os.listdir(self.root)
                      if fn.endswith(".pkl") and fn.startswith(prefix))

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def save_if_absent(self, key: str, obj: Any) -> bool:
        # the payload is written whole under a random name, then linked into
        # place: the key appears complete or not at all, and the random name
        # cannot collide across replicas (pid-keyed names do: each
        # container's main process tends to be pid 1)
        fd, tmp = tempfile.mkstemp(prefix=".claim-", dir=self.root)
        try:
            os.fchmod(fd, 0o644)  # mkstemp's 0600 would follow the link
            with os.fdopen(fd, "wb") as f:
                pickle.dump(obj, f)
            try:
                os.link(tmp, self._path(key))
                return True
            except FileExistsError:
                return False
        finally:
            os.unlink(tmp)


class RedisStateStore(StateStore):
    def __init__(self, host: Optional[str] = None, port: int = 6379):
        try:
            import redis
        except ImportError as e:
            raise RuntimeError("RedisStateStore requires the redis package") from e
        self._client = redis.StrictRedis(
            host=host or os.environ.get("REDIS_SERVICE_HOST", "localhost"), port=port)

    def save(self, key: str, obj: Any) -> None:
        self._client.set(key, pickle.dumps(obj))

    def restore(self, key: str) -> Optional[Any]:
        raw = self._client.get(key)
        return pickle.loads(raw) if raw else None

    def list(self, prefix: str) -> list:
        return sorted(k.decode() if isinstance(k, bytes) else k
                      for k in self._client.scan_iter(match=prefix + "*"))

    def delete(self, key: str) -> None:
        self._client.delete(key)

    def save_if_absent(self, key: str, obj: Any) -> bool:
        return bool(self._client.set(key, pickle.dumps(obj), nx=True))


def make_store() -> StateStore:
    """Redis when ``REDIS_SERVICE_HOST`` is set, else the file store."""
    if os.environ.get("REDIS_SERVICE_HOST"):
        return RedisStateStore()
    return FileStateStore()


def restore_component(component_class, key: Optional[str] = None,
                      store: Optional[StateStore] = None):
    """The persisted live component of ``component_class``, or None. State
    of another class is stale and ignored (`persistence.py:34-41`)."""
    store = store or make_store()
    obj = store.restore(key or state_key())
    if obj is None:
        return None
    if type(obj).__name__ != component_class.__name__:
        logger.warning("persisted state is a %s, expected %s; ignoring", type(obj).__name__,
                       component_class.__name__)
        return None
    return obj


class PersistenceThread(threading.Thread):
    """Snapshots the live component every ``period_s`` (a daemon), and
    once more at ``stop``."""

    def __init__(self, component: Any, key: Optional[str] = None,
                 store: Optional[StateStore] = None, period_s: float = DEFAULT_PERIOD_S):
        super().__init__(daemon=True, name="seldon-persistence")
        self.component = component
        self.key = key or state_key()
        self.store = store or make_store()
        self.period_s = period_s
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self.period_s):
            self.snapshot()

    def snapshot(self) -> None:
        try:
            self.store.save(self.key, self.component)
        except Exception:
            logger.exception("persistence snapshot failed")

    def stop(self) -> None:
        self._halt.set()
        self.snapshot()


def replica_id(env: Optional[dict] = None) -> str:
    """This serving replica's identity. ``REPLICA_ID`` (the pod's name or
    ordinal) is stable, so a restarted replica resumes its own counter; the
    default, hostname-pid, cannot collide between co-hosted replicas, and
    a restart starts a fresh counter while the old key stays a peer."""
    env = env if env is not None else dict(os.environ)
    explicit = env.get("REPLICA_ID")
    if explicit:
        return explicit
    return f"{env.get('HOSTNAME', 'host')}-pid{os.getpid()}"


class ReplicaSync(threading.Thread):
    """Stateful routers' counters shared between serving replicas, as a
    G-counter: each replica owns the key ``{key}:replica:{id}`` and
    publishes only its own statistics there, then installs the sum of every
    other replica's snapshot as its peer contribution
    (``_BanditRouter.apply_peer_stats``). Decisions read local + peers, so
    the replicas converge between sync periods; none can corrupt shared
    state, and a restarted one resumes its counter from its own key. A
    peer key older than ``expire_after_s`` is a dead replica's and is
    deleted. Works over any StateStore with ``list``."""

    DEFAULT_EXPIRE_S = 7 * 24 * 3600.0

    def __init__(self, component: Any, key: Optional[str] = None,
                 store: Optional[StateStore] = None, rid: Optional[str] = None,
                 period_s: float = 5.0, expire_after_s: Optional[float] = DEFAULT_EXPIRE_S):
        super().__init__(daemon=True, name="seldon-replica-sync")
        for method in ("stats_snapshot", "apply_peer_stats", "load_stats_snapshot"):
            if not hasattr(component, method):
                raise TypeError(f"{type(component).__name__} does not expose {method} "
                                "(required for replica sync)")
        self.component = component
        self.key = key or state_key()
        self.store = store or make_store()
        self.rid = rid or replica_id()
        self.period_s = period_s
        self.expire_after_s = expire_after_s
        self._halt = threading.Event()

    @property
    def own_key(self) -> str:
        return f"{self.key}:replica:{self.rid}"

    def sync(self) -> None:
        try:
            snap = self.component.stats_snapshot()
            snap["ts"] = time.time()
            self.store.save(self.own_key, snap)
            peers = []
            now = time.time()
            for k in self.store.list(f"{self.key}:replica:"):
                if k == self.own_key:
                    continue
                peer = self.store.restore(k)
                if peer is None:
                    continue
                age = now - float(peer.get("ts", now))
                if self.expire_after_s is not None and age > self.expire_after_s:
                    logger.info("expiring dead replica key %s (age %.0fs)", k, age)
                    self.store.delete(k)
                    continue
                peers.append(peer)
            self.component.apply_peer_stats(peers)
        except Exception:
            logger.exception("replica sync failed (will retry)")

    def restore_own(self) -> bool:
        """On boot: resume this replica's own counter if present and of the
        router's shape (a redeploy with another branch count rejects it)."""
        snap = self.store.restore(self.own_key)
        if snap is None:
            return False
        return bool(self.component.load_stats_snapshot(snap))

    def run(self) -> None:
        while not self._halt.wait(self.period_s):
            self.sync()
        self.sync()  # a last publish, so peers see the final counts

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=self.period_s + 1)


__all__ = ["FileStateStore", "PersistenceThread", "RedisStateStore", "ReplicaSync",
           "StateStore", "make_store", "replica_id", "restore_component", "state_key"]
