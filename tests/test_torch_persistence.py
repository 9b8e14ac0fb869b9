"""Router state persistence and replica sync of the port
(``seldon_core_tpu_torch/runtime/persistence.py``, the replica-sync half of
``analytics/routers.py``, the CLI's ``--persistence``) held against the JAX
package's on the CPU:

- JAX ``tests/test_analytics.py:75`` and ``:359-490``: a router pickles
  and routes on after the round trip; two replicas converge through
  ``ReplicaSync`` without double counting; a restart resumes its own
  counter; the component contract; a snapshot of another branch count is
  refused (own) and skipped (peer); dead keys expire; ``save_if_absent``.
- A port router and a JAX router fed the same feedback and the same peer
  snapshots give equal ``branch_means`` and equal seeded routes, and
  equal ``stats_snapshot``s; a port router's pickle restores to the same
  next routes as the router that carried on.
- ``cli microservice --persistence`` restores a persisted router instead
  of constructing a fresh one and publishes its replica key; a second
  replica loses the one-shot claim on the shared snapshot and learns its
  counts as a peer.
"""

import pickle
import time

import numpy as np
import pytest

from seldon_core_tpu.analytics import EpsilonGreedy as JaxEpsilonGreedy
from seldon_core_tpu.analytics import ThompsonSampling as JaxThompsonSampling
from seldon_core_tpu.runtime import persistence as jax_persistence
from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy, ThompsonSampling
from seldon_core_tpu_torch.runtime.persistence import (FileStateStore, ReplicaSync,
                                                       RedisStateStore, make_store, replica_id,
                                                       restore_component, state_key)

X = np.zeros((1, 1))
ROUTERS = {"epsilon": (EpsilonGreedy, JaxEpsilonGreedy, dict(epsilon=0.3)),
           "thompson": (ThompsonSampling, JaxThompsonSampling, dict(alpha=1.5, beta=0.5))}


def feedback(router, pairs):
    for routing, reward in pairs:
        router.send_feedback(np.zeros(1), [], reward=reward, truth=None, routing=routing)


def test_router_pickle_roundtrip():
    r = EpsilonGreedy(n_branches=2, epsilon=0.0, seed=0)
    feedback(r, [(1, 1.0)] * 3)
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.route(X, []) == 1
    assert list(r2.pulls) == list(r.pulls)
    # a snapshot from before replica sync (no peer arrays) gains them
    state = r.__getstate__()
    for name in ("peer_pulls", "peer_reward_sum", "peer_fail_sum"):
        del state[name]
    old = EpsilonGreedy.__new__(EpsilonGreedy)
    old.__setstate__(state)
    assert old.peer_pulls.tolist() == [0, 0] and old.route(X, []) == 1


@pytest.mark.parametrize("kind", list(ROUTERS))
def test_restored_router_routes_as_the_one_that_carried_on(kind, tmp_path):
    cls, _, kw = ROUTERS[kind]
    live = cls(n_branches=3, seed=11, **kw)
    rng = np.random.default_rng(4)
    feedback(live, [(int(b), float(r)) for b, r in zip(rng.integers(0, 3, 40), rng.random(40))])
    store = FileStateStore(str(tmp_path))
    store.save("k", live)
    restored = store.restore("k")
    assert [restored.route(X, []) for _ in range(24)] == [live.route(X, []) for _ in range(24)]


@pytest.mark.parametrize("kind", list(ROUTERS))
def test_router_sync_half_equals_jax(kind):
    """The same feedback and peer snapshots into a port and a JAX router:
    equal snapshots, means and seeded routes, malformed peers skipped."""
    cls, jcls, kw = ROUTERS[kind]
    p, j = cls(n_branches=3, seed=5, **kw), jcls(n_branches=3, seed=5, **kw)
    rng = np.random.default_rng(9)
    pairs = [(int(b), float(r)) for b, r in zip(rng.integers(0, 3, 30), rng.random(30))]
    peers = [{"pulls": np.array([4, 0, 9]), "reward_sum": np.array([1.0, 0.0, 8.5]),
              "fail_sum": np.array([3.0, 0.0, 0.5])},
             {"pulls": np.array([1, 1]), "reward_sum": np.array([1.0, 1.0]),
              "fail_sum": np.array([0.0, 0.0])},  # another branch count: skipped
             {"pulls": np.array([2, 6, 1]), "reward_sum": np.array([2.0, 0.5, 0.0]),
              "fail_sum": np.array([0.0, 5.5, 1.0])}]
    for r in (p, j):
        feedback(r, pairs)
        r.apply_peer_stats(peers)
    ps, js = p.stats_snapshot(), j.stats_snapshot()
    assert {k: v.tolist() for k, v in ps.items()} == {k: v.tolist() for k, v in js.items()}
    assert p.peer_pulls.tolist() == j.peer_pulls.tolist() == [6, 6, 10]
    np.testing.assert_array_equal(p.branch_means(), j.branch_means())
    assert [p.route(X, []) for _ in range(50)] == [j.route(X, []) for _ in range(50)]
    assert p.tags() == j.tags()
    for r in (p, j):
        r.reset_local_stats()
    assert p.pulls.tolist() == j.pulls.tolist() == [0, 0, 0]
    assert p.load_stats_snapshot(ps) == j.load_stats_snapshot(js) is True
    assert p.load_stats_snapshot(peers[1]) == j.load_stats_snapshot(peers[1]) is False
    np.testing.assert_array_equal(p.branch_means(), j.branch_means())


def test_replica_sync_converges_bandits(tmp_path):
    store = FileStateStore(str(tmp_path))
    r1 = EpsilonGreedy(n_branches=2, epsilon=0.0, seed=1)
    r2 = EpsilonGreedy(n_branches=2, epsilon=0.0, seed=2)
    s1 = ReplicaSync(r1, key="k", store=store, rid="a", period_s=999)
    s2 = ReplicaSync(r2, key="k", store=store, rid="b", period_s=999)
    # replica 1 learns branch 1 is good; replica 2 sees no feedback at all
    feedback(r1, [(1, 1.0), (0, 0.0)] * 10)
    s1.sync()
    s2.sync()
    assert r2.route(X, []) == 1  # from its peer's counts alone
    np.testing.assert_allclose(r2.branch_means(), r1.branch_means())
    # a G-counter: repeated syncs do not count twice
    s1.sync(); s2.sync(); s1.sync(); s2.sync()  # noqa: E702
    assert int(r2.peer_pulls.sum()) == 20 and int(r1.peer_pulls.sum()) == 0
    np.testing.assert_array_equal(r1.pulls + r1.peer_pulls, r2.pulls + r2.peer_pulls)
    # the JAX package's sync over the same directory reads the port's keys
    rj = JaxEpsilonGreedy(n_branches=2, epsilon=0.0, seed=3)
    jax_persistence.ReplicaSync(rj, key="k", store=jax_persistence.FileStateStore(
        str(tmp_path)), rid="c", period_s=999).sync()
    assert rj.peer_pulls.tolist() == (r1.pulls + r2.pulls).tolist()


def test_replica_sync_restart_resumes_own_counter(tmp_path):
    store = FileStateStore(str(tmp_path))
    r = ThompsonSampling(n_branches=3, seed=0)
    feedback(r, [(2, 1.0)] * 5)
    ReplicaSync(r, key="k", store=store, rid="a", period_s=999).sync()
    r_new = ThompsonSampling(n_branches=3, seed=0)
    s_new = ReplicaSync(r_new, key="k", store=store, rid="a", period_s=999)
    assert s_new.restore_own()
    assert int(r_new.pulls[2]) == 5
    s_new.sync()
    assert int(r_new.peer_pulls.sum()) == 0  # its own key is not a peer


def test_replica_sync_requires_stats_contract(tmp_path):
    class NoStats:
        pass

    for sync_cls, store_cls in ((ReplicaSync, FileStateStore),
                                (jax_persistence.ReplicaSync, jax_persistence.FileStateStore)):
        with pytest.raises(TypeError, match="stats_snapshot"):
            sync_cls(NoStats(), key="k", store=store_cls(str(tmp_path)), rid="x")


def test_replica_sync_shape_mismatch_guard(tmp_path):
    store = FileStateStore(str(tmp_path))
    old = EpsilonGreedy(n_branches=3, seed=0)
    feedback(old, [(2, 1.0)] * 4)
    ReplicaSync(old, key="k", store=store, rid="a", period_s=999).sync()
    fresh = EpsilonGreedy(n_branches=2, seed=0)
    assert not ReplicaSync(fresh, key="k", store=store, rid="a", period_s=999).restore_own()
    peer_view = EpsilonGreedy(n_branches=2, seed=0)
    ReplicaSync(peer_view, key="k", store=store, rid="b", period_s=999).sync()
    assert peer_view.peer_pulls.tolist() == [0, 0]  # skipped, not crashed
    assert peer_view.route(X, []) in (0, 1)


def test_replica_sync_expires_dead_keys(tmp_path):
    store = FileStateStore(str(tmp_path))
    dead = {"pulls": np.array([9, 0]), "reward_sum": np.array([9.0, 0.0]),
            "fail_sum": np.array([0.0, 0.0]), "ts": time.time() - 3600}
    store.save("k:replica:dead", dead)
    r = EpsilonGreedy(n_branches=2, seed=0)
    s = ReplicaSync(r, key="k", store=store, rid="live", period_s=999, expire_after_s=60.0)
    s.sync()
    assert r.peer_pulls.tolist() == [0, 0]
    assert store.restore("k:replica:dead") is None
    store.save("k:replica:d2", dict(dead, ts=time.time()))
    s.sync()
    assert r.peer_pulls.tolist() == [9, 0]


def test_state_store_save_if_absent_and_keys(tmp_path, monkeypatch):
    store = FileStateStore(str(tmp_path))
    assert store.save_if_absent("claim", "a") is True
    assert store.save_if_absent("claim", "b") is False
    assert store.restore("claim") == "a"
    store.delete("claim")
    assert store.restore("claim") is None
    store.delete("claim")  # idempotent
    store.save("p:1", 1)
    store.save("p:2", 2)
    store.save("q", 3)
    assert store.list("p:") == ["p:1", "p:2"]
    env = {"DEPLOYMENT_NAME": "d", "PREDICTOR_ID": "p", "PREDICTIVE_UNIT_ID": "u",
           "REPLICA_ID": "pod-3", "HOSTNAME": "h"}
    assert state_key(env) == jax_persistence.state_key(env) == "persistence_d_p_u"
    assert replica_id(env) == jax_persistence.replica_id(env) == "pod-3"
    assert replica_id({"HOSTNAME": "h"}) == jax_persistence.replica_id({"HOSTNAME": "h"})
    monkeypatch.setenv("PERSISTENCE_DIR", str(tmp_path / "env"))
    monkeypatch.delenv("REDIS_SERVICE_HOST", raising=False)
    assert isinstance(make_store(), FileStateStore)
    assert make_store().root == str(tmp_path / "env")


def test_redis_store_names_redis_and_does_not_fall_back(monkeypatch):
    try:
        import redis  # noqa: F401
        pytest.skip("redis is installed here; the refusal needs it absent")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="redis"):
        RedisStateStore()
    monkeypatch.setenv("REDIS_SERVICE_HOST", "localhost")
    with pytest.raises(RuntimeError, match="redis"):
        make_store()


def test_restore_component_guards_the_class(tmp_path):
    store = FileStateStore(str(tmp_path))
    r = EpsilonGreedy(n_branches=2, seed=0)
    store.save("k", r)
    assert isinstance(restore_component(EpsilonGreedy, key="k", store=store), EpsilonGreedy)
    assert restore_component(ThompsonSampling, key="k", store=store) is None
    assert restore_component(EpsilonGreedy, key="absent", store=store) is None


def test_cli_persistence_restores_a_router(tmp_path, monkeypatch):
    """``microservice --persistence``: the persisted router (with its
    counts) comes back instead of a fresh one and publishes its replica
    key; a second replica restoring the same shared key loses the one-shot
    claim, zeroes its own counts and learns them as a peer."""
    from seldon_core_tpu_torch.transport import cli

    monkeypatch.setenv("PERSISTENCE_DIR", str(tmp_path))
    monkeypatch.delenv("REDIS_SERVICE_HOST", raising=False)
    monkeypatch.setenv("PREDICTIVE_UNIT_PARAMETERS",
                       '[{"name": "n_branches", "value": "2", "type": "INT"},'
                       ' {"name": "epsilon", "value": "0.0", "type": "FLOAT"}]')
    name = "seldon_core_tpu_torch.analytics.routers.EpsilonGreedy"
    live = cli.build_component(name, "cpu")
    assert live.pulls.tolist() == [0, 0]
    feedback(live, [(1, 1.0)] * 3)
    store = FileStateStore(str(tmp_path))
    store.save(state_key(), live)
    monkeypatch.setenv("REPLICA_ID", "r0")
    restored = cli.build_component(name, "cpu", persistence=True)
    assert restored is not live and restored.pulls.tolist() == [0, 3]
    assert restored.route(X, []) == 1
    assert store.restore(f"{state_key()}:replica:r0")["pulls"].tolist() == [0, 3]
    monkeypatch.setenv("REPLICA_ID", "r1")
    second = cli.build_component(name, "cpu", persistence=True)
    assert second.pulls.tolist() == [0, 0] and second.peer_pulls.tolist() == [0, 3]
    assert second.route(X, []) == 1
    # the persistence threads build_component started end here, not at exit
    import threading

    for t in threading.enumerate():
        if t.name in ("seldon-persistence", "seldon-replica-sync"):
            t.stop()
            t.join(10)
            assert not t.is_alive()
    # the flag reaches run_microservice
    seen = {}
    monkeypatch.setattr(cli, "run_microservice", lambda a: seen.update(vars(a)))
    cli.main(["microservice", name, "REST", "--persistence", "--device", "cpu"])
    assert seen["persistence"] is True
