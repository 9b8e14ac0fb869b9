"""The port's bandit routers (``seldon_core_tpu_torch/analytics/routers.py``)
and built-in A/B router against the JAX package's, on the CPU:

- seeded ``EpsilonGreedy``, ``ThompsonSampling`` and ``RandomABTest`` give
  the JAX routers' routes, request by request, with feedback (seeded
  rewards) interleaved, and hold the same state after it: pulls, reward
  and failure sums, branch means, tags and in-band metrics;
- through the graph engine, an ``EPSILON_GREEDY`` / ``THOMPSON_SAMPLING``
  unit over two SIMPLE_MODELs answers the JAX engine's responses (routing
  and in-band metrics included) and learns the same from feedback replayed
  through the engine;
- bad parameters raise as in the JAX package."""

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package's engine imports it)

from seldon_core_tpu.analytics.routers import EpsilonGreedy as JaxEpsilonGreedy
from seldon_core_tpu.analytics.routers import ThompsonSampling as JaxThompsonSampling
from seldon_core_tpu.components.builtin import RandomABTest as JaxRandomABTest
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import Feedback as JaxFeedback
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy, ThompsonSampling
from seldon_core_tpu_torch.components.builtin import RandomABTest
from seldon_core_tpu_torch.contracts.graph import PredictorSpec
from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonMessage
from seldon_core_tpu_torch.runtime.engine import GraphEngine

ROUTERS = {
    "epsilon greedy": (JaxEpsilonGreedy, EpsilonGreedy,
                       dict(n_branches=3, epsilon=0.3, seed=5, best_branch=1)),
    "epsilon greedy exploit": (JaxEpsilonGreedy, EpsilonGreedy,
                               dict(n_branches=2, epsilon=0.0, seed=1)),
    "thompson": (JaxThompsonSampling, ThompsonSampling,
                 dict(n_branches=3, alpha=1.0, beta=2.0, seed=9)),
}


def state(r):
    return (r.pulls.tolist(), r.reward_sum.tolist(), r.fail_sum.tolist(),
            r.branch_means().tolist(), r.tags())


@pytest.mark.parametrize("name", list(ROUTERS))
def test_seeded_router_routes_and_learns_as_jax(name):
    jcls, pcls, kw = ROUTERS[name]
    j, p = jcls(**kw), pcls(**kw)
    rewards = np.random.default_rng(3).uniform(-0.2, 1.2, 60)
    x = np.zeros((1, 2))
    for i, reward in enumerate(rewards):
        branch = p.route(x, [])
        assert branch == j.route(x, []), f"request {i}"
        assert p.metrics() == j.metrics()
        if i % 3 != 2:  # feedback for two requests in three
            for r in (j, p):
                r.send_feedback(x, [], float(reward), None, routing=branch)
        assert state(p) == state(j)
    # feedback naming no branch, or one out of range, changes nothing
    for r in (j, p):
        r.send_feedback(x, [], 1.0, None, routing=None)
        r.send_feedback(x, [], 1.0, None, routing=kw["n_branches"])
    assert state(p) == state(j)
    assert p.pulls.sum() == 40


@pytest.mark.parametrize("kw", [dict(ratioA=0.3, seed=4), dict(n_branches=3, seed=8)],
                         ids=["two branches", "three branches"])
def test_random_abtest_routes_as_jax(kw):
    j, p = JaxRandomABTest(**kw), RandomABTest(**kw)
    routes = [p.route(None, []) for _ in range(100)]
    assert routes == [j.route(None, []) for _ in range(100)]
    assert set(routes) == set(range(kw.get("n_branches", 2)))


@pytest.mark.parametrize("impl,params", [
    ("EPSILON_GREEDY", [("n_branches", "2", "INT"), ("epsilon", "0.25", "FLOAT"),
                        ("seed", "7", "INT")]),
    ("THOMPSON_SAMPLING", [("n_branches", "2", "INT"), ("seed", "3", "INT")]),
])
def test_bandit_unit_in_the_engine_as_jax(impl, params):
    graph = {"name": "bandit", "type": "ROUTER", "implementation": impl,
             "parameters": [{"name": n, "value": v, "type": t} for n, v, t in params],
             "children": [{"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
                          {"name": "b", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}
    spec = {"name": "p", "graph": graph}
    j = JaxEngine(JaxSpec.from_dict(spec))
    p = GraphEngine(PredictorSpec.from_dict(spec), device="cpu")
    rewards = np.random.default_rng(0).uniform(0, 1, 24)
    for i, reward in enumerate(rewards):
        body = {"meta": {"puid": f"b{i}"}, "data": {"ndarray": [[float(i), 1.0]]}}
        want = j.predict_sync(JaxMessage.from_dict(body)).to_dict()
        got = p.predict_sync(SeldonMessage.from_dict(body)).to_dict()
        assert got == want
        fb = {"request": body, "response": got, "reward": float(reward)}
        assert p.send_feedback_sync(Feedback.from_dict(fb)).to_dict() == \
            j.send_feedback_sync(JaxFeedback.from_dict(fb)).to_dict()
    jr, pr = j.state.root.component, p.state.root.component
    assert state(pr) == state(jr) and pr.pulls.sum() == 24


@pytest.mark.parametrize("cls,kw", [("eg", dict(epsilon=1.5)), ("eg", dict(best_branch=4)),
                                    ("eg", dict(n_branches=0)), ("ts", dict(alpha=0.0))])
def test_bad_parameters_raise_as_jax(cls, kw):
    jcls, pcls = ((JaxEpsilonGreedy, EpsilonGreedy) if cls == "eg"
                  else (JaxThompsonSampling, ThompsonSampling))
    with pytest.raises(ValueError) as want:
        jcls(**kw)
    with pytest.raises(ValueError) as got:
        pcls(**kw)
    assert str(got.value) == str(want.value)
