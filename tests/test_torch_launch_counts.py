"""The kernel wrappers' launch counters (``seldon_core_tpu_torch/ops/launches.py``):
a capture's launches go to its own thread's tally and nowhere else, other
threads count into the counters meanwhile, a replay adds the tally, and
concurrent additions lose nothing. Runs on the CPU with stand-in wrappers."""

import sys
import threading

import pytest

from seldon_core_tpu_torch.ops import launches
from seldon_core_tpu_torch.servers.step_graph import ReplayGraph


def _wrapper():
    def fn():
        pass
    fn.launches = 0
    fn.launches_int8 = 0
    return fn


def test_count_outside_a_tally_adds_to_the_counter():
    fn = _wrapper()
    launches.count(fn)
    launches.count(fn, "launches_int8", n=3)
    assert (fn.launches, fn.launches_int8) == (1, 3)


def test_a_tally_takes_its_threads_counts_and_not_the_counters():
    fn = _wrapper()
    with launches.tally() as counts:
        launches.count(fn)
        launches.count(fn, n=2)
        with launches.tally() as inner:
            launches.count(fn, "launches_int8")
        launches.count(fn, "launches_int8")
    launches.count(fn)
    assert counts == {(fn, "launches"): 3, (fn, "launches_int8"): 1}
    assert inner == {(fn, "launches_int8"): 1}
    assert (fn.launches, fn.launches_int8) == (1, 0)


def test_other_threads_count_into_the_counters_while_one_tallies():
    """A batcher thread launching while a REST thread captures: its
    launches reach the counters, none of them the capture's tally."""
    fn = _wrapper()
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait()
        for _ in range(500):
            launches.count(fn)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with launches.tally() as counts:
        started.set()
        launches.count(fn, n=7)
        assert done.wait(30)
    t.join(30)
    assert counts == {(fn, "launches"): 7}
    assert fn.launches == 500


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_adds_its_captures_tally():
    fn = _wrapper()
    with launches.tally() as counts:
        launches.count(fn, n=4)
        launches.count(fn, "launches_int8")
    graph = ReplayGraph(_Graph(), out="tokens", counts=counts)
    assert graph.replay() == "tokens" and graph.replay() == "tokens"
    assert graph.graph.replays == 2
    assert (fn.launches, fn.launches_int8) == (8, 2)


@pytest.mark.parametrize("n_threads", [2, 8])
def test_concurrent_counts_and_replays_lose_nothing(n_threads):
    fn = _wrapper()
    graph = ReplayGraph(_Graph(), out=None, counts={(fn, "launches"): 2})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(2000):
                if i % 2:
                    graph.replay()
                else:
                    launches.count(fn)
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert fn.launches == (n_threads // 2) * 2000 * (1 + 2)
