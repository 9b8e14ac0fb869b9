"""The port's cross-request micro-batcher (``seldon_core_tpu_torch/runtime/
microbatch.py``) held against the JAX package's ``MicroBatcher`` on the CPU:
each of ``tests/test_microbatch.py``'s six cases runs the same engine spec
and the same requests through both, and every answer (payload exactly, and
the puids distinct), every engine call's batch size and the batch counters
are equal. The thread path (``predict_sync``, what the port's engine apps
call) holds to the same rules: a group flushes at ``max_batch`` rows on
the filling thread or after ``max_delay_ms`` on the flusher thread, and 8
client threads through ``make_engine_app`` get their own rows back from
one merged engine call.
"""

import asyncio
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu.components.component import SeldonComponent as JaxComponent
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import SeldonError as JaxError
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.runtime.microbatch import MicroBatcher as JaxMicroBatcher
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import PredictorSpec
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage
from seldon_core_tpu_torch.runtime.engine import GraphEngine
from seldon_core_tpu_torch.runtime.microbatch import MicroBatcher
from seldon_core_tpu_torch.transport.rest import make_engine_app, start

MODEL = {"name": "p", "graph": {"name": "m", "type": "MODEL"}}
ROUTER = {"name": "p", "graph": {
    "name": "r", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
    "children": [{"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
                 {"name": "b", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}}


def component_class(base, kind):
    class Double(base):
        """Row-wise model that counts engine-level calls."""

        def __init__(self):
            super().__init__()
            self.batch_sizes = []

        def predict(self, X, names, meta=None):
            X = np.asarray(X)
            self.batch_sizes.append(X.shape[0])
            return X * 2.0

    class Echo(base):
        def predict(self, X, names, meta=None):
            return X

    class Boom(base):
        def predict(self, X, names, meta=None):
            raise (JaxError if base is JaxComponent else SeldonError)("boom")

    return {"double": Double, "echo": Echo, "boom": Boom}[kind]


SIDES = {"jax": (JaxEngine, JaxSpec, JaxComponent, JaxMicroBatcher, JaxMessage),
         "port": (GraphEngine, PredictorSpec, SeldonComponent, MicroBatcher, SeldonMessage)}


def build(side, spec=MODEL, kind="double", **mb_kw):
    engine_cls, spec_cls, base, mb_cls, _ = SIDES[side]
    comp = component_class(base, kind)() if kind else None
    extra = {"device": "cpu"} if side == "port" else {}
    engine = engine_cls(spec_cls.from_dict(spec), components={"m": comp} if comp else None,
                        **extra)
    return mb_cls(engine, **mb_kw), comp


def run_both(requests, spec=MODEL, kind="double", **mb_kw):
    """Each side's (answers or errors, component, batcher) for ``requests``
    (dicts) sent concurrently through ``predict``."""
    out = {}
    for side in SIDES:
        mb, comp = build(side, spec, kind, **mb_kw)
        msg_cls = SIDES[side][4]

        async def go():
            return await asyncio.gather(*[mb.predict(msg_cls.from_dict(r)) for r in requests],
                                        return_exceptions=True)

        out[side] = (asyncio.run(go()), comp, mb)
    return out


def payloads(answers):
    return [a if isinstance(a, BaseException) else
            (a.to_dict().get("data"), a.to_dict().get("strData")) for a in answers]


def rows(values):
    return {"data": {"ndarray": values}}


def test_concurrent_requests_coalesce_and_split():
    reqs = [rows([[float(i)], [float(i) + 0.5]]) for i in range(8)]
    out = run_both(reqs)
    (pj, cj, mj), (pp, cp, mp) = out["jax"], out["port"]
    assert payloads(pp) == payloads(pj)
    for i, a in enumerate(pp):
        assert a.data.to_numpy().tolist() == [[2.0 * i], [2.0 * i + 1.0]]
    assert cp.batch_sizes == cj.batch_sizes and sum(cp.batch_sizes) == 16
    assert len(cp.batch_sizes) < 8  # coalesced
    assert (mp.batches, mp.batched_requests) == (mj.batches, mj.batched_requests)
    assert len({a.meta.puid for a in pp}) == 8


def test_max_batch_triggers_flush():
    out = run_both([rows([[1.0]])] * 4, max_batch=4, max_delay_ms=10_000.0)
    (pj, cj, _), (pp, cp, _) = out["jax"], out["port"]
    assert payloads(pp) == payloads(pj)
    assert cp.batch_sizes == cj.batch_sizes == [4]


def test_mixed_shapes_batch_separately():
    out = run_both([rows([[1.0]]), rows([[1.0, 2.0]]), rows([[3.0]])], max_delay_ms=5.0)
    (pj, cj, _), (pp, cp, _) = out["jax"], out["port"]
    assert payloads(pp) == payloads(pj)
    assert [a.data.to_numpy().tolist() for a in pp] == [[[2.0]], [[2.0, 4.0]], [[6.0]]]
    assert sorted(cp.batch_sizes) == sorted(cj.batch_sizes) == [1, 2]


def test_router_graph_rejected():
    for side in SIDES:
        err = JaxError if side == "jax" else SeldonError
        with pytest.raises(err, match="row-wise"):
            build(side, ROUTER, kind=None)
    out = run_both([rows([[1.0]])], spec=ROUTER, kind=None, strict=False)
    (pj, _, _), (pp, _, _) = out["jax"], out["port"]
    assert pp[0].data.to_numpy().shape == pj[0].data.to_numpy().shape == (1, 3)


def test_non_array_payload_passthrough():
    out = run_both([{"strData": "hello"}], kind="echo")
    assert out["port"][0][0].str_data == out["jax"][0][0].str_data == "hello"


def test_engine_error_propagates_to_all_callers():
    out = run_both([rows([[1.0]]), rows([[2.0]])], kind="boom", max_batch=2,
                   max_delay_ms=10_000.0)
    for side, err in (("jax", JaxError), ("port", SeldonError)):
        assert all(isinstance(r, err) and "boom" in str(r) for r in out[side][0])


# ------------------------------------------------------------- thread path
def _threads(fn, n):
    results = [None] * n

    def run(i):
        results[i] = fn(i)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return results


def test_sync_path_rules():
    # max_batch fills on the caller's thread: one call of 4
    mb, comp = build("port", max_batch=4, max_delay_ms=10_000.0)
    got = _threads(lambda i: mb.predict_sync(SeldonMessage.from_dict(rows([[float(i)]]))), 4)
    assert [g.data.to_numpy().tolist() for g in got] == [[[2.0 * i]] for i in range(4)]
    assert comp.batch_sizes == [4] and (mb.batches, mb.batched_requests) == (1, 4)
    # the delay flushes a partial group on the flusher thread
    mb, comp = build("port", max_batch=64, max_delay_ms=50.0)
    t0 = time.perf_counter()
    got = _threads(lambda i: mb.predict_sync(SeldonMessage.from_dict(rows([[1.0], [2.0]]))), 3)
    assert time.perf_counter() - t0 >= 0.05
    assert all(g.data.to_numpy().tolist() == [[2.0], [4.0]] for g in got)
    assert sum(comp.batch_sizes) == 6 and len(comp.batch_sizes) < 3
    # shapes group apart; non-arrays pass through; errors reach every caller
    mb, comp = build("port", max_batch=2, max_delay_ms=10_000.0)
    reqs = [rows([[1.0]]), rows([[1.0, 2.0]]), rows([[3.0]]), rows([[4.0, 5.0]])]
    got = _threads(lambda i: mb.predict_sync(SeldonMessage.from_dict(reqs[i])), 4)
    assert [g.data.to_numpy().tolist() for g in got] == [[[2.0]], [[2.0, 4.0]], [[6.0]],
                                                         [[8.0, 10.0]]]
    assert sorted(comp.batch_sizes) == [2, 2]
    mb, _ = build("port", kind="echo")
    assert mb.predict_sync(SeldonMessage.from_dict({"strData": "hi"})).str_data == "hi"
    mb, _ = build("port", kind="boom", max_batch=2, max_delay_ms=10_000.0)

    def boom(i):
        try:
            mb.predict_sync(SeldonMessage.from_dict(rows([[float(i)]])))
        except SeldonError as e:
            return e.message
    assert _threads(boom, 2) == ["boom", "boom"]


def test_engine_app_threads_share_one_flush():
    mb, comp = build("port", max_batch=8, max_delay_ms=10_000.0)
    httpd, _ = start(make_engine_app(mb, device="cpu"))
    port = httpd.server_address[1]

    def post(i):
        body = json.dumps({"meta": {"puid": f"q{i}"},
                           "data": {"tensor": {"shape": [1, 3],
                                               "values": [float(i), 1.0, -1.0]}}}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    try:
        got = _threads(post, 8)
    finally:
        httpd.shutdown()
    assert comp.batch_sizes == [8] and (mb.batches, mb.batched_requests) == (1, 8)
    for i, g in enumerate(got):
        assert g["data"]["tensor"]["values"] == [2.0 * i, 2.0, -2.0]
        assert g["meta"]["puid"] == f"q{i}" and g["meta"]["requestPath"] == {"m": "Double"}
