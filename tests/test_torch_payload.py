"""The port's payload contract and response rules against the JAX package's:
``SeldonMessage`` / ``DefaultData`` / ``Meta`` / ``Status`` /
``SeldonMessageList`` / ``Feedback`` ``from_dict`` -> ``to_dict`` give the
same JSON for every arm, errors carry the same status codes, and
``construct_response`` encodes a component's result by the same rules (a
torch tensor as the JAX package treats a ``jax.Array``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seldon_core_tpu.codec.response import construct_response as jax_construct
from seldon_core_tpu.contracts import payload as jp
from seldon_core_tpu_torch.codec.response import construct_response
from seldon_core_tpu_torch.contracts import payload as pp

META = {"puid": "abc", "tags": {"t": 1}, "routing": {"r": 2}, "requestPath": {"a": "img"},
        "metrics": [{"key": "k", "type": "GAUGE", "value": 3.5, "tags": {"x": "y"}}]}

MESSAGES = {
    "tensor": {"meta": META, "data": {"names": ["a", "b"],
                                      "tensor": {"shape": [2, 2], "values": [1, 2.5, 3, 4]}}},
    "ndarray": {"data": {"ndarray": [[1, 2], [3, 4.5]]}},
    "ndarray_strings": {"data": {"names": ["s"], "ndarray": [["x", 1], ["y", 2]]}},
    "binData": {"meta": {"puid": "p"}, "binData": "aGVsbG8="},
    "strData": {"strData": "hello"},
    "jsonData": {"jsonData": {"k": [1, 2, {"z": None}]}},
    "status": {"status": {"code": 503, "info": "busy", "reason": "SHED", "status": "FAILURE"},
               "meta": {}},
    "empty": {},
}


@pytest.mark.parametrize("arm", sorted(MESSAGES))
def test_message_round_trip_matches_jax(arm):
    body = MESSAGES[arm]
    want = jp.SeldonMessage.from_dict(body).to_dict()
    got = pp.SeldonMessage.from_dict(body).to_dict()
    assert got == want
    assert pp.SeldonMessage.from_dict(body).which == jp.SeldonMessage.from_dict(body).which


@pytest.mark.parametrize("bad", [
    {"data": {"tftensor": {}}},
    {"data": {"tensor": {"shape": [3], "values": [1, 2]}}},
    {"data": {}},
    {"binData": "abc"},
    [1, 2],
])
def test_bad_messages_raise_like_jax(bad):
    with pytest.raises(jp.SeldonError) as je:
        jp.SeldonMessage.from_dict(bad)
    with pytest.raises(pp.SeldonError) as pe:
        pp.SeldonMessage.from_dict(bad)
    assert pe.value.status_code == je.value.status_code
    assert pe.value.to_status().to_dict()["reason"] == je.value.to_status().to_dict()["reason"]


def test_list_and_feedback_match_jax():
    lst = {"seldonMessages": [MESSAGES["tensor"], MESSAGES["strData"]]}
    assert pp.SeldonMessageList.from_dict(lst).to_dict() == \
        jp.SeldonMessageList.from_dict(lst).to_dict()
    fb = {"request": MESSAGES["ndarray"], "response": MESSAGES["tensor"], "reward": 0.5,
          "truth": MESSAGES["jsonData"]}
    assert pp.Feedback.from_dict(fb).to_dict() == jp.Feedback.from_dict(fb).to_dict()


class _Plain:
    pass


class _Named:
    def class_names(self):
        return ["cat", "dog"]

    def tags(self):
        return {"model": "m"}

    def metrics(self):
        return [{"key": "c", "type": "COUNTER", "value": 1}]


RESULTS = {
    "array": np.array([[0.1, 0.9], [0.7, 0.3]], np.float32),
    "list": [[1, 2], [3, 4]],
    "strings": np.array([["a", "b"]]),
    "str": "done",
    "bytes": b"\x00\x01",
    "dict": {"answer": 42},
    "scalar": 3.5,
    "vector": np.arange(3, dtype=np.float32),
}


@pytest.mark.parametrize("component", [_Plain, _Named], ids=["plain", "named"])
@pytest.mark.parametrize("request_arm", ["tensor", "ndarray", "strData", "none"])
@pytest.mark.parametrize("result", sorted(RESULTS))
def test_construct_response_matches_jax(component, request_arm, result):
    req_body = MESSAGES.get(request_arm)
    jreq = None if req_body is None else jp.SeldonMessage.from_dict(req_body)
    preq = None if req_body is None else pp.SeldonMessage.from_dict(req_body)
    want = jax_construct(component(), False, jreq, RESULTS[result]).to_dict()
    got = construct_response(component(), False, preq, RESULTS[result]).to_dict()
    assert got == want


@pytest.mark.parametrize("request_arm", ["tensor", "ndarray"])
def test_tensor_result_is_treated_as_jax_array(request_arm):
    arr = np.array([[0.25, -1.5, 2.0]], np.float32)
    want = jax_construct(_Plain(), False, jp.SeldonMessage.from_dict(MESSAGES[request_arm]),
                         jnp.asarray(arr)).to_dict()
    for t in (torch.from_numpy(arr), torch.from_numpy(arr).to(torch.bfloat16)):
        got = construct_response(_Plain(), False,
                                 pp.SeldonMessage.from_dict(MESSAGES[request_arm]), t).to_dict()
        assert got == want


def test_bad_metrics_and_tags_raise():
    class BadMetrics:
        def metrics(self):
            return [{"key": 1}]

    class BadTags:
        def tags(self):
            return ["x"]

    for comp in (BadMetrics(), BadTags()):
        with pytest.raises(pp.SeldonError):
            construct_response(comp, False, None, np.zeros(2))
