"""The network KV handoff in the port (``handoff_transport="network"``:
``PrefillWorker._frame_handoff`` / ``_send_frame`` and ``HandoffReceiver``
of ``seldon_core_tpu_torch/runtime/disagg.py``) held against the JAX package
on the CPU, at ``tests/test_network_handoff.py``'s sizes:

- greedy tokens over the socket == the device transport == JAX's network
  transport, the bytes really crossing the wire (the device transport
  reports none), for the paged and the dense layout (the dense one also
  == the local dense batcher); seeded tokens over the socket == the device
  transport's;
  ``handoff_transport`` set on the server reaches the batcher;
- a frame truncated in flight fails its own request, and the batch serves
  on;
- the receiver cases of ``tests/test_network_handoff.py`` (round trip,
  truncated payload, garbage, oversized length prefix with and without
  recoverable metadata, truncation on the wire, a replayed frame), each
  sent as the same JAX-encoded bytes to a port receiver and a JAX receiver:
  the same outcomes, the tensors bit-equal; the port's handoffs carry no
  flight events."""

import asyncio
import socket
import struct
import time

import numpy as np
import pytest
import torch

import jax

from seldon_core_tpu.codec import framing as jax_framing
from seldon_core_tpu.runtime.batcher import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.runtime.disagg import HandoffReceiver as JaxReceiver
from seldon_core_tpu.runtime.disagg import TransferQueue as JaxQueue
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.runtime.disagg import (MAX_HANDOFF_FRAME_BYTES, HandoffReceiver,
                                                  TransferQueue)
from seldon_core_tpu_torch.servers.llmserver import LLMServer

KW = dict(vocab_size=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=96, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=8, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3,
              disaggregation="remote_prefill", prefill_devices=2)
BKW = dict(max_slots=3, max_len=40, len_buckets=(8,), page_size=8)
PROMPTS = [[5, 9, 17], [40, 3, 22, 8, 11, 60, 2, 33, 7, 7, 12, 13], [7], [60, 61, 62, 63, 64, 65]]
TIMEOUT = 120


@pytest.fixture(scope="module")
def pair():
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    p = LLMServer(device="cpu", **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    return j, p


def port_batch(server, prompts, transport, seeds=None, n=8, **kw):
    b = ContinuousBatcher(server, device="cpu", handoff_transport=transport,
                          **dict(BKW, **kw))
    try:
        futs = [b.submit(p, n, seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        outs = [f.result(TIMEOUT) for f in futs]
        stats = b.handoff_stats(), b.page_stats()
    finally:
        b.close()
    return outs, stats[0], stats[1]


def test_network_greedy_equals_device_and_jax(pair):
    j, p = pair
    dev, dstats, _ = port_batch(p, PROMPTS, "device")
    net, nstats, pages = port_batch(p, PROMPTS, "network")

    async def go():
        b = JaxBatcher(j, layout="paged", handoff_transport="network", **BKW)
        outs = await asyncio.gather(*[b.submit(pr, max_new_tokens=8) for pr in PROMPTS])
        await b.close()
        return outs

    assert net == dev == asyncio.run(go())
    assert nstats["handoffs_total"] == len(PROMPTS) and nstats["handoff_queue_depth"] == 0
    assert nstats["handoff_network_bytes_total"] > dstats["handoff_transfer_bytes_total"]
    assert dstats["handoff_network_bytes_total"] == 0
    assert pages["kv_pages_in_use"] == 0


def test_dense_network_equals_device_local_and_jax(pair):
    """The dense layout's handoff over the socket: the worker's prompt
    columns framed, received and inserted into the slot's row; tokens equal
    the device transport's, the local dense batcher's and JAX's dense
    network transport; every slot back."""
    j, p = pair
    dev, _, _ = port_batch(p, PROMPTS, "device", layout="dense")
    net, nstats, pages = port_batch(p, PROMPTS, "network", layout="dense")
    local, _, _ = port_batch(p, PROMPTS, "device", layout="dense", disaggregation="off")

    async def go():
        b = JaxBatcher(j, layout="dense", handoff_transport="network", **BKW)
        outs = await asyncio.gather(*[b.submit(pr, max_new_tokens=8) for pr in PROMPTS])
        await b.close()
        return outs

    assert net == dev == local == asyncio.run(go())
    assert nstats["handoffs_total"] == len(PROMPTS) and nstats["handoff_queue_depth"] == 0
    assert nstats["handoff_network_bytes_total"] > 0
    assert pages["kv_pages_total"] == 0


def test_network_seeded_equals_device():
    p = LLMServer(device="cpu", init_random=True,
                  **dict(COMMON, temperature=0.8, top_k=20, seed=5))
    p.load()
    prompts, seeds = [[5, 9, 17, 2], [40, 3, 22], [7, 7, 7, 7, 7]], [42, 1234, 7]
    dev, *_ = port_batch(p, prompts, "device", seeds=seeds)
    net, *_ = port_batch(p, prompts, "network", seeds=seeds)
    assert net == dev


def test_server_level_transport_reaches_batcher(pair):
    j, p0 = pair
    p = LLMServer(device="cpu", handoff_transport="network", **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    b = ContinuousBatcher(p, device="cpu", **BKW)
    try:
        assert b.handoff_transport == "network" and b._receiver is not None
        out = b.submit(PROMPTS[0], 4).result(TIMEOUT)
        assert b.handoff_stats()["handoff_network_bytes_total"] > 0
    finally:
        b.close()
    assert out == p0.generate([PROMPTS[0]], max_new_tokens=4)["tokens"][0]


def test_truncated_frame_fails_one_request_not_the_batch(pair):
    _, p = pair
    b = ContinuousBatcher(p, device="cpu", handoff_transport="network", prefill_workers=1,
                          max_slots=2, max_len=32, len_buckets=(8,), page_size=8)
    try:
        worker = b._remote.workers[0]
        real = worker._frame_handoff
        cut = [1]

        def truncated(handoff):
            buffers = real(handoff)
            if cut:   # the frame's last 16 bytes never leave
                cut.pop()
                return buffers[:-1] + [memoryview(buffers[-1])[:-16]]
            return buffers

        worker._frame_handoff = truncated
        with pytest.raises(Exception):
            b.submit([40, 3, 22, 8], 4).result(TIMEOUT)
        assert b.crashed is None
        ok = b.submit([5, 9, 17], 4).result(TIMEOUT)
        pages = b.page_stats()["kv_pages_in_use"]
    finally:
        b.close()
    assert ok == p.generate([[5, 9, 17]], max_new_tokens=4)["tokens"][0]
    assert pages == 0


# -------------------------------------------- receiver wire protocol
def _kv_frame(job_id):
    """A KVHandoff frame as the JAX package encodes it."""
    staged = {"k": np.arange(6, dtype=np.float32).reshape(2, 3),
              "v": [np.arange(4, dtype=np.int32)]}
    skel, leaves = jax_framing.tree_skeleton(staged)
    tensors = list(leaves) + [np.linspace(0, 1, 8, dtype=np.float32)]
    meta = {"kind": "KVHandoff", "job_id": job_id, "prefill_s": 0.25, "skeleton": skel,
            "first_logits_ref": len(leaves), "record_events": False, "events": []}
    return staged, jax_framing.encode_frame(meta, tensors, path="handoff")


def _send(addr, payload, *, declared=None):
    n = len(payload) if declared is None else declared
    with socket.create_connection(addr, timeout=5.0) as s:
        try:
            s.sendall(struct.pack("<Q", n) + payload)
            s.shutdown(socket.SHUT_WR)
            s.settimeout(5.0)
            s.recv(1)   # EOF: the receiver is done with this connection
        except OSError:
            pass  # the receiver may reset mid-send (the oversized-prefix drop)


def _wait_pop(q, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        h = q.pop()
        if h is not None:
            return h
        time.sleep(0.01)
    raise AssertionError("no handoff delivered within timeout")


def _host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def case_roundtrip(q, r):
    q.register(11)
    staged, payload = _kv_frame(11)
    _send(r.addr, payload)
    h = _wait_pop(q)
    return [h.job_id, h.error is None, h.prefill_s, h.transfer_bytes == len(payload),
            np.array_equal(_host(h.staged["k"]), staged["k"]),
            np.array_equal(_host(h.staged["v"][0]), staged["v"][0]),
            np.array_equal(_host(h.first_logits), np.linspace(0, 1, 8, dtype=np.float32)),
            r.stats()["handoff_network_bytes_total"] == len(payload)]


def case_truncated_payload(q, r):
    q.register(21)
    _, payload = _kv_frame(21)
    _send(r.addr, payload[:-16])
    h = _wait_pop(q)
    return [h.job_id, h.error is not None, h.staged, r.stats()["handoff_network_bytes_total"]]


def case_garbage(q, r):
    _send(r.addr, b"\x00" * 64)
    q.register(31)
    _send(r.addr, _kv_frame(31)[1])
    h = _wait_pop(q)
    return [h.job_id, h.error is None]


def case_oversized_prefix(q, r):
    _send(r.addr, b"x" * 32, declared=MAX_HANDOFF_FRAME_BYTES + 1)
    q.register(41)
    _send(r.addr, _kv_frame(41)[1])
    return [_wait_pop(q).job_id]


def case_wire_truncation(q, r):
    q.register(61)
    _, payload = _kv_frame(61)
    _send(r.addr, payload[:-16], declared=len(payload))
    h = _wait_pop(q)
    return [h.job_id, h.error is not None, h.staged, r.stats()["handoff_network_bytes_total"]]


def case_oversized_with_meta(q, r):
    q.register(71)
    _send(r.addr, _kv_frame(71)[1], declared=MAX_HANDOFF_FRAME_BYTES + 1)
    h = _wait_pop(q)
    log = [h.job_id, h.error is not None, h.staged]
    q.register(72)
    _send(r.addr, _kv_frame(72)[1])
    return log + [_wait_pop(q).job_id]


def case_replay(q, r):
    q.register(51)
    _, payload = _kv_frame(51)
    _send(r.addr, payload)
    log = [_wait_pop(q).job_id]
    _send(r.addr, payload)
    time.sleep(0.2)  # give the reader time to (wrongly) deliver
    return log + [q.pop(), q.stats()[0]]


@pytest.mark.parametrize("case", [case_roundtrip, case_truncated_payload, case_garbage,
                                  case_oversized_prefix, case_wire_truncation,
                                  case_oversized_with_meta, case_replay])
def test_receiver_case_equals_jax(case):
    outcomes = []
    for make_q, make_r in ((TransferQueue, lambda q: HandoffReceiver(q, "cpu")),
                           (JaxQueue, lambda q: JaxReceiver(q, jax.devices()[0]))):
        q = make_q()
        r = make_r(q)
        try:
            outcomes.append(case(q, r))
        finally:
            r.close()
    assert outcomes[0] == outcomes[1]


def test_receiver_tensors_land_as_tensors_without_events():
    """The port's receiver: every leaf a torch tensor on its device, the
    frame's bf16 leaf bit-equal, no flight events stamped."""
    from seldon_core_tpu_torch.codec import framing

    q = TransferQueue()
    r = HandoffReceiver(q, "cpu")
    try:
        q.register(5)
        k = torch.randn(3, 4).to(torch.bfloat16)
        skel, leaves = framing.tree_skeleton([(k, torch.arange(4, dtype=torch.int32))])
        payload = framing.encode_frame({"kind": "KVHandoff", "job_id": 5, "skeleton": skel,
                                        "first_token": 3, "first_key": 9}, leaves,
                                       path="handoff")
        _send(r.addr, payload)
        h = _wait_pop(q)
    finally:
        r.close()
    (got_k, got_pos), = h.staged
    assert got_k.dtype == torch.bfloat16 and torch.equal(got_k.view(torch.int16),
                                                         k.view(torch.int16))
    assert torch.equal(got_pos, torch.arange(4, dtype=torch.int32))
    assert (h.first_token, h.first_key, h.events, h.event) == (3, 9, [], None)
