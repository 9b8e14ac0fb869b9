"""SSE streaming on ``POST /v1/generate`` and per-token delivery from the
batcher, in the port (``seldon_core_tpu_torch/transport/rest.py``,
``runtime/batcher.py``) against the JAX package's aiohttp app, on the CPU
at a tiny width (greedy, float32, the JAX weights through
``models/convert.params_from_jax``):

- the port's events equal the JAX app's, event for event (token ids, text
  pieces, the ``done`` event), for a text and an id prompt, at
  ``decode_fuse_steps`` 1 and 4, and each stream's token events equal its
  ``done`` tokens; the port frames them chunked, one ``data:`` event a
  chunk;
- the status codes equal JAX's: 400 for a per-request temperature and for
  a seeded stream the slot cache cannot hold, and ``"prompts"`` with
  ``"stream"`` answers 200 with JAX's body;
- a shed after the headers is one ``{"error": ...}`` event on both apps,
  and a real page-exhaustion shed in the port's batcher gives that shape;
- a component without ``continuous_batching`` streams through one shared
  1-slot service, whose stream equals ``generate()``; ``/predict`` keeps
  the private path;
- a client that disconnects mid-stream and a cancelled ``submit`` leave
  the batcher running (no ``InvalidStateError``), every page returns, and
  the next request gets its solo tokens; a callback that raises is ignored;
  so do they with speculation on, where a drain surfaces a block of
  tokens (each token an event, the events equal to the done tokens).

Every socket read has a timeout, so a hung stream fails instead of waiting
out the run."""

import asyncio
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
from aiohttp import web

import jax

from seldon_core_tpu.runtime.resilience import ShedError as JaxShedError
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.transport.rest import make_component_app as jax_app
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
from seldon_core_tpu_torch.runtime.resilience import ShedError
from seldon_core_tpu_torch.servers.llmserver import ByteTokenizer, LLMServer
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=256, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=64, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=6, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3)
IDS = [5, 9, 17, 2, 40, 3, 22, 8, 11, 60, 2, 33]
STREAMS = {"text": {"prompt": "hello world", "stream": True},
           "ids": {"prompt": IDS, "max_new_tokens": 9, "stream": True}}
TIMEOUT = 60


def jax_threaded_app(comp):
    """(port, stop) of the JAX package's app for ``comp`` on its own loop
    thread."""
    app = jax_app(comp)
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        run.port = s.getsockname()[1]
        loop.run_until_complete(web.SockSite(runner, s).start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(10)
    return run.port, lambda: loop.call_soon_threadsafe(loop.stop)


def port_app(server):
    """(port, stop) of the port's app for ``server``."""
    httpd, _ = start(make_component_app(server, device="cpu"))

    def stop():
        httpd.shutdown()
        httpd.server_close()

    return httpd.server_address[1], stop


def open_stream(port, body):
    """POST ``body`` to /v1/generate; returns the open response."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn.getresponse()


def read_events(resp, n=None):
    """The ``data:`` events of an SSE response as they arrive (``readline``
    on the response), all of them or the next ``n``."""
    events = []
    while n is None or len(events) < n:
        line = resp.readline()
        if not line:
            break
        line = line.decode().strip()
        if line.startswith("data: "):
            events.append(json.loads(line[6:]))
    return events


def sse(port, body):
    resp = open_stream(port, body)
    assert resp.status == 200, resp.read()
    return resp, read_events(resp)


def post(port, body, path="/v1/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def jax_params(server):
    return {"params": jax.tree_util.tree_map(np.asarray, server._params["params"])}


def port_server(params, **extra):
    s = LLMServer(device="cpu", **dict(COMMON, **extra))
    s.load(params=params)
    return s


@pytest.fixture(scope="module")
def params():
    """The JAX package's random weights of COMMON, as numpy."""
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    return jax_params(j)


@pytest.fixture(scope="module")
def pairs(params):
    """fuse -> (JAX app port, port app port, port server): one JAX server
    and its port twin (the same weights) per ``decode_fuse_steps``, each
    with 2 batcher slots, built on first use."""
    built, stops = {}, []

    def get(fuse):
        if fuse not in built:
            j = JaxLLMServer(init_random=True, continuous_batching=2, decode_fuse_steps=fuse,
                             **COMMON)
            j.load()
            jport, jstop = jax_threaded_app(j)
            p = port_server(params, continuous_batching=2, decode_fuse_steps=fuse)
            pport, pstop = port_app(p)
            stops.extend([jstop, pstop, p])
            built[fuse] = (jport, pport, p)
        return built[fuse]

    yield get
    for stop in stops:
        if isinstance(stop, LLMServer):
            stop._batcher_service.close()
        else:
            stop()


@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("kind", ["text", "ids"])
def test_sse_events_equal_jax(pairs, fuse, kind):
    jport, pport, server = pairs(fuse)
    body = STREAMS[kind]
    resp, events = sse(pport, body)
    assert resp.getheader("Content-Type") == "text/event-stream"
    assert resp.getheader("Transfer-Encoding") == "chunked"
    _, want = sse(jport, body)
    assert events == want
    done = events[-1]
    assert done["done"] is True and "error" not in done
    assert [e["token"] for e in events[:-1]] == done["tokens"]
    assert len(done["tokens"]) == body.get("max_new_tokens", COMMON["max_new_tokens"])
    assert (done["text"] is None) == (kind == "ids")
    assert done["tokens"] == server.generate([body["prompt"]],
                                             max_new_tokens=body.get("max_new_tokens"))["tokens"][0]


STATUS_CASES = {
    "temperature": {"prompt": "hello", "stream": True, "temperature": 0.5},
    "seeded oversized": {"prompt": "x" * 40, "stream": True, "seed": 9},
    "prompts": {"prompts": ["hello", [5, 9, 2]], "stream": True},
}


@pytest.mark.parametrize("case", list(STATUS_CASES))
def test_status_codes_equal_jax(pairs, case):
    jport, pport, _ = pairs(1)
    got, want = post(pport, STATUS_CASES[case]), post(jport, STATUS_CASES[case])
    assert got == want
    assert got[0] == (200 if case == "prompts" else 400)


class _Stub:
    """A component whose shared service is ``svc``: a stream of it runs
    the transport alone."""

    def __init__(self, svc):
        self._batcher_service = svc
        self._tokenizer = ByteTokenizer(eos_id=-1)
        self.continuous_batching = 1

    def generate(self, *args, **kwargs):
        raise AssertionError("a stream never takes the private generate() path")


SHED_TOKENS = [104, 105, 33]
SHED_WHY = "kv page pool exhausted: page pool exhausted"


class _JaxShedSvc:
    """Three tokens, then the batcher's shed: the end sentinel, then the
    future fails with 503."""

    async def submit(self, prompt, max_new_tokens=None, on_token=None, info=None, seed=None,
                     **identity):
        for tok in SHED_TOKENS + [None]:
            on_token(tok)
        raise JaxShedError(SHED_WHY)


class _PortShedSvc:
    def submit(self, prompt, max_new_tokens=None, seed=None, info=None, on_token=None,
               **identity):
        fut = Future()
        for tok in SHED_TOKENS + [None]:
            on_token(tok)
        fut.set_exception(ShedError(SHED_WHY))
        return fut


def test_shed_after_headers_is_jax_error_event():
    body = {"prompt": "hi", "stream": True}
    jport, jstop = jax_threaded_app(_Stub(_JaxShedSvc()))
    httpd, _ = start(make_component_app(_Stub(_PortShedSvc()), device="cpu"))
    try:
        _, want = sse(jport, body)
        resp, got = sse(httpd.server_address[1], body)
    finally:
        jstop()
        httpd.shutdown()
        httpd.server_close()
    assert got == want
    assert got == [{"token": t, "text": chr(t)} for t in SHED_TOKENS] + [{"error": SHED_WHY}]


def slow_steps(server, seconds=0.005):
    """Make each decode dispatch of ``server``'s batchers take at least
    ``seconds`` (streams then overlap, and a client can leave mid-stream)."""
    make = server._get_decode_step_paged

    def slowed(*key):
        prog = make(*key)

        def run(*args):
            time.sleep(seconds)
            return prog(*args)

        return run

    server._get_decode_step_paged = slowed


def wait_idle(batcher, timeout=TIMEOUT):
    t0 = time.monotonic()
    while batcher.page_stats()["kv_pages_in_use"] and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return batcher.page_stats()["kv_pages_in_use"]


def test_real_page_shed_mid_stream(params):
    """Two streams of 16-token prompts x 30 tokens on a pool of 16 pages of
    4 (each grows to 12): the newer is shed mid-stream with the error
    event; the older finishes with its solo tokens."""
    server = port_server(params, continuous_batching=2, max_new_tokens=30,
                         kv_page_size=4, kv_pool_pages=18)
    slow_steps(server)
    port, stop = port_app(server)
    a_prompt, b_prompt = list(range(40, 56)), list(range(60, 76))
    try:
        a = open_stream(port, {"prompt": a_prompt, "stream": True})
        first = read_events(a, 1)
        b = open_stream(port, {"prompt": b_prompt, "stream": True})
        b_events = read_events(b)
        a_events = first + read_events(a)
        batcher = server._batcher_service.batcher
        assert wait_idle(batcher) == 0
        assert batcher.crashed is None and batcher.page_stats()["kv_page_sheds"] == 1
    finally:
        stop()
        server._batcher_service.close()
    assert "error" not in b_events[0] and len(b_events) >= 2
    assert b_events[-1] == {"error": SHED_WHY}
    assert all(set(e) == {"token", "text"} for e in b_events[:-1])
    assert a_events[-1]["tokens"] == server.generate([a_prompt])["tokens"][0]


def test_stream_service_equals_generate(params):
    """Without continuous batching a stream goes through one shared 1-slot
    service and equals ``generate()``; ``/predict`` keeps the private
    path (the service admits nothing for it)."""
    server = port_server(params)
    port, stop = port_app(server)
    want = server.generate(["hello world"])
    try:
        _, events = sse(port, STREAMS["text"])
        svc = server._batcher_service
        assert svc.batcher.S == 1
        admitted = server._prefill_eager
        code, out = post(port, {"jsonData": {"prompt": "hello world"}}, path="/predict")
        again = sse(port, STREAMS["ids"])[1]
    finally:
        stop()
        server._batcher_service.close()
    assert [e["token"] for e in events[:-1]] == want["tokens"][0]
    assert events[-1] == {"done": True, "tokens": want["tokens"][0], "text": want["texts"][0]}
    assert code == 200 and out["jsonData"]["tokens"] == want["tokens"]
    assert server._prefill_eager == admitted + 1  # the second stream's chunk only
    assert again[-1]["tokens"] == server.generate([IDS], max_new_tokens=9)["tokens"][0]


def test_client_disconnect_leaves_batcher_serving(params):
    """A client that closes its socket after 2 events: the handler's write
    fails, the request is cancelled, its slot decodes out and its result is
    dropped; the loop never raises, every page returns, and the next
    request gets its solo tokens."""
    server = port_server(params, continuous_batching=2, max_new_tokens=40)
    slow_steps(server)
    app = make_component_app(server, device="cpu")
    httpd, _ = start(app)
    port = httpd.server_address[1]
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        body = json.dumps({"prompt": "hello world", "stream": True}).encode()
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
                     b"\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body))
        seen = b""
        while seen.count(b"data: ") < 2:
            chunk = sock.recv(4096)
            assert chunk
            seen += chunk
        sock.close()
        batcher = server._batcher_service.batcher
        assert wait_idle(batcher) == 0
        t0 = time.monotonic()
        while b'code="500"' not in app.metrics.expose() and time.monotonic() - t0 < TIMEOUT:
            time.sleep(0.01)
        assert b'method="generate"' in app.metrics.expose()
        assert b'code="500"' in app.metrics.expose()  # the write to the gone client failed
        code, out = post(port, {"prompt": "hello world", "max_new_tokens": 5})
        assert batcher.crashed is None and batcher._thread.is_alive()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server._batcher_service.close()
    assert code == 200
    assert out["tokens"] == server.generate(["hello world"], max_new_tokens=5)["tokens"][0]


def test_cancelled_submit_and_raising_callback(params):
    """A future cancelled while queued is admitted as usual and its result
    dropped; one cancelled after its first token decodes out; a callback
    that raises is logged and ignored; ``on_token`` sees every token, then
    None once; the loop never raises and the next request gets its solo
    tokens."""
    server = port_server(params)
    b = ContinuousBatcher(server, max_slots=2, page_size=8, device="cpu")
    solo = server.generate(["abc", [7, 7, 1], "hello"], max_new_tokens=8)["tokens"]
    try:
        queued = b.submit("abc", 8)
        queued.cancel()
        first = threading.Event()
        seen = []

        def on_token(tok):
            seen.append(tok)
            first.set()

        live = b.submit([7, 7, 1], 8, on_token=on_token)
        assert first.wait(TIMEOUT)
        live.cancel()

        def boom(tok):
            raise RuntimeError("a client's callback failed")

        ok = b.submit("hello", 8, on_token=boom)
        assert ok.result(TIMEOUT) == solo[2]
        assert wait_idle(b) == 0
        t0 = time.monotonic()
        while seen[-1:] != [None] and time.monotonic() - t0 < TIMEOUT:
            time.sleep(0.01)
        assert seen == solo[1] + [None]
        assert queued.cancelled() and live.cancelled()
        assert b.submit("abc", 8).result(TIMEOUT) == solo[0]
        assert b.crashed is None
    finally:
        b.close()


def test_sse_framing_one_chunk_per_event(pairs):
    """On the wire: chunked framing, each chunk exactly one ``data:`` event,
    then the zero-length chunk; Nagle is off on the handler."""
    _, pport, server = pairs(1)
    assert make_component_app(server, device="cpu").disable_nagle_algorithm is True
    body = json.dumps(STREAMS["text"]).encode()
    with socket.create_connection(("127.0.0.1", pport), timeout=TIMEOUT) as sock:
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
                     b"\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body))
        raw = b""
        while not raw.endswith(b"\r\n0\r\n\r\n"):
            chunk = sock.recv(65536)
            assert chunk, raw
            raw += chunk
    head, rest = raw.split(b"\r\n\r\n", 1)
    assert b"Transfer-Encoding: chunked" in head and b"Content-Length" not in head
    chunks = []
    while True:
        size, rest = rest.split(b"\r\n", 1)
        n = int(size, 16)
        if n == 0:
            break
        chunks.append(rest[:n])
        assert rest[n:n + 2] == b"\r\n"
        rest = rest[n + 2:]
    assert all(c.startswith(b"data: ") and c.endswith(b"\n\n") and c.count(b"data: ") == 1
               for c in chunks)
    events = [json.loads(c[6:]) for c in chunks]
    assert events[-1]["done"] is True and len(events) == COMMON["max_new_tokens"] + 1


class _BurstSvc:
    """Four tokens queued at once (a fused block's drain), then the end."""

    def submit(self, prompt, max_new_tokens=None, seed=None, info=None, on_token=None):
        fut = Future()
        for tok in [104, 105, 106, 107, None]:
            on_token(tok)
        fut.set_result([104, 105, 106, 107])
        return fut


def test_stream_events_come_in_bursts():
    """Tokens already queued when the transport wakes come out together, so
    SSE writes them in one call (one chunk each) and the done event after."""
    from seldon_core_tpu_torch.transport.streaming import stream_events

    bursts = list(stream_events(_Stub(None), "hi", 4, svc=_BurstSvc()))
    assert bursts == [[{"token": t, "text": chr(t)} for t in (104, 105, 106, 107)],
                      [{"done": True, "tokens": [104, 105, 106, 107], "text": "hijk"}]]


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_stream_and_cancelled_submit(params, mode):
    """A speculative batcher (n-gram, or the perfect drafter: a draft with
    the target's weights, so blocks of up to 5 tokens surface a drain):
    a stream's ``on_token`` events are its done tokens, then None, and
    equal ``generate()``; a future cancelled after its first token decodes
    out and is dropped; the loop keeps serving and every page returns."""
    extra = dict(draft_model="transformer", draft_model_kwargs=KW) if mode == "draft" else {}
    server = LLMServer(device="cpu", spec_mode=mode, spec_k=4, **dict(COMMON, **extra))
    server.load(params=params, draft_params=params if mode == "draft" else None)
    b = ContinuousBatcher(server, max_slots=2, page_size=8, device="cpu")
    solo = server.generate([IDS, "hello"], max_new_tokens=12)["tokens"]
    try:
        seen, cancelled, first = [], [], threading.Event()

        def on_cancelled(tok):
            cancelled.append(tok)
            first.set()

        gone = b.submit("hello", 12, on_token=on_cancelled)
        assert first.wait(TIMEOUT)
        gone.cancel()
        done = b.submit(IDS, 12, on_token=seen.append).result(TIMEOUT)
        assert wait_idle(b) == 0
        assert b.submit("hello", 12).result(TIMEOUT) == solo[1]
        assert b.crashed is None and gone.cancelled()
        assert b.spec_stats()["spec_slot_steps_total"] > 0
        if mode == "draft":
            assert b.spec_stats()["spec_tokens_per_forward"] > 2.0
    finally:
        b.close()
    assert done == solo[0] and seen == done + [None]
    assert cancelled[-1:] == [None] and cancelled[:-1] == solo[1][:len(cancelled) - 1]
