"""Closed-loop load generator for the REST and gRPC serving endpoints, ported
from ``seldon_core_tpu/benchmarks/loadgen.py`` (the reference's locust
drivers, `util/loadtester/scripts/predict_rest_locust.py:17-80`,
`predict_grpc_locust.py`): N clients fire predict requests (a fixed
tensor or contract-fuzzed payloads), each its next when the last one
answers; the report gives throughput and latency percentiles.

Both transports run one thread a client, over the standard library: REST
holds one keep-alive ``http.client`` connection a thread to
``/api/v0.1/predictions`` (the JAX package drives aiohttp, which the card's
machine does not carry), gRPC calls ``Seldon/Predict`` through
``transport/grpc_client.py``. A warm-up of ``min(4, clients)`` clients for
``warmup_s`` runs first and is left out of the report; pass
``warmup_stats={}`` to get its request and error counts. The report has the
JAX package's keys: ``transport, clients, duration_s, requests, errors,
rps, p50_ms, p90_ms, p95_ms, p99_ms, mean_ms, max_ms``.

Used by the ``loadtest`` CLI subcommand, which prints the report as one
JSON line.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np


def percentile_stats(latencies_s) -> Dict[str, float]:
    lat = np.asarray(sorted(latencies_s))
    if lat.size == 0:
        return {}
    pct = lambda p: float(np.percentile(lat, p) * 1000.0)  # noqa: E731
    return {
        "p50_ms": round(pct(50), 3),
        "p90_ms": round(pct(90), 3),
        "p95_ms": round(pct(95), 3),
        "p99_ms": round(pct(99), 3),
        "mean_ms": round(float(lat.mean() * 1000.0), 3),
        "max_ms": round(float(lat.max() * 1000.0), 3),
    }


REQUEST_TIMEOUT_S = 60.0   # a REST request that takes longer counts as an error

# a caller factory: () -> (one request -> ok, close)
Caller = Callable[[], Tuple[Callable[[], bool], Callable[[], None]]]


def _phase(make_caller: Caller, clients: int, seconds: float) -> Tuple[List[float], int, float]:
    """``clients`` threads in a closed loop for ``seconds``: the latencies
    of the requests answered 200 (s), the failed count, and the wall from
    the start to the last thread's end."""
    latencies: List[float] = []
    errors = [0]
    lock = threading.Lock()
    start = time.perf_counter()
    stop_at = start + seconds

    def worker():
        call, close = make_caller()
        try:
            while time.perf_counter() < stop_at:
                t0 = time.perf_counter()
                try:
                    ok = call()
                except Exception:
                    ok = False
                dt = time.perf_counter() - t0
                with lock:
                    if ok:
                        latencies.append(dt)
                    else:
                        errors[0] += 1
        finally:
            close()

    threads = [threading.Thread(target=worker, name=f"loadgen-{i}", daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return latencies, errors[0], time.perf_counter() - start


def _run(transport: str, make_caller: Caller, clients: int, duration_s: float, warmup_s: float,
         warmup_stats: Optional[dict]) -> Dict[str, Any]:
    warm, warm_errors, _ = _phase(make_caller, min(4, clients), warmup_s)
    if warmup_stats is not None:
        warmup_stats.update(requests=len(warm), errors=warm_errors)
    latencies, errors, elapsed = _phase(make_caller, clients, duration_s)
    return {
        "transport": transport,
        "clients": clients,
        "duration_s": round(elapsed, 3),
        "requests": len(latencies),
        "errors": errors,
        "rps": round(len(latencies) / elapsed, 2) if elapsed > 0 else 0.0,
        **percentile_stats(latencies),
    }


def run_rest_load(
    url: str,
    payload_fn: Callable[[], Dict[str, Any]],
    clients: int = 16,
    duration_s: float = 10.0,
    warmup_s: float = 1.0,
    warmup_stats: Optional[dict] = None,
) -> Dict[str, Any]:
    """Closed loop over REST: each client thread POSTs ``payload_fn()`` as
    JSON to ``url`` on its own keep-alive connection, its next request when
    the last one answers (the locust model); a request is answered when
    its status is 200. A connection that fails is reopened."""
    parts = urlsplit(url)
    path = parts.path + (f"?{parts.query}" if parts.query else "")

    def make_caller():
        conn = http.client.HTTPConnection(parts.hostname, parts.port or 80,
                                          timeout=REQUEST_TIMEOUT_S)

        def call() -> bool:
            try:
                conn.request("POST", path, body=json.dumps(payload_fn()).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
            except Exception:
                conn.close()   # the next request reconnects
                raise
            return resp.status == 200

        return call, conn.close

    return _run("rest", make_caller, clients, duration_s, warmup_s, warmup_stats)


def run_grpc_load(
    target: str,
    payload_fn: Callable[[], Any],
    clients: int = 8,
    duration_s: float = 10.0,
    warmup_s: float = 1.0,
    service: str = "Seldon",
    warmup_stats: Optional[dict] = None,
) -> Dict[str, Any]:
    """Closed loop over gRPC: each client thread calls ``<service>/Predict``
    with ``payload_fn()`` (a SeldonMessage) over the cached channel."""
    from seldon_core_tpu_torch.transport import grpc_client

    def make_caller():
        def call() -> bool:
            grpc_client.call_sync(target, "Predict", payload_fn(), service=service)
            return True

        return call, lambda: None

    return _run("grpc", make_caller, clients, duration_s, warmup_s, warmup_stats)


def default_payload_fn(contract_path: Optional[str] = None, batch: int = 1):
    """Random contract-conforming payloads, or a fixed [batch, 2] tensor."""
    if contract_path:
        from seldon_core_tpu_torch.client.contract import generate_batch, load_contract

        contract = load_contract(contract_path)

        def fn():
            arr = generate_batch(contract, batch)
            return {"data": {"ndarray": arr.tolist()}}

        return fn
    fixed = {"data": {"tensor": {"shape": [batch, 2], "values": [1.0, 2.0] * batch}}}
    return lambda: fixed


def main(args) -> None:
    payload_fn = default_payload_fn(args.contract, args.batch)
    if args.grpc:
        from seldon_core_tpu_torch.contracts.payload import SeldonMessage

        json_fn = payload_fn
        msg_fn = lambda: SeldonMessage.from_dict(json_fn())  # noqa: E731
        report = run_grpc_load(f"{args.host}:{args.port}", msg_fn, clients=args.clients,
                               duration_s=args.duration)
    else:
        url = f"http://{args.host}:{args.port}/api/v0.1/predictions"
        report = run_rest_load(url, payload_fn, clients=args.clients, duration_s=args.duration)
    print(json.dumps(report))


__all__ = ["default_payload_fn", "main", "percentile_stats", "run_grpc_load", "run_rest_load"]
