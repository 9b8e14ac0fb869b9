"""Contract testers of the port, copied from
``seldon_core_tpu/client/testers.py``: fire random conforming payloads at a
live endpoint and validate the round trip (the reference's CLIs
`seldon-core-tester`, microservice-direct, `microservice_tester.py`, and
`seldon-core-api-tester`, engine, `api_tester.py`). Exposed as ``python -m
seldon_core_tpu_torch.transport.cli tester|api-tester``, with the JAX
package's arguments.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from seldon_core_tpu_torch.client.client import SeldonClient
from seldon_core_tpu_torch.client.contract import (
    feature_names,
    generate_batch,
    load_contract,
    validate_response,
)


def run_contract_test(
    contract_path: str,
    host: str,
    port: int,
    n_requests: int = 1,
    batch_size: int = 1,
    grpc: bool = False,
    endpoint_kind: str = "microservice",
    method: str = "predict",
    seed: Optional[int] = None,
    show: bool = False,
) -> int:
    """Returns the number of failed requests (0 = success)."""
    contract = load_contract(contract_path)
    client = SeldonClient(
        host=host,
        port=port,
        transport="grpc" if grpc else "rest",
        endpoint_kind=endpoint_kind,
        names=feature_names(contract),
    )
    failures = 0
    for i in range(n_requests):
        batch = generate_batch(contract, batch_size, seed=None if seed is None else seed + i)
        if batch.dtype == object:
            payload = batch.tolist()  # mixed categorical -> ndarray JSON payload
        else:
            payload = batch
        if method == "predict":
            resp = client.predict(payload)
        elif method == "send-feedback":
            request_msg = {"data": {"ndarray": batch.tolist()}}
            resp = client.feedback(request=request_msg, reward=1.0)
        else:
            raise ValueError(f"unknown method {method}")
        ok = resp.success
        problems = []
        if ok and method == "predict" and resp.data is not None:
            problems = validate_response(contract, resp.data)
            ok = not problems
        if show or not ok:
            print(f"[{i}] success={resp.success} problems={problems} error={resp.error}")
            if resp.raw is not None:
                print(json.dumps(resp.raw)[:2000])
        failures += 0 if ok else 1
    print(f"{n_requests - failures}/{n_requests} requests passed")
    return failures


def add_tester_args(p: argparse.ArgumentParser, endpoint_kind: str) -> None:
    p.add_argument("contract", help="path to contract.json")
    p.add_argument("host")
    p.add_argument("port", type=int)
    p.add_argument("-n", "--n-requests", type=int, default=1)
    p.add_argument("-b", "--batch-size", type=int, default=1)
    p.add_argument("--grpc", action="store_true")
    p.add_argument("--endpoint", default="predict", choices=["predict", "send-feedback"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("-p", "--prnt", action="store_true", help="print every request/response")
    p.set_defaults(_endpoint_kind=endpoint_kind)


def tester_main(args: argparse.Namespace) -> None:
    failures = run_contract_test(
        args.contract,
        args.host,
        args.port,
        n_requests=args.n_requests,
        batch_size=args.batch_size,
        grpc=args.grpc,
        endpoint_kind=args._endpoint_kind,
        method=args.endpoint,
        seed=args.seed,
        show=args.prnt,
    )
    if failures:
        sys.exit(1)
