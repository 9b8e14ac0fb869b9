"""Client tools of the port: ``SeldonClient`` (``client.py``), contract
fuzzing (``contract.py``), the contract testers (``testers.py``) and the
closed-loop load generator (``loadgen.py``). All run on the host over the
standard library (and grpcio for gRPC); none needs aiohttp or requests."""

from seldon_core_tpu_torch.client.client import ClientResponse, SeldonClient
from seldon_core_tpu_torch.client.contract import (
    generate_batch,
    load_contract,
    unfold_contract,
    validate_response,
)

__all__ = [
    "SeldonClient",
    "ClientResponse",
    "generate_batch",
    "load_contract",
    "unfold_contract",
    "validate_response",
]
