"""gRPC client of the port: a channel cache and typed calls, copied from
``seldon_core_tpu/transport/grpc_client.py`` over the port's own stubs
(``transport/proto/prediction_pb2.py``) and converters
(``transport/proto_convert.py``).

The role of the reference's `engine/.../grpc/GrpcChannelHandler.java` (the
channel cache) and the stub calls of `InternalPredictionService.java:261-283`:
``call_sync`` and ``call_stream`` for a thread, ``unary_call`` for the
remote graph nodes (``runtime/remote.py``).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, Optional, Tuple

import grpc

from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonMessage, SeldonMessageList
from seldon_core_tpu_torch.transport import proto_convert as pc
from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb

# An entry holds (channel, credentials): the strong reference pins the
# credentials' id() for the entry's life, so a recycled id never aliases a
# dead credential's channel.
_channels: Dict[Tuple[str, tuple, Optional[int]], Tuple[grpc.Channel, Any]] = {}
_lock = threading.Lock()

# method -> the service that owns it
_METHODS = {
    "Predict": "Model",
    "TransformInput": "Generic",
    "TransformOutput": "Generic",
    "Route": "Router",
    "Aggregate": "Combiner",
    "SendFeedback": "Model",
    "DebugTimeline": "Model",
}


def make_channel_credentials(ca_cert: Optional[str] = None, client_cert: Optional[str] = None,
                             client_key: Optional[str] = None) -> grpc.ChannelCredentials:
    """TLS channel credentials from PEM file paths: the system roots without
    paths, mutual TLS with a cert and key."""

    def read(path: Optional[str]) -> Optional[bytes]:
        if path is None:
            return None
        with open(path, "rb") as f:
            return f.read()

    return grpc.ssl_channel_credentials(root_certificates=read(ca_cert),
                                        private_key=read(client_key),
                                        certificate_chain=read(client_cert))


def get_channel(target: str, options: Optional[list] = None,
                credentials: Optional[grpc.ChannelCredentials] = None) -> grpc.Channel:
    """One cached channel per (target, options, credentials object): two
    clients with different TLS material never share one."""
    key = (target, tuple(options or ()), id(credentials) if credentials is not None else None)
    with _lock:
        entry = _channels.get(key)
        if entry is None:
            if credentials is not None:
                ch = grpc.secure_channel(target, credentials, options=options)
            else:
                ch = grpc.insecure_channel(target, options=options)
            _channels[key] = entry = (ch, credentials)
        return entry[0]


def _to_proto(msg: Any):
    if isinstance(msg, SeldonMessage):
        return pc.message_to_proto(msg)
    if isinstance(msg, SeldonMessageList):
        return pc.list_to_proto(msg)
    if isinstance(msg, Feedback):
        return pc.feedback_to_proto(msg)
    return msg  # already a proto


def call_sync(target: str, method: str, msg: Any, service: Optional[str] = None,
              timeout_s: Optional[float] = 5.0, options: Optional[list] = None,
              credentials: Optional[grpc.ChannelCredentials] = None,
              metadata: Optional[list] = None) -> SeldonMessage:
    """One unary call; raises ``grpc.RpcError`` as the stub does."""
    if method not in _METHODS:
        raise ValueError(f"Unknown gRPC method {method}")
    service = service or _METHODS[method]
    rpc = get_channel(target, options, credentials).unary_unary(
        f"/seldon.protos.{service}/{method}",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=pb.SeldonMessage.FromString)
    return pc.message_from_proto(rpc(_to_proto(msg), timeout=timeout_s, metadata=metadata))


def call_stream(target: str, method: str, msg: Any, service: str = "Model",
                timeout_s: float = 120.0, options: Optional[list] = None,
                credentials: Optional[grpc.ChannelCredentials] = None,
                metadata: Optional[list] = None):
    """A server-streaming call (``Model/GenerateStream``): yields the
    SeldonMessages as the server sends them, the gRPC mirror of SSE."""
    rpc = get_channel(target, options, credentials).unary_stream(
        f"/seldon.protos.{service}/{method}",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=pb.SeldonMessage.FromString)
    for out in rpc(_to_proto(msg), timeout=timeout_s, metadata=metadata):
        yield pc.message_from_proto(out)


async def unary_call(target: str, method: str, msg: Any, service: Optional[str] = None,
                     timeout_s: Optional[float] = 5.0,
                     metadata: Optional[list] = None) -> SeldonMessage:
    """``call_sync`` in a worker thread, for the remote nodes; ``metadata``
    carries keys such as ``traceparent``."""
    return await asyncio.to_thread(call_sync, target, method, msg, service, timeout_s, None,
                                   None, metadata)


__all__ = ["call_stream", "call_sync", "get_channel", "make_channel_credentials",
           "unary_call"]
