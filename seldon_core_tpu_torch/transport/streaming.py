"""Streaming and request identity, shared by the port's transports (REST
``/v1/generate`` with ``"stream": true`` and gRPC ``Model/GenerateStream``).

- ``check_identity``: tenant, SLO class and adapter with the reference's
  precedence (the body's field over the header or metadata; 400 for an
  unknown class, on every branch);
- ``stream_service``: the service a stream joins, and the rejections that
  come before a stream starts;
- ``stream_events``: the events of one stream (the JAX package's SSE
  events), in the bursts a drain surfaces them; with a trace, its id in the
  done event;
- ``TRACE_ID_HEADER``: where a traced stream's id goes before its first
  event (the SSE header; lower-cased, gRPC's initial metadata key).
"""

from __future__ import annotations

import queue
from typing import Any, Iterator, List, Optional

from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.runtime.resilience import ResumeMarker
from seldon_core_tpu_torch.runtime.scheduler import normalize_slo_class

_END = object()

TRACE_ID_HEADER = "X-Trace-Id"


def check_identity(body: dict, tenant: Optional[str], slo_class: Optional[str],
                   deadline_s: Optional[float] = None) -> dict:
    """The request's identity for ``submit``, with the reference's
    precedence: the body's ``tenant`` / ``slo_class``, then ``tenant`` /
    ``slo_class`` (a header's or metadata's value); the body's ``adapter``;
    ``deadline_s`` (the client's budget, when it sent one). An unknown class
    raises 400 here, on every branch, before anything is served."""
    tenant = body.get("tenant") or tenant
    slo_class = body.get("slo_class") or slo_class
    try:
        normalize_slo_class(slo_class)
    except ValueError as e:
        raise SeldonError(str(e), status_code=400)
    return {"tenant": tenant, "slo_class": slo_class, "adapter": body.get("adapter"),
            "deadline_s": deadline_s}


def stream_events(component: Any, prompt: Any, max_new: Optional[int],
                  seed: Optional[int] = None, svc: Any = None,
                  identity: Optional[dict] = None, trace: Any = None) -> Iterator[List[dict]]:
    """The events of one stream, as the batch decodes them: ``{"token",
    "text"}`` per token (``text`` the decoded piece of a text prompt, else
    None), ``{"resumed": True, "tokens_delivered": n}`` where a replica
    fleet resumed the generation on a survivor after n delivered tokens (an
    in-band event, never a token), then ``{"done": True, "tokens",
    "text"}`` (+ ``truncated_prompt`` when admission clipped the prompt). They come in bursts, a list at a
    time: every token already queued when the caller wakes (a fused block's
    tokens surface at one drain), so a transport writes a burst at once.
    ``svc`` is the BatcherService to join; None streams through
    ``ensure_stream_service``; ``identity`` the tenant, class, adapter and
    deadline (``check_identity``); ``trace`` the ingress's ``TraceContext``
    (its ``trace_id`` rides the done event). The batcher's ``on_token`` only puts on a
    queue; decoding and JSON happen on the caller's thread. Closing the
    generator early (a disconnect) cancels the request; a failure raises
    from it, after the tokens that came before it."""
    from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service

    if svc is None:
        svc = ensure_stream_service(component)
    tokenizer = getattr(component, "_tokenizer", None)
    text_mode = tokenizer is not None and isinstance(prompt, str)
    q: queue.Queue = queue.Queue()
    info: dict = {}
    identity = dict(identity or {})
    if trace is not None:
        identity["trace"] = trace
    fut = svc.submit(prompt, max_new, on_token=q.put, seed=seed, info=info, **identity)
    # a request that ends without its None (never, from the batcher) still
    # ends the pump
    fut.add_done_callback(lambda _f: q.put(_END))
    try:
        ended = False
        while not ended:
            burst = [q.get()]
            while burst[-1] is not None and burst[-1] is not _END:
                try:
                    burst.append(q.get_nowait())
                except queue.Empty:
                    break
            ended = burst[-1] is None or burst[-1] is _END
            toks = burst[:-1] if ended else burst
            if toks:
                yield [_event(t, tokenizer if text_mode else None) for t in toks]
        toks = fut.result(timeout=600.0)
        done = {"done": True, "tokens": toks,
                "text": tokenizer.decode(toks) if text_mode else None}
        if trace is not None:
            done["trace_id"] = trace.trace_id
        if info.get("truncated_prompt"):
            done["truncated_prompt"] = info["truncated_prompt"]
        yield [done]
    finally:
        fut.cancel()  # a no-op once the request completed


def _event(tok: Any, tokenizer: Any) -> dict:
    """One stream event: a token (with its decoded piece when ``tokenizer``
    is given), or a fleet's resume marker."""
    if isinstance(tok, ResumeMarker):
        return {"resumed": True, "tokens_delivered": tok.tokens_delivered}
    return {"token": tok, "text": tokenizer.decode([tok]) if tokenizer is not None else None}


def stream_service(component: Any, body: dict, svc: Any = None, knob: str = "stream") -> Any:
    """The service a stream of ``body`` joins: ``svc`` (the component's
    shared batch), else the 1-slot stream service. Raises the rejections
    that come before a stream starts (400): a per-request temperature (the
    batch decodes at the server's), and a seeded prompt the slot cache
    cannot hold whole (no private generate() path reproduces it there);
    ``knob`` names what the client should drop, in the JAX package's words
    for its transport. An adapted stream is served like any other (its
    adapter is resolved at submit)."""
    from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service

    if "temperature" in body:
        raise SeldonError("streaming with per-request temperature is not supported; set it "
                          "on the server", status_code=400)
    if "seed" in body:
        svc = svc if svc is not None else ensure_stream_service(component)
        if not svc.batcher.accommodates(body.get("prompt"), body.get("max_new_tokens")):
            raise SeldonError("seeded streaming prompt exceeds the batcher slot cache and "
                              "would not reproduce generate(seed=...); raise "
                              f"continuous_batching_max_len or drop {knob}", status_code=400)
    return svc


__all__ = ["TRACE_ID_HEADER", "check_identity", "stream_events", "stream_service"]
