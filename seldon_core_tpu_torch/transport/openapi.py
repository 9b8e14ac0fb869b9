"""The OpenAPI spec served at /seldon.json.

Copied from ``seldon_core_tpu/transport/openapi.py`` (host-only; the port
imports nothing of the JAX package): ``wrapper_spec``, the microservice
API, and ``engine_spec``, the engine's, built programmatically."""

from __future__ import annotations

from typing import Any, Dict

from seldon_core_tpu_torch import __version__

_SELDON_MESSAGE_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "status": {
            "type": "object",
            "properties": {
                "code": {"type": "integer"},
                "info": {"type": "string"},
                "reason": {"type": "string"},
                "status": {"type": "string", "enum": ["SUCCESS", "FAILURE"]},
            },
        },
        "meta": {
            "type": "object",
            "properties": {
                "puid": {"type": "string"},
                "tags": {"type": "object"},
                "routing": {"type": "object", "additionalProperties": {"type": "integer"}},
                "requestPath": {"type": "object", "additionalProperties": {"type": "string"}},
                "metrics": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "properties": {
                            "key": {"type": "string"},
                            "type": {"type": "string", "enum": ["COUNTER", "GAUGE", "TIMER"]},
                            "value": {"type": "number"},
                            "tags": {"type": "object"},
                        },
                    },
                },
            },
        },
        "data": {
            "type": "object",
            "properties": {
                "names": {"type": "array", "items": {"type": "string"}},
                "tensor": {
                    "type": "object",
                    "properties": {
                        "shape": {"type": "array", "items": {"type": "integer"}},
                        "values": {"type": "array", "items": {"type": "number"}},
                    },
                },
                "ndarray": {"type": "array"},
            },
        },
        "binData": {"type": "string", "format": "byte"},
        "strData": {"type": "string"},
        "jsonData": {},
    },
}

_FEEDBACK_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "request": {"$ref": "#/components/schemas/SeldonMessage"},
        "response": {"$ref": "#/components/schemas/SeldonMessage"},
        "reward": {"type": "number"},
        "truth": {"$ref": "#/components/schemas/SeldonMessage"},
    },
}


def _base(title: str) -> Dict[str, Any]:
    return {
        "openapi": "3.0.0",
        "info": {"title": title, "version": __version__},
        "components": {
            "schemas": {
                "SeldonMessage": _SELDON_MESSAGE_SCHEMA,
                "Feedback": _FEEDBACK_SCHEMA,
                "SeldonMessageList": {
                    "type": "object",
                    "properties": {
                        "seldonMessages": {
                            "type": "array",
                            "items": {"$ref": "#/components/schemas/SeldonMessage"},
                        }
                    },
                },
            }
        },
        "paths": {},
    }


def _op(request_schema: str, summary: str) -> Dict[str, Any]:
    return {
        "post": {
            "summary": summary,
            "requestBody": {
                "content": {
                    "application/json": {"schema": {"$ref": f"#/components/schemas/{request_schema}"}}
                }
            },
            "responses": {
                "200": {
                    "description": "SeldonMessage response",
                    "content": {
                        "application/json": {"schema": {"$ref": "#/components/schemas/SeldonMessage"}}
                    },
                }
            },
        }
    }


def wrapper_spec() -> Dict[str, Any]:
    spec = _base("seldon-core-tpu microservice API")
    spec["paths"] = {
        "/predict": _op("SeldonMessage", "Model predict"),
        "/transform-input": _op("SeldonMessage", "Transform input"),
        "/transform-output": _op("SeldonMessage", "Transform output"),
        "/route": _op("SeldonMessage", "Route"),
        "/aggregate": _op("SeldonMessageList", "Aggregate"),
        "/send-feedback": _op("Feedback", "Send feedback"),
    }
    return spec


def engine_spec() -> Dict[str, Any]:
    spec = _base("seldon-core-tpu engine API")
    spec["paths"] = {
        "/api/v0.1/predictions": _op("SeldonMessage", "Predict through the graph"),
        "/api/v0.1/feedback": _op("Feedback", "Send feedback through the graph"),
    }
    return spec


__all__ = ["engine_spec", "wrapper_spec"]
