"""Error payload of the port: ``SeldonError`` and its ``Status``.

Copied from ``seldon_core_tpu/contracts/payload.py`` — only what the LLM
component and the REST layer need. The wire shape is the reference's
proto-JSON status: ``{"status": {"code", "info", "reason", "status"}}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


class SeldonError(Exception):
    """Framework error carrying an HTTP-ish status code and structured payload."""

    status_code = 400

    def __init__(self, message: str, status_code: Optional[int] = None, reason: str = "MICROSERVICE_BAD_DATA"):
        super().__init__(message)
        self.message = message
        if status_code is not None:
            self.status_code = status_code
        self.reason = reason

    def to_status(self) -> "Status":
        return Status(code=self.status_code, info=self.message, reason=self.reason, status="FAILURE")


@dataclass(slots=True)
class Status:
    """Outcome status (`proto/prediction.proto:64-75`)."""

    code: int = 200
    info: str = ""
    reason: str = ""
    status: str = "SUCCESS"  # SUCCESS | FAILURE

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "info": self.info, "reason": self.reason, "status": self.status}


__all__ = ["SeldonError", "Status"]
