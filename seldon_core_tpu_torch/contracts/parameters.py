"""Typed unit parameters: copied from ``seldon_core_tpu/contracts/parameters.py``.

The reference delivers per-unit parameters as JSON
``[{"name": ..., "type": "INT|FLOAT|DOUBLE|STRING|BOOL", "value": ...}]`` in
the ``PREDICTIVE_UNIT_PARAMETERS`` env var and coerces values by declared type
(`python/seldon_core/microservice.py:50-87`,
`engine/.../PredictiveUnitState.java:114-120`). Same contract here.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.contracts.payload import SeldonError

_COERCERS = {
    "INT": int,
    "FLOAT": float,
    "DOUBLE": float,
    "STRING": str,
    "BOOL": lambda v: v if isinstance(v, bool) else str(v).lower() in ("true", "1", "yes"),
}


@dataclass(slots=True)
class Parameter:
    name: str
    value: Any
    type: str = "STRING"

    def typed_value(self) -> Any:
        coercer = _COERCERS.get(self.type.upper())
        if coercer is None:
            raise SeldonError(f"Unknown parameter type {self.type!r} for {self.name!r}")
        try:
            return coercer(self.value)
        except (TypeError, ValueError) as e:
            raise SeldonError(f"Cannot coerce parameter {self.name!r}={self.value!r} to {self.type}: {e}")

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "value": str(self.value), "type": self.type}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Parameter":
        if "name" not in d:
            raise SeldonError("parameter requires a name")
        return cls(name=d["name"], value=d.get("value"), type=d.get("type", "STRING") or "STRING")


def parse_parameters(raw: Optional[str] = None, env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Parse the PREDICTIVE_UNIT_PARAMETERS contract into {name: typed value}."""
    if raw is None:
        env = env if env is not None else dict(os.environ)
        raw = env.get("PREDICTIVE_UNIT_PARAMETERS", "[]")
    try:
        items = json.loads(raw)
    except json.JSONDecodeError as e:
        raise SeldonError(f"PREDICTIVE_UNIT_PARAMETERS is not valid JSON: {e}")
    if not isinstance(items, list):
        raise SeldonError("PREDICTIVE_UNIT_PARAMETERS must be a JSON list")
    return {p.name: p.typed_value() for p in (Parameter.from_dict(i) for i in items)}


__all__ = ["Parameter", "parse_parameters"]
