"""Kubernetes Quantity / IntOrString parsing of the port, copied from
``seldon_core_tpu/controlplane/quantity.py``.

The reference vendors a 2.1k-line protobuf JsonFormat to accept k8s
`resource.Quantity` ("500m", "1Gi") and `IntOrString` values inside
componentSpecs (`engine/src/main/java/io/seldon/engine/pb/
{QuantityUtils,IntOrStringUtils}.java`). The dataclass-based spec here needs
only the value semantics: parse the suffix grammar to a float so the
validator can check CR resource requests and the renderer can compare/scale
them.
"""

from __future__ import annotations

import re
from typing import Union

# k8s suffix grammar: decimal SI (n, u, m, k, M, G, ...), binary
# (Ki, Mi, ...). Plain scientific notation (e.g. "1e3") is also legal.
_SUFFIXES = {
    "n": 1e-9, "u": 1e-6, "m": 1e-3,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}

_QUANTITY_RE = re.compile(
    r"^(?P<num>[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
    r"(?P<suffix>n|u|m|k|Ki|[MGTPE]i?)?$"
)


def parse_quantity(value: Union[str, int, float]) -> float:
    """'500m' -> 0.5, '1Gi' -> 1073741824.0, 2 -> 2.0. Raises ValueError on
    anything outside the Quantity grammar (matching the k8s API's rejection)."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    num = float(m.group("num"))
    suffix = m.group("suffix")
    if not suffix:
        return num
    factor = _SUFFIXES.get(suffix)
    if factor is None:  # regex/table drift must stay a ValueError
        raise ValueError(f"invalid quantity suffix {suffix!r}")
    return num * factor


def parse_int_or_string(value: Union[str, int]) -> Union[int, str]:
    """k8s IntOrString: ints pass through, numeric strings become ints,
    percent strings ('25%') and names stay strings (their k8s meaning is
    field-specific)."""
    if isinstance(value, bool):
        raise ValueError(f"invalid IntOrString {value!r}")
    if isinstance(value, int):
        return value
    s = str(value).strip()
    if re.fullmatch(r"[+-]?\d+", s):
        return int(s)
    return s


def validate_resources(resources: dict, path: str, problems: list) -> None:
    """Check every quantity in a k8s resources block ({limits,requests});
    appends problem strings in the validator's format."""
    for section in ("limits", "requests"):
        for key, value in (resources.get(section) or {}).items():
            try:
                q = parse_quantity(value)
            except ValueError:
                problems.append(f"{path}.{section}.{key}: invalid quantity {value!r}")
                continue
            if q < 0:
                problems.append(f"{path}.{section}.{key}: negative quantity {value!r}")
