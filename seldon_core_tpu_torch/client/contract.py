"""Contract-based payload fuzzing: a copy of
``seldon_core_tpu/client/contract.py`` (the reference's
`python/seldon_core/microservice_tester.py:83-155` and
`serving_test_gen.py:61`). A ``contract.json`` describes each feature
(continuous range or categorical values, dtype, shape); the tester samples
random conforming batches, fires them at an endpoint, and checks the
response against the target schema.

Contract shape::

    {"features": [{"name": "f1", "ftype": "continuous", "dtype": "FLOAT",
                   "range": [0, 1], "shape": [2]},   # optional shape => repeat
                  {"name": "c", "ftype": "categorical", "values": ["a", "b"]}],
     "targets":  [...same...]}

``range`` endpoints may be the string "inf"/"-inf" for unbounded sides.
``contract_from_dataframe`` takes a pandas DataFrame; nothing here imports
pandas.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional

import numpy as np


class ContractError(Exception):
    pass


def load_contract(path: str) -> Dict[str, Any]:
    with open(path) as f:
        contract = json.load(f)
    if "features" not in contract:
        raise ContractError("contract.json must have a 'features' list")
    return unfold_contract(contract)


def unfold_contract(contract: Dict[str, Any]) -> Dict[str, Any]:
    """Expand features carrying a ``shape`` into scalar features f:0..n, as
    the reference does (`microservice_tester.py:112-154`)."""
    out = {"features": [], "targets": []}
    for field in ("features", "targets"):
        for feature in contract.get(field, []):
            shape = feature.get("shape")
            n = int(np.prod(shape)) if shape else 1
            if n == 1:
                out[field].append(dict(feature))
            else:
                for i in range(n):
                    f = dict(feature)
                    f.pop("shape", None)
                    f["name"] = f"{feature.get('name', 'f')}:{i}"
                    out[field].append(f)
    return out


def _gen_continuous(rng: np.random.Generator, f_range, n: int) -> np.ndarray:
    lo, hi = (f_range or ["-inf", "inf"])[:2]
    lo_inf = lo in ("inf", "-inf") or (isinstance(lo, float) and math.isinf(lo))
    hi_inf = hi in ("inf", "-inf") or (isinstance(hi, float) and math.isinf(hi))
    if lo_inf and hi_inf:
        return rng.normal(size=n)
    if lo_inf:
        return float(hi) - rng.lognormal(size=n)
    if hi_inf:
        return float(lo) + rng.lognormal(size=n)
    return rng.uniform(float(lo), float(hi), size=n)


def generate_batch(
    contract: Dict[str, Any],
    n: int,
    field: str = "features",
    seed: Optional[int] = None,
) -> np.ndarray:
    """Sample an (n, n_features) batch conforming to the contract. Columns
    with categorical values produce an object array, matching the reference's
    mixed-type behavior."""
    rng = np.random.default_rng(seed)
    contract = unfold_contract(contract)
    cols: List[np.ndarray] = []
    categorical = False
    for feature in contract[field]:
        ftype = feature.get("ftype", "continuous")
        if ftype == "continuous":
            col = _gen_continuous(rng, feature.get("range"), n)
            if feature.get("dtype") == "INT":
                col = np.floor(col + 0.5)
            cols.append(col)
        elif ftype == "categorical":
            values = feature.get("values")
            if not values:
                raise ContractError(f"categorical feature {feature.get('name')} needs 'values'")
            cols.append(np.asarray(values)[rng.integers(len(values), size=n)])
            categorical = True
        else:
            raise ContractError(f"unknown ftype {ftype!r}")
    if not cols:
        raise ContractError(f"contract field {field!r} is empty")
    dtype = object if categorical else np.float64
    return np.stack([c.astype(dtype) for c in cols], axis=1)


def feature_names(contract: Dict[str, Any], field: str = "features") -> List[str]:
    return [f.get("name", f"f{i}") for i, f in enumerate(unfold_contract(contract)[field])]


def validate_response(contract: Dict[str, Any], response: np.ndarray) -> List[str]:
    """Check a response batch against the target schema: column count, ranges,
    categorical membership. Returns a list of violation strings (empty = ok)."""
    contract = unfold_contract(contract)
    targets = contract.get("targets", [])
    problems: List[str] = []
    arr = np.atleast_2d(np.asarray(response))
    if not targets:
        return problems
    if arr.shape[1] != len(targets):
        return [f"expected {len(targets)} target columns, got {arr.shape[1]}"]
    for j, target in enumerate(targets):
        col = arr[:, j]
        name = target.get("name", f"t{j}")
        if target.get("ftype", "continuous") == "categorical":
            allowed = set(map(str, target.get("values", [])))
            bad = [v for v in col if str(v) not in allowed]
            if bad:
                problems.append(f"{name}: values {bad[:3]} outside {sorted(allowed)}")
            continue
        f_range = target.get("range")
        if not f_range:
            continue
        lo, hi = f_range[:2]
        vals = col.astype(np.float64)
        if lo not in ("inf", "-inf") and np.any(vals < float(lo)):
            problems.append(f"{name}: value below range min {lo}")
        if hi not in ("inf", "-inf") and np.any(vals > float(hi)):
            problems.append(f"{name}: value above range max {hi}")
    return problems


def contract_from_dataframe(df, n_categorical_threshold: int = 20) -> Dict[str, Any]:
    """Build a contract from a pandas DataFrame (capability of
    `serving_test_gen.py:61`): low-cardinality object/int columns become
    categorical, numeric columns become continuous with observed ranges."""
    features = []
    for col in df.columns:
        s = df[col]
        numeric = s.dtype.kind in "biufc"
        if not numeric or (s.dtype.kind in "iu" and s.nunique() <= n_categorical_threshold):
            features.append(
                {
                    "name": str(col),
                    "ftype": "categorical",
                    "dtype": "INT" if numeric else "STRING",
                    "values": [str(v) for v in sorted(s.unique(), key=str)],
                }
            )
        else:
            features.append(
                {
                    "name": str(col),
                    "ftype": "continuous",
                    "dtype": "INT" if s.dtype.kind in "iu" else "FLOAT",
                    "range": [float(s.min()), float(s.max())],
                }
            )
    return {"features": features, "targets": []}
