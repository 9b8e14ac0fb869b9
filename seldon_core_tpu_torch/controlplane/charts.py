"""Helm-chart rendering of the port (the in-repo subset renderer), copied
from ``seldon_core_tpu/controlplane/charts.py``: the chart files under
``deploy/charts/`` are read as data, and the output equals the JAX
package's on every chart and values file. PyYAML is imported where a chart
is read, as in the JAX package; without it ``render_chart`` raises naming
the module.

The reference packages its control plane and sample topologies as helm
charts (`helm-charts/seldon-core-operator/templates/statefulset.yaml:1-70`,
`helm-charts/seldon-mab/templates/mab.json`). This build ships real charts
under ``deploy/charts/`` — valid for stock ``helm install`` — written in a
deliberately restricted template subset so this module can render them
without the helm binary (absent from CI and this image):

    {{ .Values.a.b }}                 dotted lookups (Values/Release/Chart)
    {{ .Values.x | default "y" }}     default filter
    {{ .Values.x | toJson }}          JSON-encode a value
    {{ .Values.x | b64enc }}          base64 of the (string) value
    {{- if .Values.flag }} / {{- else }} / {{- end }}   truthiness blocks
                                      (non-nested, like the charts we ship)

Tests assert drift both ways: the operator chart rendered with default
values must equal the raw manifests (``deploy/{crd,operator}.yaml``), and
each topology chart must equal its ``deploy/examples/*.json`` CR — so
"helm user" and "kubectl apply user" can never see different objects.
"""

from __future__ import annotations

import base64
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

CHARTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "deploy", "charts",
)

_EXPR = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}")
_IF = re.compile(r"^\s*if\s+(.*)$")


def import_yaml():
    """PyYAML, imported at use (charts, YAML CRs, ``render --format
    yaml``): a machine may lack it, and then the error names it. JSON CRs
    and JSON output need no YAML."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("this needs PyYAML (the 'yaml' module), which is not installed; "
                          "JSON CRs and --format json need no YAML") from e
    return yaml


def _load_yaml(text: str) -> Any:
    return list(import_yaml().safe_load_all(text))


def _lookup(path: str, ctx: Dict[str, Any]) -> Any:
    cur: Any = ctx
    for part in path.lstrip(".").split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
        if cur is None:
            return None
    return cur


def _eval_expr(expr: str, ctx: Dict[str, Any]) -> Any:
    """`.Values.a.b | default "x" | toJson` — left-to-right pipeline."""
    parts = [p.strip() for p in expr.split("|")]
    head = parts[0]
    if head.startswith('"') and head.endswith('"'):
        value: Any = head[1:-1]
    elif head.startswith("."):
        value = _lookup(head, ctx)
    else:
        raise ValueError(f"unsupported template expression {expr!r}")
    for f in parts[1:]:
        if f.startswith("default"):
            arg = f[len("default"):].strip()
            if value in (None, ""):
                value = arg[1:-1] if arg.startswith('"') else _lookup(arg, ctx)
        elif f == "toJson":
            value = json.dumps(value)
        elif f == "b64enc":
            value = base64.b64encode(str(value).encode()).decode()
        elif f == "quote":
            value = json.dumps(str(value))
        elif f == "int":
            value = int(value)
        else:
            raise ValueError(f"unsupported template filter {f!r}")
    return value


def render_template(text: str, ctx: Dict[str, Any]) -> str:
    """Render one template file under the documented subset."""
    out: List[str] = []
    # stack of (emitting, seen_true) for if/else/end
    stack: List[List[bool]] = []

    def emitting() -> bool:
        return all(frame[0] for frame in stack)

    pos = 0
    for m in _EXPR.finditer(text):
        literal = text[pos:m.start()]
        # `{{-` trims preceding whitespace+newline, `-}}` trims following
        if m.group(0).startswith("{{-"):
            literal = literal.rstrip(" \t")
            if literal.endswith("\n"):
                literal = literal[:-1]
        if emitting():
            out.append(literal)
        expr = m.group(1)
        pos = m.end()
        if m.group(0).endswith("-}}") and pos < len(text) and text[pos] == "\n":
            pos += 1
        ifm = _IF.match(expr)
        if ifm:
            cond = bool(_eval_expr(ifm.group(1), ctx)) if emitting() else False
            stack.append([cond, cond])
            continue
        if expr == "else":
            if not stack:
                raise ValueError("else without if")
            frame = stack[-1]
            frame[0] = (not frame[1]) and all(f[0] for f in stack[:-1])
            frame[1] = frame[1] or frame[0]
            continue
        if expr == "end":
            if not stack:
                raise ValueError("end without if")
            stack.pop()
            continue
        if emitting():
            value = _eval_expr(expr, ctx)
            out.append("" if value is None else str(value))
    if stack:
        raise ValueError("unclosed if block")
    out.append(text[pos:])
    return "".join(out)


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    merged = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(merged.get(k), dict):
            merged[k] = _deep_merge(merged[k], v)
        else:
            merged[k] = v
    return merged


def render_chart(
    chart_dir: str,
    values: Optional[Dict[str, Any]] = None,
    namespace: str = "seldon-system",
    release: str = "seldon",
) -> List[Tuple[str, str]]:
    """Render every template of a chart. Returns [(template_name, text)]."""
    yaml = import_yaml()

    with open(os.path.join(chart_dir, "Chart.yaml")) as f:
        chart_meta = yaml.safe_load(f)
    with open(os.path.join(chart_dir, "values.yaml")) as f:
        default_values = yaml.safe_load(f) or {}
    ctx = {
        "Values": _deep_merge(default_values, values or {}),
        "Release": {"Name": release, "Namespace": namespace},
        "Chart": chart_meta,
    }
    tmpl_dir = os.path.join(chart_dir, "templates")
    rendered: List[Tuple[str, str]] = []
    for name in sorted(os.listdir(tmpl_dir)):
        if name.startswith("_"):
            continue
        with open(os.path.join(tmpl_dir, name)) as f:
            rendered.append((name, render_template(f.read(), ctx)))
    return rendered


def render_chart_docs(chart_dir: str, values: Optional[Dict[str, Any]] = None,
                      **kw: Any) -> List[Any]:
    """Rendered chart as parsed YAML/JSON documents (drift-test currency)."""
    docs: List[Any] = []
    for name, text in render_chart(chart_dir, values, **kw):
        if name.endswith(".json"):
            docs.append(json.loads(text))
        else:
            docs.extend(d for d in _load_yaml(text) if d is not None)
    return docs
