"""Prometheus rules and the Grafana dashboard of the port, ported from
``seldon_core_tpu/observability/dashboards.py`` (the reference's analytics
chart, `helm-charts/seldon-core-analytics/files/`: prometheus-config.yaml,
alert rules and the predictions-analytics Grafana dashboard). The
artifacts query the metric names the port registers
(``metrics/registry.py``), which are the JAX package's, so both packages
render the same files.

``python -m seldon_core_tpu_torch.transport.cli analytics --out DIR`` writes
them. PyYAML is imported by ``write_artifacts`` alone; where it is missing
that raises naming it (``controlplane/charts.import_yaml``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

# the names registered in metrics/registry.py
REQUESTS_TOTAL = "seldon_api_executor_server_requests_total"
REQUESTS_SECONDS = "seldon_api_executor_server_requests_seconds"
FEEDBACK_TOTAL = "seldon_api_model_feedback_total"
FEEDBACK_REWARD = "seldon_api_model_feedback_reward_total"
# the request timeline (tracing and the flight recorder)
TTFT_SECONDS = "seldon_llm_ttft_seconds"
INTER_TOKEN_SECONDS = "seldon_llm_inter_token_seconds"
TRACES_RETAINED = "seldon_llm_traces_retained_total"
TRACE_SPANS_DROPPED = "seldon_trace_spans_dropped_total"
TRACE_EXPORT_SECONDS = "seldon_trace_export_seconds"


def prometheus_scrape_config() -> Dict[str, Any]:
    """Scrape config keyed on the pod annotations the renderer emits
    (controlplane/render.py: prometheus.io/scrape|path|port)."""
    return {
        "global": {"scrape_interval": "15s"},
        "rule_files": ["rules/seldon-alerts.yaml"],
        "scrape_configs": [
            {
                "job_name": "seldon-engines",
                "kubernetes_sd_configs": [{"role": "pod"}],
                "relabel_configs": [
                    {
                        "source_labels": ["__meta_kubernetes_pod_annotation_prometheus_io_scrape"],
                        "action": "keep",
                        "regex": "true",
                    },
                    {
                        "source_labels": ["__meta_kubernetes_pod_annotation_prometheus_io_path"],
                        "action": "replace",
                        "target_label": "__metrics_path__",
                        "regex": "(.+)",
                    },
                    {
                        "source_labels": ["__address__",
                                          "__meta_kubernetes_pod_annotation_prometheus_io_port"],
                        "action": "replace",
                        "regex": r"([^:]+)(?::\d+)?;(\d+)",
                        "replacement": "$1:$2",
                        "target_label": "__address__",
                    },
                    {
                        "source_labels": ["__meta_kubernetes_pod_label_seldon_deployment_id"],
                        "action": "replace",
                        "target_label": "deployment",
                    },
                ],
            }
        ],
    }


def prometheus_alert_rules() -> Dict[str, Any]:
    """Serving alerts over the engine metrics (the reference ships infra
    CPU/mem/disk rules; these are the serving-level equivalents)."""
    err_ratio = (
        f'sum by (deployment_name) (rate({REQUESTS_TOTAL}{{code=~"5.."}}[5m]))'
        f" / sum by (deployment_name) (rate({REQUESTS_TOTAL}[5m]))"
    )
    p99 = (
        "histogram_quantile(0.99, sum by (deployment_name, le) "
        f"(rate({REQUESTS_SECONDS}_bucket[5m])))"
    )
    return {
        "groups": [
            {
                "name": "seldon-serving",
                "rules": [
                    {
                        "alert": "SeldonHighErrorRate",
                        "expr": f"({err_ratio}) > 0.05",
                        "for": "5m",
                        "labels": {"severity": "critical"},
                        "annotations": {
                            "summary": "{{ $labels.deployment_name }}: >5% of requests failing",
                        },
                    },
                    {
                        "alert": "SeldonHighLatencyP99",
                        "expr": f"({p99}) > 1",
                        "for": "10m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary": "{{ $labels.deployment_name }}: p99 latency above 1s",
                        },
                    },
                    {
                        "alert": "SeldonNoTraffic",
                        "expr": f"sum by (deployment_name) (rate({REQUESTS_TOTAL}[15m])) == 0",
                        "for": "30m",
                        "labels": {"severity": "info"},
                        "annotations": {
                            "summary": "{{ $labels.deployment_name }}: no requests for 30m",
                        },
                    },
                    {
                        "alert": "SeldonEngineDown",
                        "expr": 'up{job="seldon-engines"} == 0',
                        "for": "2m",
                        "labels": {"severity": "critical"},
                        "annotations": {"summary": "engine target down"},
                    },
                ],
            }
        ]
    }


def _panel(panel_id: int, title: str, exprs: List[Dict[str, str]], y: int, x: int = 0,
           w: int = 12, h: int = 8, unit: str = "short") -> Dict[str, Any]:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "gridPos": {"h": h, "w": w, "x": x, "y": y},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": [
            {"expr": t["expr"], "legendFormat": t.get("legend", ""), "refId": chr(65 + i)}
            for i, t in enumerate(exprs)
        ],
    }


def predictions_dashboard() -> Dict[str, Any]:
    """The predictions-analytics dashboard over the real metric names."""
    sel = '{deployment_name=~"$deployment"}'
    sel_5xx = '{deployment_name=~"$deployment", code=~"5.."}'
    panels = [
        _panel(1, "Request rate", [
            {"expr": f"sum by (deployment_name, method) (rate({REQUESTS_TOTAL}{sel}[1m]))",
             "legend": "{{deployment_name}} {{method}}"},
        ], y=0, unit="reqps"),
        _panel(2, "Error rate (5xx)", [
            {"expr": f"sum by (deployment_name) (rate({REQUESTS_TOTAL}{sel_5xx}[1m]))",
             "legend": "{{deployment_name}}"},
        ], y=0, x=12, unit="reqps"),
        _panel(3, "Latency percentiles", [
            {"expr": "histogram_quantile(0.5, sum by (le) "
                     f"(rate({REQUESTS_SECONDS}_bucket{sel}[5m])))", "legend": "p50"},
            {"expr": "histogram_quantile(0.9, sum by (le) "
                     f"(rate({REQUESTS_SECONDS}_bucket{sel}[5m])))", "legend": "p90"},
            {"expr": "histogram_quantile(0.99, sum by (le) "
                     f"(rate({REQUESTS_SECONDS}_bucket{sel}[5m])))", "legend": "p99"},
        ], y=8, unit="s"),
        _panel(4, "Mean latency", [
            {"expr": f"sum by (deployment_name) (rate({REQUESTS_SECONDS}_sum{sel}[5m]))"
                     f" / sum by (deployment_name) (rate({REQUESTS_SECONDS}_count{sel}[5m]))",
             "legend": "{{deployment_name}}"},
        ], y=8, x=12, unit="s"),
        _panel(5, "Feedback events", [
            {"expr": f"sum by (deployment_name) (rate({FEEDBACK_TOTAL}{sel}[5m]))",
             "legend": "{{deployment_name}}"},
        ], y=16),
        _panel(6, "Cumulative reward", [
            {"expr": f"sum by (deployment_name) ({FEEDBACK_REWARD}{sel})",
             "legend": "{{deployment_name}}"},
        ], y=16, x=12),
        # the request timeline: the aggregate of what the flight
        # recorder's timelines show a request; the retained / dropped
        # counters say whether the trace pipeline itself is healthy
        _panel(7, "Serving timeline: TTFT / inter-token gap", [
            {"expr": "histogram_quantile(0.5, sum by (le) "
                     f"(rate({TTFT_SECONDS}_bucket{sel}[5m])))",
             "legend": "TTFT p50"},
            {"expr": "histogram_quantile(0.99, sum by (le) "
                     f"(rate({TTFT_SECONDS}_bucket{sel}[5m])))",
             "legend": "TTFT p99"},
            {"expr": "histogram_quantile(0.99, sum by (le) "
                     f"(rate({INTER_TOKEN_SECONDS}_bucket{sel}[5m])))",
             "legend": "inter-token p99"},
        ], y=24, unit="s"),
        _panel(8, "Traces retained / spans dropped", [
            {"expr": f"sum by (deployment_name, mode) (rate({TRACES_RETAINED}{sel}[5m]))",
             "legend": "retained {{mode}}"},
            {"expr": f"sum by (deployment_name) (rate({TRACE_SPANS_DROPPED}{sel}[5m]))",
             "legend": "spans dropped"},
            {"expr": "histogram_quantile(0.95, sum by (le) "
                     f"(rate({TRACE_EXPORT_SECONDS}_bucket{sel}[5m])))",
             "legend": "export p95 (s)"},
        ], y=24, x=12),
    ]
    return {
        "title": "Seldon TPU — Predictions Analytics",
        "uid": "seldon-tpu-predictions",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "templating": {
            "list": [
                {"name": "datasource", "type": "datasource", "query": "prometheus"},
                {
                    "name": "deployment",
                    "type": "query",
                    "datasource": {"type": "prometheus", "uid": "${datasource}"},
                    "query": f"label_values({REQUESTS_TOTAL}, deployment_name)",
                    "includeAll": True,
                    "multi": True,
                },
            ]
        },
        "panels": panels,
    }


def write_artifacts(out_dir: str) -> List[str]:
    """Write ``prometheus-config.yaml``, ``rules/seldon-alerts.yaml`` and
    ``predictions-dashboard.json`` under ``out_dir``; the paths written."""
    from seldon_core_tpu_torch.controlplane.charts import import_yaml

    yaml = import_yaml()
    os.makedirs(os.path.join(out_dir, "rules"), exist_ok=True)
    written = []

    def dump_yaml(rel: str, obj: Any) -> None:
        path = os.path.join(out_dir, rel)
        with open(path, "w") as f:
            yaml.safe_dump(obj, f, sort_keys=False)
        written.append(path)

    dump_yaml("prometheus-config.yaml", prometheus_scrape_config())
    dump_yaml(os.path.join("rules", "seldon-alerts.yaml"), prometheus_alert_rules())
    dash = os.path.join(out_dir, "predictions-dashboard.json")
    with open(dash, "w") as f:
        json.dump(predictions_dashboard(), f, indent=2)
    written.append(dash)
    return written


__all__ = ["predictions_dashboard", "prometheus_alert_rules", "prometheus_scrape_config",
           "write_artifacts"]
