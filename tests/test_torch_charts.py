"""The port's helm-chart subset renderer (``seldon_core_tpu_torch/controlplane/
charts.py``) held against the JAX package's on the CPU: ``render_chart``
and ``render_chart_docs`` give the same templates and documents on every
chart under ``deploy/charts`` with its own values file and with the value
overrides of ``tests/test_charts.py``, and ``render_template`` the same
text (or the same ValueError) on the subset's cases."""

import os

import pytest

pytest.importorskip("yaml")

from seldon_core_tpu.controlplane import charts as jax_charts  # noqa: E402
from seldon_core_tpu_torch.controlplane import charts  # noqa: E402

CHARTS = sorted(d for d in os.listdir(charts.CHARTS_DIR)
                if os.path.isdir(os.path.join(charts.CHARTS_DIR, d)))
OVERRIDES = {
    "seldon-mab": [{"name": "bandit2", "epsilon": "0.05", "replicas": 3,
                    "modelA": {"uri": "gs://b/a2"}}],
    "seldon-core-tpu-operator": [{"istio": {"enabled": False}},
                                 {"namespace": "ml", "engine": {"image": "r/engine:v9",
                                                                "httpPort": 9000}}],
}


def test_charts_dir_is_the_same_directory():
    assert os.path.realpath(charts.CHARTS_DIR) == os.path.realpath(jax_charts.CHARTS_DIR)
    assert CHARTS == ["seldon-abtest", "seldon-core-tpu-operator", "seldon-mab",
                      "seldon-single-model"]


@pytest.mark.parametrize("chart", CHARTS)
@pytest.mark.parametrize("release", [("seldon-system", "seldon"), ("ml", "r2")])
def test_render_chart_equals_jax(chart, release):
    path = os.path.join(charts.CHARTS_DIR, chart)
    ns, rel = release
    for values in [None] + OVERRIDES.get(chart, []):
        got = charts.render_chart(path, values, namespace=ns, release=rel)
        assert got == jax_charts.render_chart(path, values, namespace=ns, release=rel)
        assert got and all(text for _, text in got)
        assert charts.render_chart_docs(path, values, namespace=ns, release=rel) == \
            jax_charts.render_chart_docs(path, values, namespace=ns, release=rel)


CTX = {"Values": {"a": {"b": "x"}, "flag": False, "on": True, "n": 3, "s": "hi"},
       "Release": {"Namespace": "ns"}, "Chart": {"version": "1.2"}}


@pytest.mark.parametrize("text", [
    "v={{ .Values.a.b }}",
    '{{ .Values.missing | default "d" }}',
    "{{ .Values.missing | default .Values.s }}",
    "{{ .Values.n | quote }}",
    "{{ .Values.a | toJson }}",
    "{{ .Values.s | b64enc }}",
    '{{ "7" | int }}',
    "{{ .Release.Namespace }}/{{ .Chart.version }}",
    "a\n{{- if .Values.flag }}\nyes\n{{- else }}\nno\n{{- end }}\nb",
    "a\n{{- if .Values.on }}\nyes\n{{- else }}\nno\n{{- end }}\nb",
    "x {{- .Values.s -}}\n y",
    "{{ .Values.x | exotic }}",
    "{{ bare }}",
    "{{ else }}",
    "{{ end }}",
    "{{ if .Values.on }}open",
])
def test_render_template_equals_jax(text):
    def run(mod):
        try:
            return mod.render_template(text, CTX)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(charts) == run(jax_charts)
