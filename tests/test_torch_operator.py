"""The port's operator (``seldon_core_tpu_torch/controlplane/operator.py``)
held against the JAX package's on the CPU: the scenarios of
``tests/test_operator.py`` run through both loops on ``FileCluster``
backends, side by side, and after every pass the two agree on the results
(ok, applied with created/updated/unchanged, deleted, problems, transient),
the status files, and the applied objects up to render's three documented
differences (``tests/test_torch_controlplane.to_jax_form``). The port's CLI
``operator --once`` reconciles the ``deploy/examples`` CRs into a
``FileCluster`` whose objects equal its ``render --format json`` output.
"""

import contextlib
import io
import json
import os
import shutil
import stat

import pytest

from seldon_core_tpu.controlplane import operator as jax_operator
from seldon_core_tpu.testing.faults import FaultClock as JaxFaultClock
from seldon_core_tpu_torch.controlplane import operator
from seldon_core_tpu_torch.testing.faults import FaultClock
from seldon_core_tpu_torch.transport.cli import main
from tests.test_torch_controlplane import to_jax_form

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "deploy", "examples")


def single_model_cr(name="m1", replicas=1):
    return {"apiVersion": "machinelearning.seldon.io/v1alpha2", "kind": "SeldonDeployment",
            "metadata": {"name": name},
            "spec": {"name": name, "predictors": [{
                "name": "default", "replicas": replicas,
                "graph": {"name": "clf", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}]}}


class Side:
    """One operator (JAX's or the port's) over its own CR dir and cluster."""

    def __init__(self, mod, root, status_dir=None):
        self.mod = mod
        self.cr_dir = root / "crs"
        self.cr_dir.mkdir(parents=True, exist_ok=True)
        self.cluster = mod.FileCluster(str(root / "cluster"))
        self.op = mod.Operator(str(self.cr_dir), mod.Reconciler(self.cluster), interval=0.01,
                               status_dir=status_dir)

    def write(self, fname, cr):
        path = self.cr_dir / fname
        path.write_text(cr if isinstance(cr, str) else json.dumps(cr))

    def remove(self, fname):
        os.remove(self.cr_dir / fname)

    def objects(self):
        key = lambda m: (m["kind"], m["metadata"].get("namespace", ""),  # noqa: E731
                         m["metadata"]["name"])
        return sorted(self.cluster.list(), key=key)

    def statuses(self):
        d = self.op.status_dir
        if not os.path.isdir(d):
            return {}
        return {fn: json.load(open(os.path.join(d, fn))) for fn in sorted(os.listdir(d))}


def results(res):
    return {n: (r.ok, r.applied, sorted(r.deleted), r.problems, r.transient)
            for n, r in res.items()}


@pytest.fixture
def sides(tmp_path):
    return Side(jax_operator, tmp_path / "jax"), Side(operator, tmp_path / "port")


def run_both(sides, step=None):
    """Apply ``step`` to both sides, one pass each; the passes agree."""
    j, p = sides
    if step is not None:
        step(j)
        step(p)
    rj, rp = j.op.run_once(), p.op.run_once()
    assert results(rp) == results(rj)
    assert to_jax_form(p.objects()) == j.objects()
    assert p.statuses() == j.statuses()
    return rp


def test_apply_update_converge_delete(sides):
    r = run_both(sides, lambda s: s.write("m1.json", single_model_cr()))
    assert r["m1"].ok and set(r["m1"].applied.values()) == {"created"}
    assert run_both(sides) == {}                   # converged: no-op
    r = run_both(sides, lambda s: s.write("m1.json", single_model_cr(replicas=3)))
    assert r["m1"].applied["Deployment/default/m1-default"] == "updated"
    r = run_both(sides, lambda s: s.remove("m1.json"))
    assert sorted(r["m1"].deleted) == ["Deployment/default/m1-default",
                                       "Service/default/m1-default"]
    assert sides[1].op.read_status("m1")["state"] == "Deleted"
    run_both(sides)                                # the tombstone is swept
    assert sides[1].op.read_status("m1") is None


def test_predictor_removed_prunes_objects(sides):
    cr = single_model_cr()
    cr["spec"]["predictors"].append({"name": "canary", "replicas": 1, "traffic": 50, "graph": {
        "name": "clf", "type": "MODEL", "implementation": "SIMPLE_MODEL"}})
    cr["spec"]["predictors"][0]["traffic"] = 50
    run_both(sides, lambda s: s.write("m1.json", cr))
    assert sides[1].cluster.get("VirtualService", "default", "m1") is not None
    r = run_both(sides, lambda s: s.write("m1.json", single_model_cr()))
    assert "Deployment/default/m1-canary" in r["m1"].deleted
    assert sides[1].cluster.get("VirtualService", "default", "m1") is None


def test_bad_graph_and_unparseable_cr(sides):
    cr = single_model_cr()
    cr["spec"]["predictors"][0]["graph"] = {"name": "r", "type": "ROUTER",
                                            "implementation": "SIMPLE_ROUTER", "children": []}
    r = run_both(sides, lambda s: (s.write("bad.json", cr), s.write("junk.json", "{not json")))
    assert not r["m1"].ok and r["m1"].problems
    assert sides[1].cluster.list() == []
    assert sides[1].op.read_status("junk")["state"] == "Failed"
    run_both(sides)
    assert sides[1].op.read_status("junk")["state"] == "Failed"   # kept while present
    run_both(sides, lambda s: s.remove("junk.json"))
    run_both(sides)
    assert sides[1].op.read_status("junk") is None


def test_example_crs_reconcile(sides):
    def write_all(s):
        for fn in sorted(os.listdir(EXAMPLES)):
            shutil.copy(os.path.join(EXAMPLES, fn), s.cr_dir / fn)

    r = run_both(sides, write_all)
    assert len(r) == len(os.listdir(EXAMPLES)) and all(x.ok for x in r.values())
    vs = sides[1].cluster.get("VirtualService", "default", "canary")
    assert {x["weight"] for x in vs["spec"]["http"][0]["route"]} == {90, 10}


@pytest.mark.parametrize("fail_at", [1, 2])
def test_transient_failure_retried_and_removal_cleans_up(sides, fail_at):
    for s in sides:
        real = s.cluster.apply
        calls = {"n": 0}

        def flaky(manifest, _real=real, _calls=calls):
            _calls["n"] += 1
            if _calls["n"] == fail_at:
                raise RuntimeError("apiserver unavailable")
            return _real(manifest)

        s.cluster.apply = flaky
    r = run_both(sides, lambda s: s.write("m1.json", single_model_cr()))
    assert not r["m1"].ok and r["m1"].transient
    if fail_at == 1:
        assert run_both(sides)["m1"].ok             # unseen: retried
    else:
        r = run_both(sides, lambda s: s.remove("m1.json"))
        assert "Deployment/default/m1-default" in r["m1"].deleted


def test_torn_rewrite_and_rename_in_place(sides):
    run_both(sides, lambda s: s.write("m1.json", single_model_cr()))
    r = run_both(sides, lambda s: s.write("m1.json", '{"apiVersion": "machinelea'))
    assert not any(x.deleted for x in r.values())
    run_both(sides, lambda s: s.write("m1.json", single_model_cr(replicas=2)))
    r = run_both(sides, lambda s: s.write("m1.json", single_model_cr(name="m2")))
    assert "Deployment/default/m1-default" in r["m1"].deleted
    assert sides[1].cluster.get("Deployment", "default", "m2-default") is not None


def test_readonly_cr_dir_and_previous_incarnation(tmp_path):
    sides = [Side(mod, tmp_path / name, status_dir=str(tmp_path / name / "status"))
             for mod, name in ((jax_operator, "jax"), (operator, "port"))]
    for s in sides:
        s.write("m1.json", single_model_cr())
        os.chmod(s.cr_dir, stat.S_IRUSR | stat.S_IXUSR)
    try:
        run_both(sides)
        assert not (sides[1].cr_dir / ".status").exists()
    finally:
        for s in sides:
            os.chmod(s.cr_dir, stat.S_IRWXU)
    for s in sides:   # a fresh operator over the same dirs, m1's CR gone
        s.remove("m1.json")
        s.op = s.mod.Operator(str(s.cr_dir), s.mod.Reconciler(s.cluster),
                              status_dir=s.op.status_dir)
        s.op.run_once()
        assert s.op.read_status("m1") is None


def test_run_forever_on_a_fault_clock(tmp_path):
    """Both loops on their injected clock and sleep: the same pass times,
    and a slow pass shortens the wait (constant cadence)."""
    got = {}
    for mod, FC, name in ((jax_operator, JaxFaultClock, "jax"), (operator, FaultClock, "port")):
        clock = FC()
        s = Side(mod, tmp_path / name)
        s.write("m1.json", single_model_cr())
        passes = []

        def sleep(seconds, _clock=clock, _passes=passes, _s=s):
            _clock.advance(seconds)
            _passes.append(_clock.now())
            if len(_passes) >= 3:
                _s.op._stop = True

        s.op = mod.Operator(str(s.cr_dir), mod.Reconciler(s.cluster), interval=2.0,
                            clock=clock, sleep=sleep)
        s.op.run_forever()
        op2 = mod.Operator(str(s.cr_dir), mod.Reconciler(s.cluster), interval=2.0, clock=clock)
        waits = []
        op2.run_once = lambda _c=clock: (_c.advance(0.5), {})[1]
        op2._sleep = lambda w, _op=op2: (waits.append(w), setattr(_op, "_stop", True))
        op2.run_forever()
        got[name] = (passes, waits, s.op.read_status("m1")["state"])
    assert got["port"] == got["jax"] == ([1002.0, 1004.0, 1006.0], [1.5], "Available")


def test_operator_cli_once_equals_render(tmp_path):
    """``operator --once`` through the port's CLI over the example CRs: the
    FileCluster holds exactly what ``render --format json`` prints for
    them, with the owner label the reconciler adds."""
    crs = tmp_path / "crs"
    shutil.copytree(EXAMPLES, crs)
    main(["operator", "--crs", str(crs), "--cluster", str(tmp_path / "cluster"), "--once",
          "--gpus", "2", "--gpu-product", "NVIDIA-H100-80GB-HBM3"])
    want = []
    for fn in sorted(os.listdir(EXAMPLES)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["render", os.path.join(EXAMPLES, fn), "--format", "json", "--gpus", "2",
                  "--gpu-product", "NVIDIA-H100-80GB-HBM3"])
        for m in json.loads(buf.getvalue()):
            m["metadata"].setdefault("labels", {})[operator.OWNER_LABEL] = \
                json.load(open(os.path.join(EXAMPLES, fn)))["spec"]["name"]
            want.append(m)
    key = lambda m: (m["kind"], m["metadata"]["namespace"], m["metadata"]["name"])  # noqa: E731
    got = operator.FileCluster(str(tmp_path / "cluster")).list()
    assert sorted(got, key=key) == sorted(want, key=key)
    assert all(json.loads(open(crs / ".status" / f).read())["state"] == "Available"
               for f in os.listdir(crs / ".status"))
