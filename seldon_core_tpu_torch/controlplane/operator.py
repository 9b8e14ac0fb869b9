"""Control-plane reconcile loop of the port (the operator), copied from
``seldon_core_tpu/controlplane/operator.py``. Host-only:

    watch CR sources -> validate + default -> render -> diff -> apply/delete
                                         \\-> status written back per CR

The cluster is a pluggable backend: ``FileCluster`` (one JSON file per
applied object, keyed by kind/namespace/name; a stand-in for ``kubectl
apply`` that is also a local dry-run target) or ``KubectlCluster`` (shells
out to kubectl). A CR that fails validation is not partially applied: its
status goes to Failed with the problem list (the defaulting/validating
webhook's role). Each pass writes ``<status dir>/<name>.json``, writes a
``Deleted`` tombstone for a removed CR and sweeps status files that no CR
backs one pass later. ``run_forever`` keeps a constant cadence on an
injectable ``clock`` / ``sleep`` pair.

The only difference from the JAX package's loop is what it renders
(``controlplane/render.py``): ``gpus`` and ``gpu_product`` in place of
``tpu_chips`` and ``tpu_topology``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from seldon_core_tpu_torch.contracts.graph import SeldonDeploymentSpec
from seldon_core_tpu_torch.controlplane.render import render_manifests
from seldon_core_tpu_torch.controlplane.validate import default_deployment, validate_deployment

logger = logging.getLogger(__name__)

OWNER_LABEL = "seldon-deployment-id"


def _manifest_key(m: Dict[str, Any]) -> Tuple[str, str, str]:
    meta = m.get("metadata", {})
    return (m.get("kind", ""), meta.get("namespace", "default"), meta.get("name", ""))


class FileCluster:
    """Applied-manifest store: one JSON file per object under
    ``<root>/<kind>/<namespace>/<name>.json``. apply() is idempotent and
    reports created/updated/unchanged so the reconciler can log convergence
    the way a controller's event stream would."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, kind: str, namespace: str, name: str) -> str:
        return os.path.join(self.root, kind.lower(), namespace, f"{name}.json")

    def apply(self, manifest: Dict[str, Any]) -> str:
        kind, namespace, name = _manifest_key(manifest)
        if not kind or not name:
            raise ValueError(f"manifest missing kind or metadata.name: {manifest}")
        path = self._path(kind, namespace, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        serialized = json.dumps(manifest, indent=2, sort_keys=True)
        if os.path.exists(path):
            with open(path) as f:
                if f.read() == serialized:
                    return "unchanged"
            status = "updated"
        else:
            status = "created"
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(serialized)
        os.replace(tmp, path)
        return status

    def delete(self, kind: str, namespace: str, name: str) -> bool:
        path = self._path(kind, namespace, name)
        if os.path.exists(path):
            os.remove(path)
            return True
        return False

    def get(self, kind: str, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        path = self._path(kind, namespace, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def list(self, label: Optional[str] = None, value: Optional[str] = None) -> List[Dict[str, Any]]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if not fn.endswith(".json"):
                    continue
                with open(os.path.join(dirpath, fn)) as f:
                    m = json.load(f)
                labels = m.get("metadata", {}).get("labels", {})
                if label is not None and labels.get(label) != value:
                    continue
                out.append(m)
        return out


class KubectlCluster:
    """Real-cluster backend: shells out to kubectl. Only used when a
    kubeconfig/cluster is actually reachable; everything above it is
    backend-agnostic."""

    def __init__(self, kubectl: str = "kubectl"):
        self.kubectl = kubectl

    def _resource_version(self, manifest: Dict[str, Any]) -> Optional[str]:
        """resourceVersion of the live object, None when it does not exist.
        --ignore-not-found separates 'absent' (rc 0, empty output) from a
        real get failure (rc != 0 — apiserver timeout, RBAC), which raises:
        a transient error must not misreport an update as a creation."""
        meta = manifest.get("metadata", {})
        args = [self.kubectl, "get", manifest.get("kind", "").lower(),
                meta.get("name", ""), "--ignore-not-found",
                "-o", "jsonpath={.metadata.resourceVersion}"]
        if meta.get("namespace"):
            # no -n when the manifest omits it: apply uses the context
            # default namespace, and get must look in the same place
            args += ["-n", meta["namespace"]]
        res = subprocess.run(args, capture_output=True)
        if res.returncode != 0:
            raise RuntimeError(f"kubectl get failed: {res.stderr.decode()}")
        rv = res.stdout.decode().strip()
        return rv or None

    def apply(self, manifest: Dict[str, Any]) -> str:
        # created/updated/unchanged from machine-stable signals only
        # (exit codes, -o json, resourceVersion) — kubectl's human apply
        # message ("configured"/"unchanged") is not a stable interface.
        rv_before = self._resource_version(manifest)
        res = subprocess.run(
            [self.kubectl, "apply", "-f", "-", "-o", "json"],
            input=json.dumps(manifest).encode(),
            capture_output=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"kubectl apply failed: {res.stderr.decode()}")
        try:
            rv_after = json.loads(res.stdout.decode()).get(
                "metadata", {}).get("resourceVersion")
        except (ValueError, AttributeError) as e:
            raise RuntimeError(f"kubectl apply returned non-JSON output: {e}")
        if rv_before is None:
            return "created"
        return "unchanged" if rv_after == rv_before else "updated"

    def delete(self, kind: str, namespace: str, name: str) -> bool:
        # -o name prints one line per deleted object (machine format);
        # --ignore-not-found + empty output = nothing existed
        res = subprocess.run(
            [self.kubectl, "delete", kind.lower(), name, "-n", namespace,
             "--ignore-not-found", "-o", "name"],
            capture_output=True,
        )
        return res.returncode == 0 and bool(res.stdout.strip())

    def list(self, label: Optional[str] = None, value: Optional[str] = None) -> List[Dict[str, Any]]:
        items: List[Dict[str, Any]] = []
        # VirtualServices queried separately: the Istio CRD may be absent, and
        # a missing resource type would fail the whole combined query (which
        # would orphan VirtualServices on prune/delete).
        for kinds in ("deployments,services,horizontalpodautoscalers",
                      "virtualservices.networking.istio.io"):
            args = [self.kubectl, "get", kinds, "-A", "-o", "json"]
            if label is not None:
                args += ["-l", f"{label}={value}"]
            res = subprocess.run(args, capture_output=True)
            if res.returncode != 0:
                continue
            items.extend(json.loads(res.stdout.decode()).get("items", []))
        return items


@dataclass
class ReconcileResult:
    name: str
    ok: bool
    applied: Dict[str, str] = field(default_factory=dict)  # "Kind/ns/name" -> status
    deleted: List[str] = field(default_factory=list)
    problems: List[str] = field(default_factory=list)
    transient: bool = False  # failed for a reason a retry might fix

    def to_status(self) -> Dict[str, Any]:
        return {
            "state": "Available" if self.ok else "Failed",
            "description": "; ".join(self.problems) if self.problems else "",
            "applied": self.applied,
            "deleted": self.deleted,
        }


class Reconciler:
    """Converge one SeldonDeployment: desired = render(CR), actual = objects
    in the cluster carrying this CR's owner label; apply the difference."""

    def __init__(
        self,
        cluster,
        namespace: str = "default",
        engine_image: Optional[str] = None,
        gpus: int = 1,
        gpu_product: Optional[str] = None,
    ):
        self.cluster = cluster
        self.namespace = namespace
        self.engine_image = engine_image
        self.gpus = gpus
        self.gpu_product = gpu_product

    def reconcile(self, sdep: SeldonDeploymentSpec | Dict[str, Any]) -> ReconcileResult:
        if isinstance(sdep, dict):
            sdep = SeldonDeploymentSpec.from_dict(sdep)
        sdep = default_deployment(sdep)
        problems = validate_deployment(sdep)
        if problems:
            # webhook semantics: reject outright, change nothing
            return ReconcileResult(name=sdep.name, ok=False, problems=problems)

        kwargs: Dict[str, Any] = {
            "namespace": self.namespace,
            "gpus": self.gpus,
            "gpu_product": self.gpu_product,
            "validate": False,  # already validated above
        }
        if self.engine_image:
            kwargs["engine_image"] = self.engine_image
        desired = render_manifests(sdep, **kwargs)
        for m in desired:
            m.setdefault("metadata", {}).setdefault("labels", {})[OWNER_LABEL] = sdep.name

        result = ReconcileResult(name=sdep.name, ok=True)
        desired_keys = set()
        for m in desired:
            key = _manifest_key(m)
            desired_keys.add(key)
            status = self.cluster.apply(m)
            result.applied["/".join(key)] = status

        # prune: objects we own that the new spec no longer renders
        # (e.g. a predictor removed, an HPA dropped, a VirtualService gone)
        for m in self.cluster.list(label=OWNER_LABEL, value=sdep.name):
            key = _manifest_key(m)
            if key not in desired_keys:
                if self.cluster.delete(*key):
                    result.deleted.append("/".join(key))
        return result

    def delete(self, name: str) -> List[str]:
        """CR removed: delete everything carrying its owner label."""
        gone = []
        for m in self.cluster.list(label=OWNER_LABEL, value=name):
            key = _manifest_key(m)
            if self.cluster.delete(*key):
                gone.append("/".join(key))
        return gone


class Operator:
    """The watch loop over a directory of CR files (*.json / *.yaml / *.yml).

    Each pass: parse every CR source, reconcile the changed ones (content
    hash), delete owned objects of CRs whose files vanished, and write each
    CR's status to ``<cr-dir>/.status/<name>.json`` — the stand-in for the
    CRD status subresource (`templates/crd.yaml` ``subresources.status``)."""

    def __init__(
        self,
        cr_dir: str,
        reconciler: Reconciler,
        interval: float = 2.0,
        status_dir: Optional[str] = None,
        clock=None,
        sleep=None,
    ):
        self.cr_dir = cr_dir
        self.reconciler = reconciler
        self.interval = interval
        # separate from cr_dir when the CR source is read-only (e.g. a
        # mounted ConfigMap)
        self.status_dir = status_dir or os.path.join(cr_dir, ".status")
        # injectable time pair (the autoscaler's idiom): ``clock`` stamps,
        # ``sleep`` waits between passes; a testing.faults.FaultClock and
        # its advance run whole loops in zero wall time
        self.clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self._seen: Dict[str, str] = {}  # cr name -> content hash
        self._sources: Dict[str, str] = {}  # cr name -> file path
        self._wrote_status: set = set()  # names written THIS pass
        self._stop = False

    # ------------------------------------------------------------------
    def _load_crs(self) -> Tuple[Dict[str, Tuple[Dict[str, Any], str, str]], set]:
        """Returns (name -> (cr dict, content hash, path), parsed_paths).
        Unparseable files surface as Failed status under the file's basename —
        they are NOT treated as deletions (a file caught mid-rewrite must not
        tear down its live objects); ``parsed_paths`` lets the deletion sweep
        distinguish a torn write (path absent from it) from a file that
        parsed fine but now names a different CR."""
        crs: Dict[str, Tuple[Dict[str, Any], str, str]] = {}
        parsed_paths: set = set()
        if not os.path.isdir(self.cr_dir):
            return crs, parsed_paths
        for fn in sorted(os.listdir(self.cr_dir)):
            if not fn.endswith((".json", ".yaml", ".yml")):
                continue
            path = os.path.join(self.cr_dir, fn)
            try:
                with open(path) as f:
                    raw = f.read()
                if fn.endswith(".json"):
                    cr = json.loads(raw)
                else:
                    from seldon_core_tpu_torch.controlplane.charts import import_yaml

                    cr = import_yaml().safe_load(raw)
                if not isinstance(cr, dict):
                    raise ValueError("CR must be a mapping")
            except Exception as e:
                name = os.path.splitext(fn)[0]
                self._write_status(name, {"state": "Failed", "description": f"unparseable CR: {e}"})
                logger.error("CR %s unparseable: %s", path, e)
                continue
            name = (cr.get("metadata", {}).get("name") or cr.get("spec", {}).get("name")
                    or cr.get("name") or os.path.splitext(fn)[0])
            digest = hashlib.sha256(json.dumps(cr, sort_keys=True).encode()).hexdigest()
            crs[name] = (cr, digest, path)
            parsed_paths.add(path)
        return crs, parsed_paths

    def _write_status(self, name: str, status: Dict[str, Any]) -> None:
        os.makedirs(self.status_dir, exist_ok=True)
        path = os.path.join(self.status_dir, f"{name}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(status, f, indent=2)
        os.replace(tmp, path)
        self._wrote_status.add(name)

    def _sweep_stale_status(self, crs: Dict[str, Any]) -> List[str]:
        """Remove status files no live CR backs: deleting a CR used to
        orphan ``.status/<name>.json`` forever (the owned objects were
        pruned but the status record accumulated).  A just-written status
        (this pass — the 'Deleted' tombstone included, so one pass can
        still read it) and any tracked or parsed CR's status are kept;
        everything else is a leftover from a removed CR or a previous
        operator incarnation."""
        if not os.path.isdir(self.status_dir):
            return []
        swept = []
        for fn in sorted(os.listdir(self.status_dir)):
            if not fn.endswith(".json"):
                continue
            name = os.path.splitext(fn)[0]
            if (name in crs or name in self._sources
                    or name in self._wrote_status):
                continue
            try:
                os.remove(os.path.join(self.status_dir, fn))
            except OSError:
                continue  # racing writer/reader: retry next pass
            swept.append(name)
            logger.info("swept stale status for removed CR %s", name)
        return swept

    def read_status(self, name: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.status_dir, f"{name}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # ------------------------------------------------------------------
    def run_once(self) -> Dict[str, ReconcileResult]:
        """One reconcile pass; returns results for CRs that were acted on."""
        results: Dict[str, ReconcileResult] = {}
        self._wrote_status = set()
        crs, parsed_paths = self._load_crs()

        # Deletions first, keyed on the tracked source path (covers CRs whose
        # reconcile only ever failed transiently). A tracked CR is gone when
        # its file vanished OR the file parsed cleanly to a different name
        # (rename-in-place). A file that exists but failed to parse is a torn
        # write: keep the live objects.
        for name, path in list(self._sources.items()):
            if name in crs:
                continue
            if os.path.exists(path) and path not in parsed_paths:
                continue  # momentarily unparseable — not a deletion
            gone = self.reconciler.delete(name)
            logger.info("CR %s removed; deleted %d objects", name, len(gone))
            results[name] = ReconcileResult(name=name, ok=True, deleted=gone)
            self._write_status(name, {"state": "Deleted", "deleted": gone})
            self._seen.pop(name, None)
            del self._sources[name]

        for name, (cr, digest, path) in crs.items():
            if self._seen.get(name) == digest:
                continue
            try:
                res = self.reconciler.reconcile(cr)
            except Exception as e:  # keep the loop alive on a bad CR
                logger.exception("reconcile %s failed", name)
                res = ReconcileResult(name=name, ok=False, problems=[str(e)], transient=True)
            results[name] = res
            self._write_status(name, res.to_status())
            # Mark seen on success and on stable validation failures (no point
            # re-spamming those); an exception (apply error, API hiccup) leaves
            # the CR unseen so the next pass retries it.
            if not res.transient:
                self._seen[name] = digest
            self._sources[name] = path
            logger.info(
                "reconciled %s: %s (%d applied, %d deleted)",
                name, "ok" if res.ok else f"FAILED: {res.problems}",
                len(res.applied), len(res.deleted),
            )
        # last: sweep status files no live CR backs (a 'Deleted' tombstone
        # written above survives this pass and is swept on the next)
        self._sweep_stale_status(crs)
        return results

    def run_forever(self) -> None:
        signal.signal(signal.SIGTERM, lambda *_: setattr(self, "_stop", True))
        signal.signal(signal.SIGINT, lambda *_: setattr(self, "_stop", True))
        logger.info("operator watching %s every %.1fs", self.cr_dir, self.interval)
        while not self._stop:
            t0 = self.clock()
            try:
                self.run_once()
            except Exception:
                # a broken pass (unwritable status dir, backend outage) must
                # not crash-loop the controller; retry next tick
                logger.exception("reconcile pass failed")
            # constant cadence on the injected clock: the wait shrinks by
            # the pass's own duration, so a slow reconcile (big cluster,
            # kubectl round-trips) doesn't stretch the watch period to
            # interval + pass time
            elapsed = self.clock() - t0
            self._sleep(max(self.interval - elapsed, 0.0))
        logger.info("operator stopped")
