"""Command-line entry point of the port.

``python -m seldon_core_tpu_torch.transport.cli microservice <ModelFile>
[REST|GRPC] --port N [--device cuda|cpu]`` imports class ``<ModelFile>`` from module
``<ModelFile>`` in the working directory (or a dotted ``pkg.mod.Class``,
e.g. ``seldon_core_tpu_torch.servers.torchserver.TorchServer``), constructs
it with the typed parameters of ``PREDICTIVE_UNIT_PARAMETERS``
(``[{"name": "model_uri", "value": "/ckpt", "type": "STRING"}]``), plus
``device=...`` when its constructor takes a ``device`` parameter or
``**kwargs`` (``TorchServer`` and ``LLMServer`` do; a host-only user model
need not), loads it and serves it over REST (``transport/rest.py``) or gRPC
(``transport/grpc_server.py``; without grpcio or protobuf installed it exits
naming the missing module, with no fallback to REST). Both read the pod's
annotations from the downward-API file ``ANNOTATIONS_FILE`` (the REST app's
admission gate, the gRPC server's ``seldon.io/grpc-max-message-size``), as
the JAX package's CLI does. With
``--persistence`` the component is restored from its persisted state where
there is one (``runtime/persistence``: a directory, or Redis where
``REDIS_SERVICE_HOST`` is set), snapshotted by a ``PersistenceThread``, and
a stateful router (one with ``stats_snapshot``) shares its counters with
its replicas through a ``ReplicaSync``.

``python -m seldon_core_tpu_torch.transport.cli engine [--spec graph.json]
[--api REST|GRPC] --port N [--device cuda|cpu]`` serves a predictor graph
in-process (``runtime/engine.GraphEngine``) over the engine app
(``transport/rest.make_engine_app``) or the gRPC engine server. The spec
comes from ``--spec``, else ``ENGINE_PREDICTOR`` (base64 JSON) or
``ENGINE_PREDICTOR_FILE``, else the reference engine's default one-unit
SIMPLE_MODEL graph; the annotations file tunes admission, deadlines and
breakers. ``--api IPC`` comes with the native-edge slice.

The control plane (host-only, the JAX CLI's arguments but ``--gpus`` and
``--gpu-product`` in place of ``--tpu-chips`` and ``--tpu-topology``):
``render <cr> [--format yaml|json]`` prints a CR's manifests
(``controlplane/render.py``); ``operator --crs DIR [--cluster DIR |
--kubectl] [--once]`` reconciles a directory of CRs into a ``FileCluster``
(or through kubectl), one pass with ``--once``; ``render-chart <chart>
[--values FILE]`` renders a ``deploy/charts`` chart without helm. PyYAML is
imported where it is needed (a YAML CR, ``--format yaml``, a chart); where
it is missing the command raises naming it, and JSON CRs with ``--format
json`` need none.

The host-side tools, with the JAX CLI's arguments: ``tester`` and
``api-tester`` fuzz a microservice or an engine with a contract's payloads
(``client/testers.py``); ``loadtest <host> <port> [--clients N]
[--duration S] [--grpc]`` drives the port's closed-loop load generator
(``client/loadgen.py``) and prints its JSON report; ``request-logger``
serves the CloudEvents pair logger (``observability/request_logger.py``);
``analytics --out DIR`` writes the Prometheus and Grafana artifacts
(PyYAML needed). ``edge``, ``loadtest-native``, ``loadtest-worker`` and
``loadtest-fleet`` drive the native C++ edge and exit naming the
native-edge slice of the port; ``convert-llama`` is not ported.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import logging
import os
import sys
from typing import Dict, Optional

ANNOTATIONS_FILE = "/etc/podinfo/annotations"


def load_annotations(path: str) -> Dict[str, str]:
    """A k8s downward-API annotations file: ``key="value"`` lines (none
    when the file is absent)."""
    annotations: Dict[str, str] = {}
    if not os.path.exists(path):
        return annotations
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            annotations[key.strip()] = value.strip().strip('"')
    return annotations


def import_interface(name: str):
    """Import `Name` from module `Name`, or `pkg.mod.Class` dotted form."""
    sys.path.insert(0, os.getcwd())
    if "." in name:
        module_name, _, class_name = name.rpartition(".")
    else:
        module_name = class_name = name
    module = importlib.import_module(module_name)
    return getattr(module, class_name)


def takes_device(klass) -> bool:
    """True when ``klass(...)`` accepts a ``device`` keyword: its
    constructor names a ``device`` parameter or takes ``**kwargs``."""
    try:
        params = inspect.signature(klass).parameters.values()
    except (TypeError, ValueError):  # no introspectable signature
        return False
    return any(p.kind == p.VAR_KEYWORD
               or (p.name == "device" and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY))
               for p in params)


def build_component(interface_name: str, device: str, persistence: bool = False):
    """Construct ``interface_name`` with the typed
    ``PREDICTIVE_UNIT_PARAMETERS`` (and ``device`` when the class takes
    it), or with ``persistence`` restore it from its persisted state, and
    load it; with ``persistence`` its persistence threads start
    (``start_persistence``)."""
    from seldon_core_tpu_torch.contracts.parameters import parse_parameters

    klass = import_interface(interface_name)
    parameters = parse_parameters()
    if takes_device(klass):
        parameters = dict(parameters, device=device)
    component = None
    if persistence:
        from seldon_core_tpu_torch.runtime.persistence import restore_component

        component = restore_component(klass)
    restored_shared = component is not None
    if component is None:
        try:
            component = klass(**parameters)
        except TypeError as e:
            raise SystemExit(f"{interface_name}(**{sorted(parameters)}) failed: {e} — the "
                             f"model class must accept the unit parameters") from e
    if hasattr(component, "load"):
        component.load()
    if persistence:
        start_persistence(component, restored_shared)
    return component


def start_persistence(component, restored_shared: bool) -> list:
    """A ``PersistenceThread`` for ``component`` and, for a stateful router,
    a ``ReplicaSync`` sharing its counters with its replicas; both started.
    A router restored from the shared key (persistence from before replica
    sync) adopts those counts as its own only if its exclusive claim wins;
    the other replicas zero theirs and learn them as peers."""
    import atexit

    from seldon_core_tpu_torch.runtime.persistence import PersistenceThread, ReplicaSync

    thread = PersistenceThread(component)
    thread.start()
    threads = [thread]
    if hasattr(component, "stats_snapshot"):
        sync = ReplicaSync(component, store=thread.store)
        if not sync.restore_own() and restored_shared and hasattr(component,
                                                                  "reset_local_stats"):
            if thread.store.save_if_absent(f"{sync.key}:legacy-claim", sync.rid):
                logging.getLogger(__name__).info("adopted legacy persisted counters as "
                                                 "replica %s", sync.rid)
            else:
                component.reset_local_stats()
        sync.sync()  # publish and pull the peers now, not after one period
        sync.start()
        threads.append(sync)
        atexit.register(sync.stop)  # a last publish at shutdown
    return threads


def setup_logging() -> None:
    logging.basicConfig(level=os.environ.get("SELDON_LOG_LEVEL", "INFO").upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def run_microservice(args: argparse.Namespace) -> None:
    setup_logging()
    api = (args.api or "REST").upper()
    if api not in ("REST", "GRPC"):
        raise SystemExit(f"Unknown API type {api} (use REST or GRPC)")
    if api == "GRPC":
        try:  # before the model loads: a missing module fails fast
            from seldon_core_tpu_torch.transport.grpc_server import serve_component
        except ImportError as e:
            raise SystemExit(f"the GRPC API needs the '{e.name}' module, which is not "
                             f"installed: {e}") from e
    component = (build_component(args.interface_name, args.device, persistence=True)
                 if args.persistence else build_component(args.interface_name, args.device))
    port = args.port or int(os.environ.get("PREDICTIVE_UNIT_SERVICE_PORT", "5000"))
    if api == "GRPC":
        serve_component(component, host=args.host, port=port,
                        annotations=load_annotations(ANNOTATIONS_FILE))
        return
    from seldon_core_tpu_torch.transport.rest import make_component_app, serve

    serve(make_component_app(component, device=args.device,
                             annotations=load_annotations(ANNOTATIONS_FILE)),
          host=args.host, port=port)


DEFAULT_GRAPH = {"name": "default",
                 "graph": {"name": "simple", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}


def load_spec(path: Optional[str]):
    """The predictor spec from ``path``, else the environment
    (``load_predictor_spec_from_env``), else the reference engine's default
    one-unit SIMPLE_MODEL graph (`EnginePredictor.java:122-141`)."""
    from seldon_core_tpu_torch.contracts.graph import PredictorSpec, load_predictor_spec_from_env

    if path:
        with open(path) as f:
            return PredictorSpec.from_dict(json.load(f))
    spec = load_predictor_spec_from_env()
    return spec if spec is not None else PredictorSpec.from_dict(DEFAULT_GRAPH)


def run_engine(args: argparse.Namespace) -> None:
    setup_logging()
    api = (args.api or "REST").upper()
    if api == "IPC":
        raise SystemExit("--api IPC (the shared-memory ring) arrives with the native-edge slice "
                         "of the port; use REST or GRPC")
    if api not in ("REST", "GRPC"):
        raise SystemExit(f"Unknown API type {api} (use REST or GRPC)")
    if api == "GRPC":
        try:  # before the graph loads: a missing module fails fast
            from seldon_core_tpu_torch.transport.grpc_server import serve_engine
        except ImportError as e:
            raise SystemExit(f"the GRPC API needs the '{e.name}' module, which is not "
                             f"installed: {e}") from e
    from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
    from seldon_core_tpu_torch.runtime.engine import GraphEngine

    spec = load_spec(args.spec)
    annotations = load_annotations(ANNOTATIONS_FILE)
    engine = GraphEngine(spec, annotations=annotations, device=args.device)
    metrics = MetricsRegistry(predictor=spec.name)
    port = args.port or int(os.environ.get("ENGINE_SERVER_PORT", "8000"))
    logging.getLogger(__name__).info("engine serving predictor %r on port %d (%s)", spec.name,
                                     port, api)
    if api == "GRPC":
        serve_engine(engine, host=args.host, port=port, metrics=metrics, annotations=annotations)
        return
    from seldon_core_tpu_torch.transport.rest import make_engine_app, serve

    serve(make_engine_app(engine, metrics=metrics, annotations=annotations, device=args.device),
          host=args.host, port=port)


def _read_cr(path: str) -> dict:
    """A CR file: JSON by its name (no YAML needed), anything else through
    PyYAML (which also reads JSON)."""
    with open(path) as f:
        raw = f.read()
    if path.endswith(".json"):
        return json.loads(raw)
    from seldon_core_tpu_torch.controlplane.charts import import_yaml

    return import_yaml().safe_load(raw)


def run_render(args: argparse.Namespace) -> None:
    from seldon_core_tpu_torch.contracts.graph import SeldonDeploymentSpec
    from seldon_core_tpu_torch.controlplane import render_manifests
    from seldon_core_tpu_torch.controlplane.render import DEFAULT_ENGINE_IMAGE

    sdep = SeldonDeploymentSpec.from_dict(_read_cr(args.file))
    manifests = render_manifests(sdep, namespace=args.namespace,
                                 engine_image=args.engine_image or DEFAULT_ENGINE_IMAGE,
                                 gpus=args.gpus, gpu_product=args.gpu_product)
    if args.format == "json":
        print(json.dumps(manifests, indent=2))
    else:
        from seldon_core_tpu_torch.controlplane.charts import import_yaml

        print(import_yaml().safe_dump_all(manifests, sort_keys=False))


def run_operator(args: argparse.Namespace) -> None:
    setup_logging()
    from seldon_core_tpu_torch.controlplane.operator import (FileCluster, KubectlCluster,
                                                              Operator, Reconciler)

    cluster = KubectlCluster() if args.kubectl else FileCluster(args.cluster)
    reconciler = Reconciler(cluster, namespace=args.namespace, engine_image=args.engine_image,
                            gpus=args.gpus, gpu_product=args.gpu_product)
    op = Operator(args.crs, reconciler, interval=args.interval, status_dir=args.status_dir)
    if args.once:
        op.run_once()
    else:
        op.run_forever()


def run_render_chart(args: argparse.Namespace) -> None:
    """Render a deploy/charts chart without the helm binary (the in-repo
    subset renderer; ``helm template`` produces the same output)."""
    from seldon_core_tpu_torch.controlplane.charts import import_yaml, render_chart

    values = {}
    if args.values:
        with open(args.values) as f:
            values = import_yaml().safe_load(f) or {}
    for name, text in render_chart(args.chart, values, namespace=args.namespace):
        print(f"---\n# Source: {os.path.basename(args.chart)}/templates/{name}")
        print(text)


def run_analytics(args: argparse.Namespace) -> None:
    from seldon_core_tpu_torch.observability.dashboards import write_artifacts

    for path in write_artifacts(args.out):
        print(path)


def run_request_logger(args: argparse.Namespace) -> None:
    setup_logging()
    from seldon_core_tpu_torch.observability.request_logger import make_logger_app
    from seldon_core_tpu_torch.transport.rest import serve

    serve(make_logger_app(), host=args.host, port=args.port)


def run_loadtest(args: argparse.Namespace) -> None:
    from seldon_core_tpu_torch.client import loadgen

    loadgen.main(args)


def run_native_edge(args: argparse.Namespace) -> None:
    raise SystemExit(f"'{args.command}' drives the native C++ edge, which arrives with the "
                     f"native-edge slice of the port; use 'loadtest' (REST or --grpc)")


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(prog="seldon-core-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    ms = sub.add_parser("microservice", help="serve one component over REST or gRPC")
    ms.add_argument("interface_name")
    ms.add_argument("api", nargs="?", default=None, help="REST or GRPC")
    ms.add_argument("--port", type=int, default=None)
    ms.add_argument("--host", default="0.0.0.0")
    ms.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ms.add_argument("--persistence", action="store_true",
                    help="restore the component's persisted state and snapshot it")
    ms.set_defaults(func=run_microservice)
    eng = sub.add_parser("engine", help="serve a predictor graph in-process")
    eng.add_argument("--spec", default=None, help="path to a PredictorSpec JSON")
    eng.add_argument("--api", default="REST", help="REST or GRPC")
    eng.add_argument("--port", type=int, default=None)
    eng.add_argument("--host", default="0.0.0.0")
    eng.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    eng.set_defaults(func=run_engine)
    render = sub.add_parser("render", help="SeldonDeployment CR -> k8s manifests (operator logic)")
    render.add_argument("file", help="CR or spec JSON/YAML file")
    render.add_argument("--namespace", default="default")
    render.add_argument("--engine-image", default=None)
    render.add_argument("--gpus", type=int, default=1)
    render.add_argument("--gpu-product", default=None)
    render.add_argument("--format", default="yaml", choices=["yaml", "json"])
    render.set_defaults(func=run_render)
    op = sub.add_parser("operator", help="watch SeldonDeployment CRs and reconcile the cluster")
    op.add_argument("--crs", required=True, help="directory of CR JSON/YAML files")
    op.add_argument("--cluster", default="./cluster", help="FileCluster root dir")
    op.add_argument("--kubectl", action="store_true", help="apply via kubectl instead")
    op.add_argument("--namespace", default="default")
    op.add_argument("--engine-image", default=None)
    op.add_argument("--gpus", type=int, default=1)
    op.add_argument("--gpu-product", default=None)
    op.add_argument("--interval", type=float, default=2.0)
    op.add_argument("--status-dir", default=None,
                    help="status output dir (default <crs>/.status; set when --crs is read-only)")
    op.add_argument("--once", action="store_true", help="single reconcile pass")
    op.set_defaults(func=run_operator)
    rc = sub.add_parser("render-chart", help="render a deploy/charts helm chart (no helm needed)")
    rc.add_argument("chart", help="chart directory, e.g. deploy/charts/seldon-mab")
    rc.add_argument("--values", default=None, help="values override YAML file")
    rc.add_argument("--namespace", default="seldon-system")
    rc.set_defaults(func=run_render_chart)

    from seldon_core_tpu_torch.client.testers import add_tester_args, tester_main

    tester = sub.add_parser(
        "tester", help="contract-fuzz a microservice (seldon-core-tester equivalent)")
    add_tester_args(tester, endpoint_kind="microservice")
    tester.set_defaults(func=tester_main)
    api_tester = sub.add_parser(
        "api-tester", help="contract-fuzz an engine/gateway (seldon-core-api-tester equivalent)")
    add_tester_args(api_tester, endpoint_kind="engine")
    api_tester.set_defaults(func=tester_main)
    an = sub.add_parser("analytics", help="write Prometheus rules + Grafana dashboard artifacts")
    an.add_argument("--out", default="deploy/analytics")
    an.set_defaults(func=run_analytics)
    rl = sub.add_parser("request-logger", help="CloudEvents message-pair logger service")
    rl.add_argument("--port", type=int, default=2222)
    rl.add_argument("--host", default="0.0.0.0")
    rl.set_defaults(func=run_request_logger)
    lt = sub.add_parser("loadtest", help="closed-loop load generator (locust equivalent)")
    lt.add_argument("host")
    lt.add_argument("port", type=int)
    lt.add_argument("--clients", type=int, default=16)
    lt.add_argument("--duration", type=float, default=10.0)
    lt.add_argument("--batch", type=int, default=1)
    lt.add_argument("--contract", default=None)
    lt.add_argument("--grpc", action="store_true")
    lt.set_defaults(func=run_loadtest)
    for name in ("edge", "loadtest-native", "loadtest-worker", "loadtest-fleet"):
        native = sub.add_parser(name, help="the native C++ edge (the native-edge slice)")
        native.set_defaults(func=run_native_edge)
    args, extra = parser.parse_known_args(argv)
    if extra and args.func is not run_native_edge:   # the JAX arguments of a native command
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    args.func(args)


if __name__ == "__main__":
    main()
