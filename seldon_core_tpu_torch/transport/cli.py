"""Command-line entry point of the port.

``python -m seldon_core_tpu_torch.transport.cli microservice <ModelFile> REST
--port N [--device cuda|cpu]`` imports class ``<ModelFile>`` from module
``<ModelFile>`` in the working directory (or a dotted ``pkg.mod.Class``),
constructs it with ``device=...``, loads it and serves it over REST. The
model class must accept a ``device`` keyword (an ``LLMServer`` subclass
passes ``**kwargs`` through). gRPC and the other subcommands of
``seldon_core_tpu.transport.cli`` arrive with later slices.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import sys
from typing import Optional


def import_interface(name: str):
    """Import `Name` from module `Name`, or `pkg.mod.Class` dotted form."""
    sys.path.insert(0, os.getcwd())
    if "." in name:
        module_name, _, class_name = name.rpartition(".")
    else:
        module_name = class_name = name
    module = importlib.import_module(module_name)
    return getattr(module, class_name)


def run_microservice(args: argparse.Namespace) -> None:
    from seldon_core_tpu_torch.transport.rest import make_component_app, serve

    logging.basicConfig(level=os.environ.get("SELDON_LOG_LEVEL", "INFO").upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    api = (args.api or "REST").upper()
    if api != "REST":
        raise SystemExit(f"API type {api} is not ported yet (REST only; gRPC arrives "
                         f"with a later slice)")
    klass = import_interface(args.interface_name)
    try:
        component = klass(device=args.device)
    except TypeError as e:
        raise SystemExit(f"{args.interface_name}(device=...) failed: {e} — the model "
                         f"class must accept a device keyword") from e
    component.load()
    port = args.port or int(os.environ.get("PREDICTIVE_UNIT_SERVICE_PORT", "5000"))
    serve(make_component_app(component, device=args.device), host=args.host, port=port)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(prog="seldon-core-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    ms = sub.add_parser("microservice", help="serve one component over REST")
    ms.add_argument("interface_name")
    ms.add_argument("api", nargs="?", default=None, help="REST")
    ms.add_argument("--port", type=int, default=None)
    ms.add_argument("--host", default="0.0.0.0")
    ms.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ms.set_defaults(func=run_microservice)
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
