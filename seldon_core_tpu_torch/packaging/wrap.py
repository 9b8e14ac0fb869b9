"""Build a servable container image from a user model directory: the
port's copy of ``seldon_core_tpu/packaging/wrap.py`` (the reference's s2i
python wrapper: `wrappers/s2i/python/s2i/bin/assemble` copies user source
into the image, `.../bin/run:10-20` execs `seldon-core-microservice
$MODEL_NAME $API_TYPE ...`). The generated Containerfile layers the model
directory onto the port's engine image (``controlplane/render.py``'s
``DEFAULT_ENGINE_IMAGE``) and bakes the port's microservice command,
``python -m seldon_core_tpu_torch.transport.cli microservice``, driven by
the same knobs as environment variables.

CLI:
    python -m seldon_core_tpu_torch.packaging.wrap MyModel ./model-dir \
        -t my-registry/my-model:0.1 [--api GRPC] [--requirements] [--build]

Without --build it writes the Containerfile into the model directory and
prints the build command (so image builds run where a container runtime
lives, not necessarily where the wrap is invoked).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from typing import List, Optional

from seldon_core_tpu_torch.controlplane.render import DEFAULT_ENGINE_IMAGE

DEFAULT_BASE = DEFAULT_ENGINE_IMAGE

_RUNTIMES = ("docker", "podman", "nerdctl", "buildah")


def detect_runtime() -> Optional[str]:
    """First available container build tool, None when the host has none."""
    for name in _RUNTIMES:
        if shutil.which(name):
            return name
    return None


def containerfile_for_model(
    model_name: str,
    *,
    base_image: str = DEFAULT_BASE,
    api: str = "REST",
    install_requirements: bool = False,
    persistence: bool = False,
) -> str:
    """The Containerfile text for a model directory (assumed build context).

    Mirrors the s2i contract: user code at the image's working dir, model
    served by the wrapper CLI with MODEL_NAME/API_TYPE overridable at run
    time (the reference reads the same knobs from s2i environment files).
    """
    api = api.upper()
    if api not in ("REST", "GRPC"):
        raise ValueError(f"api must be REST or GRPC, got {api!r}")
    lines = [
        f"# generated by seldon_core_tpu_torch.packaging.wrap for {model_name}",
        f"FROM {base_image}",
        "WORKDIR /microservice",
        "COPY . /microservice",
    ]
    if install_requirements:
        lines.append(
            # if-guard, not `|| true`: a missing file is fine, but a REAL
            # pip failure must fail the build
            "RUN if [ -f requirements.txt ]; then "
            "pip install --no-cache-dir -r requirements.txt; fi"
        )
    persist = "1" if persistence else "0"
    lines += [
        "ENV PYTHONPATH=/microservice:/app \\",
        f"    MODEL_NAME={model_name} \\",
        f"    API_TYPE={api} \\",
        f"    PERSISTENCE={persist}",
        # exec-form shell trampoline so the baked env stays overridable at
        # `docker run -e MODEL_NAME=Other` time, like s2i's run script
        'ENTRYPOINT ["/bin/sh", "-c", '
        '"exec python -m seldon_core_tpu_torch.transport.cli microservice '
        '$MODEL_NAME $API_TYPE '
        '$([ \\"$PERSISTENCE\\" = 1 ] && echo --persistence)"]',
    ]
    return "\n".join(lines) + "\n"


def wrap_model(
    model_name: str,
    model_dir: str,
    tag: str,
    *,
    base_image: str = DEFAULT_BASE,
    api: str = "REST",
    install_requirements: bool = False,
    persistence: bool = False,
    build: bool = False,
    runtime: Optional[str] = None,
) -> List[str]:
    """Write <model_dir>/Containerfile; optionally build it. Returns the
    build command (executed when build=True)."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(model_dir)
    if not os.path.exists(os.path.join(model_dir, model_name + ".py")):
        raise FileNotFoundError(
            f"{model_dir}/{model_name}.py — the wrapper serves the class "
            f"{model_name} from that file (reference contract)"
        )
    text = containerfile_for_model(
        model_name,
        base_image=base_image,
        api=api,
        install_requirements=install_requirements,
        persistence=persistence,
    )
    path = os.path.join(model_dir, "Containerfile")
    with open(path, "w") as f:
        f.write(text)
    runtime = runtime or detect_runtime()
    cmd = [runtime or "docker", "build", "-f", path, "-t", tag, model_dir]
    if build:
        if runtime is None:
            raise RuntimeError(
                "no container runtime found (tried %s)" % ", ".join(_RUNTIMES)
            )
        subprocess.run(cmd, check=True)
    return cmd


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.packaging.wrap",
        description="wrap a user model directory into a servable image",
    )
    ap.add_argument("model_name", help="class name, served from <name>.py")
    ap.add_argument("model_dir")
    ap.add_argument("-t", "--tag", required=True)
    ap.add_argument("--base-image", default=DEFAULT_BASE)
    ap.add_argument("--api", default="REST", choices=["REST", "GRPC", "rest", "grpc"])
    ap.add_argument("--requirements", action="store_true",
                    help="pip install the directory's requirements.txt")
    ap.add_argument("--persistence", action="store_true")
    ap.add_argument("--build", action="store_true",
                    help="invoke the container runtime (default: just write "
                         "the Containerfile and print the command)")
    args = ap.parse_args(argv)
    cmd = wrap_model(
        args.model_name, args.model_dir, args.tag,
        base_image=args.base_image, api=args.api,
        install_requirements=args.requirements,
        persistence=args.persistence, build=args.build,
    )
    print(" ".join(cmd))


if __name__ == "__main__":
    main()
