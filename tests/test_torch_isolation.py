"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and it never falls back to the CPU on its own.

- a subprocess with ``jax`` and ``seldon_core_tpu`` blocked from import
  imports every module of ``seldon_core_tpu_torch`` and serves one CPU
  ``generate()``;
- an AST walk over the package and ``chip_smoke.py`` finds no import of
  ``jax`` or ``seldon_core_tpu`` / ``seldon_core_tpu.*``;
- ``LLMServer()`` with no ``device`` raises when no CUDA device is present.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "seldon_core_tpu_torch"

BLOCKED_RUN = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "seldon_core_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import seldon_core_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(seldon_core_tpu_torch.__path__,
                                              "seldon_core_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from seldon_core_tpu_torch.servers.llmserver import LLMServer
s = LLMServer(model="llama-tiny", init_random=True, max_new_tokens=4, eos_id=-1,
              len_buckets=(16,), batch_buckets=(1,), device="cpu")
out = s.generate(["hi"])
assert len(out["tokens"][0]) == 4, out
print("OK", len(mods))
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 15, proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "seldon_core_tpu")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = sorted({n for n in _imports(path) if _forbidden(n)})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_default_device_raises_without_cuda(monkeypatch):
    from seldon_core_tpu_torch.device import resolve_device
    from seldon_core_tpu_torch.servers.llmserver import LLMServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LLMServer(model="llama-tiny", init_random=True)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
