"""The port stands alone: importing every module of ``repro_torch`` pulls in
neither JAX nor anything of the reference package ``repro``, and
``chip_smoke.py`` imports nothing of either.  Runs in a subprocess so the
check sees a clean ``sys.modules``."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
if bad:
    raise SystemExit("repro_torch pulled in: " + ", ".join(bad))
print("clean", len(names))
"""


def _foreign(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("clean")
    assert int(proc.stdout.split()[1]) >= 20   # every module was walked


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    assert "repro_torch.storage" in imported
    assert not [m for m in imported if _foreign(m)], imported
