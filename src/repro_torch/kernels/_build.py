"""Build the CUDA sources under ``kernels/csrc`` into shared libraries with a
plain C interface, and load them with ``ctypes``.

Each ``<name>.cu`` becomes ``build/repro_torch/<name>-<key>.so`` at the repo
root, where ``<key>`` hashes the source, the shared headers and the flags:
an edit rebuilds, an unchanged tree loads what is there.  ``nvcc`` runs at
first use only, never on import.  A missing ``nvcc`` or a failed build
raises with the compiler's output; nothing falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# --fmad=false: no multiply-add contraction, so `s1 + want2 * scale` and
# `u + u * p` round as the reference does; IEEE division and comparisons
# (never --use_fast_math).  -Xptxas -v writes registers and spills per
# kernel into the build log.
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ENTRIES: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "need the CUDA toolkit to build")


def _key(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_key(name)}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns name -> library path."""
    out = {name: library_path(name) for name in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        out[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out[name])  # atomic: a reader never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, argtypes) -> Callable[..., int]:
    """The C entry point ``name`` of ``csrc/<name>.cu``, built first if
    needed, bound to ``argtypes`` once and cached."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build([name])[name])), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def launch(name: str, argtypes, *args) -> None:
    """Call the C entry point ``name`` (it launches its kernel on the given
    stream and returns the launch's cudaError_t); raise if the launch
    failed."""
    err = load(name, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
