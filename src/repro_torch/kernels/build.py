"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` is compiled on first use into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/repro_torch/<name>-<hash>.so <name>.cu

under ``build/repro_torch/`` at the checkout's root (listed in
``.gitignore``).  The file name carries a hash of the source, of every
header it includes from ``csrc/`` (``#include "..."``, followed
recursively) and of the flags, so an edited kernel or header is rebuilt
and a stale library is never loaded.  The compiler's output (``ptxas``'
registers, spills and shared memory per kernel) is kept beside the
library as ``<name>-<hash>.log``; :func:`ptxas_log` reads it.  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them; that is
what ``chip_smoke.py`` times.  Nothing here runs at import: this module is
imported on machines without ``nvcc`` (the CPU tests).

Every C entry point returns ``cudaGetLastError()`` after its launch (or a
negative code for arguments it refuses); :func:`check` turns a non-zero
return into ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "check", "ptxas_log", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("paged_decode_attention", "flash_attention", "decode_attention",
           "ssd_scan", "batched_gather")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file it includes from ``csrc/``,
    recursively, each once, in the order first met."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and CSRC in dep.parents:
                todo.append(dep)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every listed source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``; raises ``RuntimeError`` with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            todo[n].with_suffix(".log").write_text(log)
            tmp.replace(todo[n])  # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all((name,))[name]))
        return lib


def ptxas_log(name: str) -> str:
    """The compiler's output for the current build of ``csrc/<name>.cu``
    (empty if it has not been built)."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a failure."""
    if code == 0:
        return
    if code < 0:
        raise ValueError(f"{name}: the kernel refused its arguments (code {code})")
    raise RuntimeError(f"{name}: CUDA error {code} at launch")
