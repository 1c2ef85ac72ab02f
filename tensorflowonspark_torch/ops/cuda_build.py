"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one source ``tensorflowonspark_torch/csrc/<name>.cu`` with a
plain C interface.  ``load_library(name)`` compiles it with ``nvcc`` for
Hopper (``sm_90a``) into a shared library under
``tensorflowonspark_torch/_kernel_build/``, named by a hash of the sources
and headers in ``csrc/`` and the flags, so an edited source or header
rebuilds and an unchanged tree is reused.
Nothing is built or imported when this module is imported: the CPU tests
import every module on machines without ``nvcc``.

``load_libraries(*names)`` starts one ``nvcc`` per source, all at once, and
waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_SECS = 600

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built on a machine with the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives once built: named by a hash of every
    ``csrc/*.cu`` and ``csrc/*.cuh`` file (any of them may be included) and
    the flags, so an edited header rebuilds too."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``, or '' if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(proc, tmp, out, log)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, log


def _finish_build(name: str, started) -> None:
    proc, tmp, out, log = started
    try:
        text, _ = proc.communicate(timeout=BUILD_TIMEOUT_SECS)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}") from None
    log.write_text(text)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(exit {proc.returncode}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def load_libraries(*names: str) -> list[ctypes.CDLL]:
    """Build (in parallel) and load the named kernels' libraries."""
    with _LOCK:
        todo = [n for n in names if n not in _LOADED]
        started = {n: _start_build(n) for n in todo}
        try:
            for n, s in started.items():
                if s is not None:
                    _finish_build(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].communicate()
        for n in todo:
            _LOADED[n] = ctypes.CDLL(str(library_path(n)))
        return [_LOADED[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    return load_libraries(name)[0]
