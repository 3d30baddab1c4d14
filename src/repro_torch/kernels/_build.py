"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
`ctypes`. Nothing is built when a module is imported: the first `load` of a
source builds its library. Each source has its own lock, so `load` called
from several threads runs one ``nvcc`` per source, all at once. Libraries
are named by a hash of their source and flags, so an edited source is
rebuilt and an unchanged one is reused; `build_log` reads the compiler's
report (registers, shared memory) of the built library. Every C entry
point returns ``cudaGetLastError()`` after its launches; `check` raises on
a non-zero status.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_locks: Dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Count of a wrapper's kernel launches (thread-safe), in all
    (`count`) and, for a wrapper with a kernel per route, by route
    (`routes`).

    A wrapper bumps it once where it launches its kernel, and nowhere
    else, so a run can show that its main path went through the kernel.
    """

    def __init__(self, routes=()):
        self.count = 0
        self.routes = dict.fromkeys(routes, 0)
        self._lock = threading.Lock()

    def bump(self, route=None) -> None:
        """Record one launch, on `route` if the wrapper has routes."""
        with self._lock:
            self.count += 1
            if route is not None:
                self.routes[route] += 1

    def reset(self) -> None:
        """Set every count back to 0."""
        with self._lock:
            self.count = 0
            self.routes = dict.fromkeys(self.routes, 0)


def nvcc() -> str:
    """Path of the CUDA compiler (``nvcc`` on PATH, else the toolkit's)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = path / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return str(path)


def sources() -> List[str]:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(name: str, out: pathlib.Path) -> None:
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    done = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=False)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{done.stdout}")
    out.with_suffix(".log").write_text(done.stdout)
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _compile(name, path)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler's report for the built library of ``csrc/<name>.cu``."""
    return _lib_path(name).with_suffix(".log").read_text()


def check(status: int, error_string, what: str) -> None:
    """Raise if a C entry point reported a CUDA error; `error_string` is
    the library's ``cudaGetErrorString``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch "
                           f"({error_string(status).decode()})")
