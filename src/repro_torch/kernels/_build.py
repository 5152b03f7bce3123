"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``build/repro_torch_kernels/``
at the root of the checkout on first use. All sources compile in parallel,
one ``nvcc`` each. A library's file name carries a hash of its source, the
shared headers and the flags, so an edit triggers a rebuild. A failed build
or load raises; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource lines per kernel source, from the last build in this process.
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (where stale) and load every kernel library; name → CDLL."""
    with _lock:
        todo = {}
        for src in sorted(CSRC.glob("*.cu")):
            if src.stem in _libs:
                continue
            out = _lib_path(src)
            if not out.exists():
                todo[src] = out
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for src, out in todo.items():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                procs[src] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for src, (tmp, proc) in procs.items():
                log, _ = proc.communicate()
                build_log[src.stem] = log
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{log}")
                else:
                    os.replace(tmp, todo[src])
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in sorted(CSRC.glob("*.cu")):
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib
