"""Build and load the port's hand-written CUDA kernels.

Every ``kernels/*/csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its
own ``nvcc`` process, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with
``ctypes``. Nothing here runs at import time: the first kernel launch
builds (or reuses) the library, so the CPU tests can import every module
without ``nvcc``.

Shared headers live in ``kernels/common/`` (included by relative path);
every ``*.cuh`` under ``kernels/`` goes into the hash below.

The library lands in ``kernels/build/`` (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is loaded as is. ``REPRO_TORCH_BUILD_DIR``
overrides the directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_lib: Optional[ctypes.CDLL] = None
_entries: dict = {}


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", KERNELS_DIR / "build"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the Hopper kernels build only where "
                       "the CUDA toolkit is installed")


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    for hdr in sorted(KERNELS_DIR.glob("**/*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = sources()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"librepro_torch_kernels-{_digest(srcs)}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    objs, procs = [], []
    for s in srcs:
        obj = out_dir / f"{s.stem}-{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for s, p in zip(srcs, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"--- {s}\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                           "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def entry(name: str, argtypes: list):
    """A C entry point of the library with its ``argtypes`` declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32
    bits) and ``int`` (the ``cudaError_t``) as its result. Looked up
    once: a wrapper calls this on every launch."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(lib(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
