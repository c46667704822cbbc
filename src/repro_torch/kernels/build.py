"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>-<key>.so <name>.cu

The libraries go into ``kernels/_build/`` (git-ignored), keyed by a hash
of every source under ``csrc/`` and the flags, and are built at first
use: ``load(name)`` builds the one library it needs, ``build_all()``
runs one ``nvcc`` per source, all at once, and loads them.  The
compiler's report (registers, shared memory, spills) is kept beside
each library as ``<lib>.log``.  Nothing here touches CUDA at import
time, so CPU-only machines import the package freely.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_key()}.so"


def _build(name: str) -> None:
    """Run nvcc for ``name`` unless its library is built."""
    out = library_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".so.log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)               # atomic: a half-built file never loads


def build_all() -> dict[str, Path]:
    """Build every source, one nvcc each, all started together, then
    load them; returns {name: library path}."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build, names))  # re-raises a failed build
    for name in names:
        load(name)
    return {name: library_path(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's report for the built ``name`` (empty if the
    library was built by an earlier process and its log is gone)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>``, built first if needed."""
    _build(name)
    return ctypes.CDLL(str(library_path(name)))
