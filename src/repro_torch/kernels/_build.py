"""Build the kernels' CUDA sources into shared libraries at first use.

Every ``kernels/**/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``build/repro_torch/`` at the root of the
checkout.  The file name carries a hash of the source, the headers beside
it and the flags, so a changed source rebuilds and an unchanged one loads
from the cache.  The first ``load`` starts one ``nvcc`` per stale source,
all at once, and waits for them.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> list[pathlib.Path]:
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def library_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    candidate = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build from source at first use")
    return found


def build_all() -> dict[str, pathlib.Path]:
    """Compile every stale source in parallel; returns {stem: library}.

    Each library is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written file.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept beside
    the library as ``<library>.log``."""
    libs = {src.stem: library_path(src) for src in sources()}
    jobs = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in sources():
        out = libs[src.stem]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        pathlib.Path(f"{out}.log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if stale)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            _LIBS[stem] = lib
    return lib
