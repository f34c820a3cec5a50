"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

On first use each source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`:
every pointer and the stream are ``c_void_p``, and every C entry returns
``cudaGetLastError()`` of its launch, which :func:`check` turns into an
exception.  Libraries go to ``build/repro_torch/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is actually asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build_all", "build_log", "load", "check",
           "library_path"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("coded_matmul", "poly_encode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures, (argtypes, restype) per exported symbol
SIGNATURES = {
    "coded_matmul": {
        "coded_matmul_f32": ([_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _I,
                              _I, _P], _I),
        "coded_matmul_bf16": ([_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _I,
                               _I, _P], _I),
    },
    "poly_encode": {
        "poly_encode_f32": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL,
                             _LL, _LL, _P], _I),
        "poly_encode_bf16": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL,
                              _LL, _LL, _P], _I),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; ``None`` when the library is built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log").open("w")
    try:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    except OSError:
        log.close()
        raise
    return proc, tmp, out, log


def _finish(name: str, job) -> None:
    proc, tmp, out, log = job
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                           + out.with_suffix(".log").read_text())
    os.replace(tmp, out)          # atomic: a concurrent build never sees
    #                               a half-written library


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together; returns ``{name: library path}``."""
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas register
    and shared-memory report included), or ``""``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all((name,))[name]
    lib = ctypes.CDLL(str(path))
    for sym, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
