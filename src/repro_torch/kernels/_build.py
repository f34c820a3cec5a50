"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

On first use each source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`:
every pointer and the stream are ``c_void_p``, and every C entry returns
``cudaGetLastError()`` of its launch, or :data:`UNSUPPORTED` for arguments
its kernel does not take, which :func:`check` turns into an exception.  Libraries go to ``build/repro_torch/`` at the root of the
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

__all__ = ["SOURCES", "UNSUPPORTED", "build_all", "build_log", "load",
           "check", "library_path"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("coded_matmul", "poly_encode", "flash_attention", "ssm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
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
    # q, k, v, o, lse (or NULL); B, H, Hkv, Lq, Lkv, D, causal, window,
    # q_offset; scale; (batch, head, position) strides of q, k, v, o; stream
    "flash_attention": {
        **{name: ([_P] * 5 + [_I] * 9 + [_F] + [_LL] * 12 + [_P], _I)
           for name in ("flash_attention_f32", "flash_attention_bf16")},
        # q, k, v, o, lse, do, dq, dk, dv, row dots; B, H, Hkv, Lq, Lkv, D,
        # causal, window, q_offset; scale; strides of q, k, v, o, do; stream
        **{name: ([_P] * 10 + [_I] * 9 + [_F] + [_LL] * 15 + [_P], _I)
           for name in ("flash_attention_bwd_f32",
                        "flash_attention_bwd_bf16")},
        # the instantiated head dims: (out array, its length) -> their count
        "flash_attention_head_dims": ([_P, _I], _I),
    },
    # x, dt, A, B, C, D, y, h_final, checkpoints (or NULL); Bt, L, Dm, S;
    # (batch, time) strides of x, dt, B, C; stream
    "ssm_scan": {
        **{name: ([_P] * 9 + [_I] * 4 + [_LL] * 8 + [_P], _I)
           for name in ("ssm_scan_f32", "ssm_scan_bf16")},
        # x, dt, A, B, C, D, dy, checkpoints, dx, ddt, dA, dB, dC, dD,
        # scratch; Bt, L, Dm, S; (batch, time) strides of x, dt, B, C; stream
        **{name: ([_P] * 15 + [_I] * 4 + [_LL] * 8 + [_P], _I)
           for name in ("ssm_scan_bwd_f32", "ssm_scan_bwd_bf16")},
        # Bt, L, Dm, S, out sizes[2]: the backward's scratch floats (and
        # its channel blocks) -> UNSUPPORTED or 0
        "ssm_scan_bwd_scratch": ([_I] * 4 + [_P], _I),
    },
}

# what a C entry returns, before launching, for arguments that none of its
# kernel's instances takes (a head dim, a query group, a state size); the
# sources are the only place that knows their tiling
UNSUPPORTED = -1

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
    """Raise if a C entry reported an error for its launch: ``ValueError``
    for :data:`UNSUPPORTED`, ``RuntimeError`` for a CUDA error."""
    if rc == UNSUPPORTED:
        raise ValueError(f"{what}: no instance of the kernel takes these "
                         "arguments (its source note lists what it supports)")
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def refuse_autograd(what: str, *tensors) -> None:
    """The serve's kernels (``coded_matmul``, ``poly_encode``) have no
    backward pass: raise rather than return an output that autograd cannot
    differentiate, when a gradient is being recorded for any of
    ``tensors`` (the plain versions differentiate).  Flash attention and
    the scan have backward kernels."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {what} kernel has no backward pass; run its "
                           "plain version under autograd (use_kernels=False)")
