"""PyTorch/CUDA port of the SAC coded-matmul serving system.

The JAX package :mod:`repro` is the reference and stays untouched; this
package keeps the reference's module names so each counterpart is easy to
find, and imports nothing from it.  Host float64 control (codes, decode
solves, β rules, straggler models) is a copy under :mod:`repro_torch.core`;
the worker products and the encode run in hand-written CUDA kernels
(:mod:`repro_torch.kernels`, sources in ``csrc/``), and serving
(:mod:`repro_torch.serving`, :mod:`repro_torch.launch.serve`) keeps
operands, products and decode state on the card from submit to answer.

Importing the package itself loads no torch: a numpy-compute cluster
worker (:mod:`repro_torch.cluster.worker`, the spawn target) starts
without it.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
