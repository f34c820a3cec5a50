"""One idiom for rejecting unknown string specs across parse surfaces.

Every registry-backed parse surface in the repo — backends, transports,
compute kinds, chaos kinds, queue policies, arrival processes, benchmark
module names — rejects an unknown name with the same message shape::

    unknown <what> '<got>'; valid: a, b, c

so a typo'd flag always names the vocabulary that would have worked, and
one parametrized test (``tests/test_loadgen.py``) can pin the shape for
every surface at once.  The device paths' compute dtypes are one such
vocabulary (:func:`compute_dtype_name`), checked here for the serving
backends and the cluster's workers alike.
"""
from __future__ import annotations

from typing import Iterable

__all__ = ["COMPUTE_DTYPES", "compute_dtype_name", "unknown_name"]

# the compute dtypes of the device paths (the reference's kernel would also
# take float16, which no configuration of the repo uses)
COMPUTE_DTYPES = ("float32", "bfloat16")


def unknown_name(what: str, got, valid: Iterable[str]) -> ValueError:
    """``ValueError`` for a name outside a surface's vocabulary.

    ``what`` names the kind of thing ("backend", "chaos kind", ...); the
    valid names are listed verbatim, in the caller's order (sorted by the
    caller when the registry is unordered).
    """
    return ValueError(
        f"unknown {what} {str(got)!r}; valid: {', '.join(valid)}")


def compute_dtype_name(dtype=None) -> str:
    """The device paths' compute dtype as a name: ``None`` → ``"float32"``;
    float32 or bfloat16 as ``torch`` dtypes or names (``"bfloat16"``,
    ``"torch.bfloat16"``).  Any other raises ``ValueError`` naming it."""
    name = "float32" if dtype is None else str(dtype).removeprefix("torch.")
    if name not in COMPUTE_DTYPES:
        raise unknown_name("compute dtype", name, COMPUTE_DTYPES)
    return name
