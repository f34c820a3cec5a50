"""One idiom for rejecting unknown string specs across parse surfaces.

Every registry-backed parse surface in the repo — backends, transports,
compute kinds, chaos kinds, queue policies, arrival processes, benchmark
module names — rejects an unknown name with the same message shape::

    unknown <what> '<got>'; valid: a, b, c

so a typo'd flag always names the vocabulary that would have worked, and
one parametrized test (``tests/test_loadgen.py``) can pin the shape for
every surface at once.
"""
from __future__ import annotations

from typing import Iterable

__all__ = ["unknown_name"]


def unknown_name(what: str, got, valid: Iterable[str]) -> ValueError:
    """``ValueError`` for a name outside a surface's vocabulary.

    ``what`` names the kind of thing ("backend", "chaos kind", ...); the
    valid names are listed verbatim, in the caller's order (sorted by the
    caller when the registry is unordered).
    """
    return ValueError(
        f"unknown {what} {str(got)!r}; valid: {', '.join(valid)}")
