"""Factory registry for the CDC schemes benchmarked in the paper (Table I)."""
from __future__ import annotations

import numpy as np

from .codes.group_sac import GroupSACCode
from .codes.lagrange import LagrangeCode
from .codes.layer_sac import LayerSACCode
from .codes.matdot import EpsApproxMatDotCode, MatDotCode
from .codes.orthomatdot import OrthoMatDotCode
from .points import x_complex

__all__ = ["make_code", "make_code_from_spec", "restrict_code", "CODE_NAMES",
           "paper_fig3a_codes"]

CODE_NAMES = ("matdot", "eps_matdot", "orthomatdot", "lagrange",
              "group_sac", "layer_sac_ortho", "layer_sac_lagrange")


def make_code(name: str, K: int, N: int, *, eval_points=None,
              rng: np.random.Generator | None = None, **kw):
    if name == "matdot":
        return MatDotCode(K, N, eval_points, **kw)
    if name == "eps_matdot":
        return EpsApproxMatDotCode(K, N, eval_points, **kw)
    if name == "orthomatdot":
        return OrthoMatDotCode(K, N, eval_points)
    if name == "lagrange":
        return LagrangeCode(K, N, eval_points, **kw)
    if name == "group_sac":
        return GroupSACCode(K, N, eval_points, rng=rng, **kw)
    if name == "layer_sac_ortho":
        return LayerSACCode(K, N, base="ortho", **kw)
    if name == "layer_sac_lagrange":
        return LayerSACCode(K, N, base="lagrange", **kw)
    raise ValueError(f"unknown code {name!r}; known: {CODE_NAMES}")


def make_code_from_spec(spec, *, rng: np.random.Generator | None = None):
    """Construct a code from a declarative spec (``repro.design.CodeSpec``).

    Duck-typed: any object with ``family`` / ``K`` / ``N`` attributes and a
    ``registry_kwargs()`` method (returning the keyword arguments of
    :func:`make_code`, including ``eval_points`` where the family needs
    them) builds here — the design subsystem stays a pure consumer of the
    registry, and a spec round-trips to the exact code it names.
    """
    kw = dict(spec.registry_kwargs())
    eval_points = kw.pop("eval_points", None)
    return make_code(spec.family, spec.K, spec.N, eval_points=eval_points,
                     rng=rng, **kw)


def restrict_code(code, N_prime: int):
    """The code ``code`` deployed on its first ``N_prime`` encode shards.

    The elastic-fleet primitive: the returned code has ``N = N_prime`` and
    evaluation points ``code.eval_points[:N_prime]``, so its shards are
    *exactly* the first ``N_prime`` shards of the original — serving it on a
    shrunk fleet is bit-identical to serving the original code with
    ``MasterScheduler.set_fleet(N_prime)`` (the property
    ``tests/test_design.py`` pins per family).  ``decode_basis`` is carried
    over from the original: bases whose conditioning scale derives from the
    point set (column scaling, mapped-Chebyshev spans) must not be refitted
    to the truncated points, or the extraction weights drift.

    Raises :class:`ValueError` where the family cannot shrink that far
    (below the recovery threshold, or an L-SAC truncation that empties a
    cluster).
    """
    N_prime = int(N_prime)
    if not 1 <= N_prime <= code.N:
        raise ValueError(f"need 1 <= N_prime <= N={code.N}, got {N_prime}")
    if N_prime == code.N:
        return code
    pts = code.eval_points[:N_prime]
    try:
        if isinstance(code, GroupSACCode):
            new = GroupSACCode(code.K, N_prime, pts, code.group_sizes,
                               permutation=code.permutation)
        elif isinstance(code, LayerSACCode):
            n_sizes = np.bincount(code.cluster[:N_prime],
                                  minlength=code.K)
            if np.any(n_sizes <= 0):
                raise ValueError(
                    f"truncating {code.name} to N={N_prime} empties "
                    f"cluster(s) {np.nonzero(n_sizes == 0)[0].tolist()}; "
                    f"smallest supported fleet is "
                    f"N={code.N - int(code.n_sizes[-1]) + 1}")
            new = LayerSACCode(code.K, N_prime, base=code.base,
                               n_sizes=n_sizes, eps=code.eps,
                               anchors=code.anchors)
            # clustered_points re-spreads offsets for the truncated cluster
            # sizes; the restricted code's shards must be the original ones
            new.eval_points = pts
            new.cluster = code.cluster[:N_prime].copy()
        elif isinstance(code, LagrangeCode):
            new = LagrangeCode(code.K, N_prime, pts, anchors=code.anchors)
        elif isinstance(code, (MatDotCode, OrthoMatDotCode)):
            # EpsApproxMatDotCode subclasses MatDotCode: same signature
            new = type(code)(code.K, N_prime, pts)
        else:
            raise ValueError(f"don't know how to restrict "
                             f"{type(code).__name__}")
    except ValueError as e:
        raise ValueError(f"cannot restrict {code!r} to N={N_prime}: "
                         f"{e}") from e
    if hasattr(code, "decode_basis"):
        new.decode_basis = code.decode_basis
    return new


def paper_fig3a_codes(K: int = 8, N: int = 24):
    """The five curves of Fig. 3a, with the paper's exact settings."""
    xc = x_complex(N, 0.1)                       # X_complex = {0.1 e^{i2πn/N}}

    def gsac_k1(k1):
        def f(rng):
            return GroupSACCode(K, N, xc, [k1, K - k1] if k1 < K else [K],
                                rng=rng)
        return f

    return {
        "eps_matdot": lambda rng: EpsApproxMatDotCode(K, N, xc),
        "gsac_k1_8": gsac_k1(8),
        "gsac_k1_5": gsac_k1(5),
        "lsac_ortho": lambda rng: LayerSACCode(K, N, base="ortho",
                                               eps=6.25e-3),
        "lsac_lagrange": lambda rng: LayerSACCode(K, N, base="lagrange",
                                                  eps=3.33e-2),
    }
