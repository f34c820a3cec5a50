"""Declarative code-configuration space for the straggler-aware autotuner.

A :class:`CodeSpec` is a hashable, frozen description of one operating point
of the paper's accuracy-speed tradeoff: a code family plus the knobs §IV
leaves to the operator — G-SAC group splits ``[K_1..K_D]``, L-SAC base and
cluster radius ε, the evaluation-point radius of the complex monomial codes,
and the β regime used at decode time.  ``core/registry.py`` constructs the
exact named code from a spec (:func:`repro_torch.core.registry.make_code_from_spec`),
so a spec is both a search-space coordinate and a deployment artifact.

:class:`CodeSpace` enumerates the valid specs for a ``(K, N)`` fleet across
every registered family, pruning configurations the fleet cannot support
(``N < R``, ``K ∤ N`` for equal L-SAC clusters, ...).  The enumeration is
deterministic, so sweep results are reproducible and cacheable on the spec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..core.codes.group_sac import group_thresholds
from ..core.points import x_complex
from ..core.registry import CODE_NAMES, make_code_from_spec

__all__ = ["CodeSpec", "CodeSpace", "default_spec", "group_compositions"]

# families whose encode evaluates monomials at complex points of radius r
_RADIUS_FAMILIES = ("matdot", "eps_matdot", "group_sac")
_LSAC_FAMILIES = ("layer_sac_ortho", "layer_sac_lagrange")


@dataclass(frozen=True)
class CodeSpec:
    """One candidate configuration — hashable, orderable, constructible.

    ``radius`` applies to the complex-monomial families (MatDot/ε-MatDot/
    G-SAC), ``groups`` to G-SAC, ``eps`` to L-SAC; unused knobs stay ``None``
    so equality and hashing compare only what the code actually reads.
    ``beta_mode`` is a decode-time knob (not a constructor argument) — it
    rides on the spec because the operating point it names includes the
    rescaling regime.
    """

    family: str
    K: int
    N: int
    radius: float | None = None
    groups: tuple[int, ...] | None = None
    eps: float | None = None
    beta_mode: str = "one"

    def __post_init__(self):
        if self.family not in CODE_NAMES:
            raise ValueError(f"unknown family {self.family!r}; known: "
                             f"{CODE_NAMES}")
        if self.groups is not None:
            object.__setattr__(self, "groups",
                               tuple(int(g) for g in self.groups))

    # ------------------------------------------------------------- validity
    def problems(self) -> list[str]:
        """Human-readable reasons this spec cannot run (empty = valid)."""
        out = []
        K, N = self.K, self.N
        if K < 1 or N < 1:
            out.append(f"need K >= 1 and N >= 1; got K={K}, N={N}")
            return out
        if self.family == "group_sac":
            if not self.groups:
                out.append("group_sac needs a group split")
            elif sum(self.groups) != K or any(g <= 0 for g in self.groups):
                out.append(f"groups {list(self.groups)} must be positive "
                           f"and sum to K={K}")
            else:
                R = group_thresholds(self.groups)[2]
                if N < R:
                    out.append(f"groups {list(self.groups)} need N >= {R}; "
                               f"got N={N}")
        elif N < 2 * K - 1:
            out.append(f"needs N >= 2K-1 = {2 * K - 1} for exact recovery; "
                       f"got N={N}")
        if self.family in _LSAC_FAMILIES and N % K != 0:
            out.append(f"equal L-SAC clusters need K | N; got K={K}, N={N}")
        return out

    # --------------------------------------------------------- construction
    def registry_kwargs(self) -> dict:
        """Keyword arguments completing ``make_code(family, K, N, ...)``."""
        kw: dict = {}
        if self.family in _RADIUS_FAMILIES:
            kw["eval_points"] = x_complex(self.N, self.radius
                                          if self.radius is not None else 0.1)
        if self.family == "group_sac":
            kw["group_sizes"] = list(self.groups)
        if self.family in _LSAC_FAMILIES and self.eps is not None:
            kw["eps"] = self.eps
        return kw

    def build(self, rng: np.random.Generator | None = None):
        """The named code, via the registry (raises on an invalid spec)."""
        probs = self.problems()
        if probs:
            raise ValueError(f"invalid spec {self.label()}: " +
                             "; ".join(probs))
        return make_code_from_spec(self, rng=rng)

    # -------------------------------------------------------------- display
    def label(self) -> str:
        """Short stable identifier, e.g. ``gsac[5,3]@0.1/one``."""
        bits = self.family
        if self.family == "group_sac" and self.groups:
            bits = f"gsac{list(self.groups)}".replace(" ", "")
        if self.radius is not None:
            bits += f"@{self.radius:g}"
        if self.eps is not None:
            bits += f"/eps{self.eps:g}"
        if self.beta_mode != "one":
            bits += f"/{self.beta_mode}"
        return bits


def default_spec(family: str, K: int, N: int, *,
                 beta_mode: str = "one") -> CodeSpec:
    """The family's canonical spec at ``(K, N)`` (paper Fig. 3a settings)."""
    if family == "group_sac":
        a = (K + 1) // 2
        groups = (K,) if K == 1 else (a, K - a)
        return CodeSpec(family, K, N, radius=0.1, groups=groups,
                        beta_mode=beta_mode)
    if family in _RADIUS_FAMILIES:
        return CodeSpec(family, K, N, radius=0.1, beta_mode=beta_mode)
    if family == "layer_sac_ortho":
        return CodeSpec(family, K, N, eps=6.25e-3, beta_mode=beta_mode)
    if family == "layer_sac_lagrange":
        return CodeSpec(family, K, N, eps=3.33e-2, beta_mode=beta_mode)
    return CodeSpec(family, K, N, beta_mode=beta_mode)


def group_compositions(K: int, max_groups: int) -> Iterator[tuple[int, ...]]:
    """All ordered splits ``[K_1..K_D]`` of K with ``1 <= D <= max_groups``.

    Order matters for G-SAC: ``K_1`` is the first threshold and earlier
    groups refine first, so ``(5, 3)`` and ``(3, 5)`` are distinct designs.
    """
    def rec(rest: int, parts: tuple[int, ...]) -> Iterator[tuple[int, ...]]:
        if rest == 0:
            yield parts
            return
        if len(parts) == max_groups:
            return
        for g in range(1, rest + 1):
            yield from rec(rest - g, parts + (g,))

    yield from rec(K, ())


class CodeSpace:
    """Deterministic enumeration of candidate :class:`CodeSpec` s.

    ``N_options`` widens the worker-cost axis of the Pareto search (deploying
    fewer than the full fleet is a legitimate design choice); it defaults to
    the single fleet size given.
    """

    def __init__(self, K: int, N: int, *, families=None,
                 radii=(0.1,), max_groups: int = 2,
                 eps_grid=(6.25e-3, 3.33e-2), beta_modes=("one",),
                 N_options=None):
        if K < 1 or N < 1:
            raise ValueError(f"need K >= 1 and N >= 1; got K={K}, N={N}")
        self.K = K
        self.N = N
        self.families = tuple(families) if families is not None else CODE_NAMES
        unknown = [f for f in self.families if f not in CODE_NAMES]
        if unknown:
            raise ValueError(f"unknown families {unknown}; known: "
                             f"{CODE_NAMES}")
        self.radii = tuple(float(r) for r in radii)
        self.max_groups = int(max_groups)
        self.eps_grid = tuple(float(e) for e in eps_grid)
        self.beta_modes = tuple(beta_modes)
        self.N_options = (tuple(int(n) for n in N_options)
                          if N_options is not None else (int(N),))
        self._specs: tuple[CodeSpec, ...] | None = None

    def _candidates(self) -> Iterator[CodeSpec]:
        for N in self.N_options:
            for beta in self.beta_modes:
                for fam in self.families:
                    if fam == "group_sac":
                        for groups in group_compositions(self.K,
                                                         self.max_groups):
                            for r in self.radii:
                                yield CodeSpec(fam, self.K, N, radius=r,
                                               groups=groups, beta_mode=beta)
                    elif fam in _RADIUS_FAMILIES:
                        for r in self.radii:
                            yield CodeSpec(fam, self.K, N, radius=r,
                                           beta_mode=beta)
                    elif fam in _LSAC_FAMILIES:
                        for eps in self.eps_grid:
                            yield CodeSpec(fam, self.K, N, eps=eps,
                                           beta_mode=beta)
                    else:
                        yield CodeSpec(fam, self.K, N, beta_mode=beta)

    def specs(self) -> tuple[CodeSpec, ...]:
        """All valid specs, deduplicated, in deterministic order."""
        if self._specs is None:
            seen, out = set(), []
            for spec in self._candidates():
                if spec in seen or spec.problems():
                    continue
                seen.add(spec)
                out.append(spec)
            if not out:
                raise ValueError(
                    f"CodeSpace(K={self.K}, N={self.N}) is empty — every "
                    "candidate is invalid for this fleet (raise N, lower K, "
                    "or widen families/N_options)")
            self._specs = tuple(out)
        return self._specs

    def __len__(self) -> int:
        return len(self.specs())

    def __iter__(self) -> Iterator[CodeSpec]:
        return iter(self.specs())

    @staticmethod
    def tiny(K: int, N: int, *, beta_mode: str = "one") -> "CodeSpace":
        """CI-smoke space: one default spec per family that fits (K, N)."""
        space = CodeSpace(K, N, beta_modes=(beta_mode,))
        specs = []
        for fam in CODE_NAMES:
            spec = default_spec(fam, K, N, beta_mode=beta_mode)
            if not spec.problems():
                specs.append(spec)
        if not specs:
            raise ValueError(f"no family fits (K={K}, N={N})")
        space._specs = tuple(specs)
        return space

    def __repr__(self):
        return (f"CodeSpace(K={self.K}, N={self.N}, "
                f"families={len(self.families)}, specs={len(self)})")
