"""The port's Monte-Carlo engine (``repro_torch.core.simulate``) against the
reference's.

* The numpy backend is a copy of the reference's: bit-identical curves.
* The ``torch`` backend (run here with ``device="cpu"``) evaluates the same
  dense ``(T, M, ·)`` products in float64 / complex128 tensors.  It is held
  to the numpy backend at 1e-10 relative plus twice the float64 rounding
  bound of the evaluation (``SimulationEngine.rounding_bound``): two
  summation orders of one entry differ by at most that much, and entries at
  the noise floor — exact-recovery residuals of 1e-25 and below, and the
  Gram trick's cancellations — are rounding noise in both.
* The torch backend changes no global torch setting.
"""
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro_torch.convert import code_from_reference
from repro_torch.core import (ProblemContext, SimulationEngine,
                              average_curves, average_curves_reference,
                              correlated_problem, random_problem, run_trace,
                              simulate_completion_batch)
from repro_torch.core import simulate_completion as port_simulate_completion

K, N = 4, 12


def _problem(seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((40, 320)), rng.standard_normal((320, 30))


def _ref_codes():
    xc = ref_core.x_complex(N, 0.1)
    return {
        "matdot": ref_core.MatDotCode(K, N, xc),
        "orthomatdot": ref_core.OrthoMatDotCode(K, N),
        "layer_sac": ref_core.LayerSACCode(K, N, base="ortho", eps=1e-2),
        "group_sac": ref_core.GroupSACCode(K, N, xc, [2, 2]),
        "lagrange": ref_core.LagrangeCode(K, N),
    }


def _factories(pkg):
    return {
        "matdot": lambda r: pkg.MatDotCode(K, N, pkg.x_complex(N, 0.1)),
        "layer_sac": lambda r: pkg.LayerSACCode(K, N, base="ortho",
                                                eps=1e-2),
        "group_sac": lambda r: pkg.GroupSACCode(K, N, pkg.x_complex(N, 0.1),
                                                [2, 2], rng=r),
    }


def _assert_bit_equal(a, b):
    for attr in ("ms", "total", "approx", "comp"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))


def _assert_within_bound(got, want, bound):
    """1e-10 relative plus twice the rounding bound, entry by entry; the
    same entries defined."""
    for attr in ("total", "approx", "comp"):
        r, e, b = getattr(want, attr), getattr(got, attr), getattr(bound,
                                                                   attr)
        assert np.array_equal(np.isnan(r), np.isnan(e)), attr
        ok = ~np.isnan(r)
        assert np.all(np.abs(e[ok] - r[ok]) <= 1e-10 * np.abs(r[ok])
                      + 2 * b[ok]), attr


# ------------------------------------------------- numpy backend: a copy

@pytest.mark.parametrize("name", list(_ref_codes()))
@pytest.mark.parametrize("norms", ["exact", "gram"])
def test_numpy_engine_bit_identical_to_reference(name, norms):
    A, B = _problem()
    ref = _ref_codes()[name]
    batch = ref_core.simulate_completion_batch(np.random.default_rng(4), N,
                                               6, model="shifted_exp",
                                               straggler_frac=0.3)
    want = ref_core.SimulationEngine(ref, A, B, norms=norms).run_batch(batch)
    got = SimulationEngine(code_from_reference(ref), A, B,
                           norms=norms).run_batch(batch.orders)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("name", ["matdot", "layer_sac", "group_sac"])
def test_average_curves_bit_identical_to_reference(name):
    import repro_torch.core as port_core
    A, B = _problem()
    want = ref_core.average_curves(_factories(ref_core)[name], A, B,
                                   trials=8, seed=3)
    got = average_curves(_factories(port_core)[name], A, B, trials=8,
                         seed=3)
    _assert_bit_equal(got, want)
    legacy = average_curves_reference(_factories(port_core)[name], A, B,
                                      trials=3, seed=3)
    _assert_bit_equal(legacy, ref_core.average_curves_reference(
        _factories(ref_core)[name], A, B, trials=3, seed=3))


def test_run_trace_problems_and_cross_products_match_reference():
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    np.testing.assert_array_equal(random_problem(rng_a, 8, 32, 6)[0],
                                  ref_core.random_problem(rng_b, 8, 32,
                                                          6)[0])
    A, B = correlated_problem(np.random.default_rng(1), 0.5, K, 8, 32, 6)
    Ar, Br = ref_core.correlated_problem(np.random.default_rng(1), 0.5, K,
                                         8, 32, 6)
    np.testing.assert_array_equal(A, Ar)
    np.testing.assert_array_equal(
        ProblemContext.build(A, B, K).cross_products(),
        ref_core.ProblemContext.build(Ar, Br, K).cross_products())
    ref = _ref_codes()["layer_sac"]
    trace = ref_core.simulate_completion(np.random.default_rng(2), N)
    _assert_bit_equal(run_trace(code_from_reference(ref), A, B, trace),
                      ref_core.run_trace(ref, Ar, Br, trace))


# ------------------------------------------------------- torch backend

@pytest.mark.parametrize("name", list(_ref_codes()))
@pytest.mark.parametrize("norms", ["exact", "gram"])
def test_torch_backend_matches_numpy(name, norms):
    """Real (orthomatdot, layer_sac, lagrange) and complex (matdot,
    group_sac) evaluation points, both norms, on the CPU."""
    A, B = _problem()
    code = code_from_reference(_ref_codes()[name])
    batch = simulate_completion_batch(np.random.default_rng(4), N, 6)
    ref = SimulationEngine(code, A, B, norms=norms)
    got = SimulationEngine(code, A, B, norms=norms, backend="torch",
                           device="cpu").run_batch(batch)
    want = ref.run_batch(batch)
    _assert_within_bound(got, want, ref.rounding_bound(batch))


def _trial_groups(factory, trials, seed):
    """``average_curves``' draws: one code and one order per trial, trials
    grouped by code identity (the engines it builds)."""
    rng = np.random.default_rng(seed)
    groups = {}
    for _ in range(trials):
        code = factory(rng)
        order = port_simulate_completion(rng, code.N).order
        groups.setdefault(code.cache_key(), (code, []))[1].append(order)
    return [(c, np.stack(o)) for c, o in groups.values()]


@pytest.mark.parametrize("norms", ["exact", "gram"])
def test_torch_backend_average_curves_and_ms_subset(norms):
    """Shuffled G-SAC (many engines on the cross-product path), trial by
    trial within the bound, then ``average_curves`` itself; and a subset of
    m on L-SAC."""
    import repro_torch.core as port_core
    A, B = _problem(5)
    fac = _factories(port_core)["group_sac"]
    groups = _trial_groups(fac, 6, 2)
    assert len(groups) > 4                   # average_curves goes "cross"
    problem = ProblemContext.build(A, B, K)
    for code, orders in groups:
        kw = dict(norms=norms, products="cross", problem=problem)
        ref = SimulationEngine(code, A, B, **kw)
        got = SimulationEngine(code, A, B, backend="torch", device="cpu",
                               **kw).run_batch(orders)
        _assert_within_bound(got, ref.run_batch(orders),
                             ref.rounding_bound(orders))
    want = average_curves(fac, A, B, trials=6, seed=2, norms=norms)
    got = average_curves(fac, A, B, trials=6, seed=2, norms=norms,
                         backend="torch", device="cpu")
    assert np.array_equal(np.isnan(got.total), np.isnan(want.total))
    code = code_from_reference(_ref_codes()["layer_sac"])
    ms = [1, 5, 9, 12]
    batch = simulate_completion_batch(np.random.default_rng(0), N, 4)
    ref = SimulationEngine(code, A, B, norms=norms)
    cur = SimulationEngine(code, A, B, norms=norms, backend="torch",
                           device="cpu").run_batch(batch, ms=ms)
    assert list(cur.ms) == ms and cur.total.shape == (4, 4)
    _assert_within_bound(cur, ref.run_batch(batch, ms=ms),
                         ref.rounding_bound(batch, ms=ms))


def test_rounding_bound_is_small_where_curves_are_resolvable():
    """The bound the torch comparison uses is far below the resolvable
    entries (approximate layers of L-SAC), so there the check is 1e-10
    relative."""
    A, B = _problem()
    code = code_from_reference(_ref_codes()["layer_sac"])
    batch = simulate_completion_batch(np.random.default_rng(4), N, 6)
    eng = SimulationEngine(code, A, B)
    cur, bound = eng.run_batch(batch), eng.rounding_bound(batch)
    R = code.recovery_threshold
    assert np.all(bound.total[:, :R - 1] <= 1e-11 * cur.total[:, :R - 1])


def test_torch_backend_leaves_global_torch_settings_alone():
    before = (torch.get_default_dtype(),
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    A, B = _problem()
    code = code_from_reference(_ref_codes()["matdot"])
    batch = simulate_completion_batch(np.random.default_rng(0), N, 2)
    for norms in ("exact", "gram"):
        SimulationEngine(code, A, B, backend="torch", device="cpu",
                         norms=norms).run_batch(batch)
    assert (torch.get_default_dtype(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before
    assert torch.tensor(1.0).dtype == torch.float32


def test_torch_backend_resolves_the_card_and_numpy_needs_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, B = _problem()
    code = code_from_reference(_ref_codes()["layer_sac"])
    assert SimulationEngine(code, A, B).device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulationEngine(code, A, B, backend="torch")
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        SimulationEngine(code, A, B, backend="jax")


def test_variant_shares_host_state_and_matches_a_fresh_engine():
    """``variant`` re-evaluates under another backend or norms mode without
    recomputing the worker products: bit-equal to a fresh numpy engine,
    within the bound for the torch backend."""
    A, B = _problem()
    code = code_from_reference(_ref_codes()["group_sac"])
    batch = simulate_completion_batch(np.random.default_rng(4), N, 6)
    base = SimulationEngine(code, A, B)
    for norms in ("exact", "gram"):
        fresh = SimulationEngine(code, A, B, norms=norms)
        _assert_bit_equal(base.variant(norms=norms).run_batch(batch),
                          fresh.run_batch(batch))
        tv = base.variant(backend="torch", norms=norms, device="cpu")
        assert tv._P is base._P and tv.device.type == "cpu"
        _assert_within_bound(tv.run_batch(batch), fresh.run_batch(batch),
                             fresh.rounding_bound(batch))
    assert base.backend == "numpy" and base.norms == "exact"
    with pytest.raises(ValueError, match="unknown norms"):
        base.variant(norms="frobenius")
