"""Port codes against the reference: the host float64 control is a copy.

``code_from_reference`` must rebuild every reference code with bit-equal
``generator()`` and bit-equal ``estimate_weights`` at every m of a fixed
completion order; the port's own registry must build the same codes as the
reference's.  Both are exact (``array_equal``): the copy changes import
paths only.
"""
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import CODE_NAMES
from repro.launch.serve import CODES as REF_CLI_CODES
import repro_torch.core as port_core
from repro_torch.convert import code_from_reference, to_device
from repro_torch.core import split_contraction

K, N = 4, 12


def _ref_registry_code(core, name):
    """A CODE_NAMES code from a package's registry, with the points the
    families that need them get in the reference's tests."""
    pts = {"matdot": core.x_complex(N, 0.1),
           "eps_matdot": core.x_complex(N, 0.1),
           "group_sac": core.x_complex(N, 0.1)}.get(name)
    kw = {"group_sizes": [2, 2]} if name == "group_sac" else {}
    rng = np.random.default_rng(3) if name == "group_sac" else None
    return core.make_code(name, K, N, eval_points=pts, rng=rng, **kw)


def _reference_codes():
    out = {f"registry:{n}": _ref_registry_code(ref_core, n)
           for n in CODE_NAMES}
    for n in ("gsac_k1_5", "lsac_ortho", "lsac_lagrange", "matdot",
              "eps_matdot", "gsac_auto"):
        out[f"cli:{n}"] = REF_CLI_CODES[n].build(8, 24)
    # restricted L-SAC keeps the original shards, not re-spread offsets
    out["restricted:lsac"] = ref_core.restrict_code(
        ref_core.LayerSACCode(4, 12, base="ortho", eps=1e-2), 10)
    return out


REF_CODES = _reference_codes()


def _assert_info_equal(a, b):
    assert (a.exact, a.m_pairs, a.layer) == (b.exact, b.m_pairs, b.layer)
    assert set(a.extra) == set(b.extra)
    for k in a.extra:
        np.testing.assert_array_equal(a.extra[k], b.extra[k])


@pytest.mark.parametrize("name", list(REF_CODES))
def test_code_from_reference_bit_equal_generator(name):
    ref = REF_CODES[name]
    port = code_from_reference(ref)
    assert type(port).__name__ == type(ref).__name__
    for g_port, g_ref in zip(port.generator(), ref.generator()):
        assert g_port.dtype == g_ref.dtype
        np.testing.assert_array_equal(g_port, g_ref)
    assert port.cache_key() == ref.cache_key()
    assert (port.first_threshold, port.recovery_threshold) == \
        (ref.first_threshold, ref.recovery_threshold)


@pytest.mark.parametrize("name", list(REF_CODES))
def test_code_from_reference_bit_equal_weights_every_m(name):
    ref = REF_CODES[name]
    port = code_from_reference(ref)
    order = np.random.default_rng(11).permutation(ref.N)
    for m in range(0, ref.N + 1):
        r, p = ref.estimate_weights(order[:m], m), \
            port.estimate_weights(order[:m], m)
        assert (r is None) == (p is None), m
        if r is None:
            continue
        np.testing.assert_array_equal(p[0], r[0])
        _assert_info_equal(p[1], r[1])
        assert port.decode_update(m) == ref.decode_update(m)
        assert port.decode_support(m) == ref.decode_support(m)


@pytest.mark.parametrize("name", CODE_NAMES)
def test_port_registry_builds_the_reference_codes(name):
    """The copied registry and code classes build bit-equal codes."""
    ref = _ref_registry_code(ref_core, name)
    port = _ref_registry_code(port_core, name)
    for g_port, g_ref in zip(port.generator(), ref.generator()):
        np.testing.assert_array_equal(g_port, g_ref)
    assert port.cache_key() == ref.cache_key()
    order = np.arange(N)[::-1]
    for m in range(1, N + 1):
        r, p = ref.estimate_weights(order, m), port.estimate_weights(order, m)
        assert (r is None) == (p is None)
        if r is not None:
            np.testing.assert_array_equal(p[0], r[0])


def test_split_contraction_views_match_numpy_blocks():
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((6, 24)), rng.standard_normal((24, 5))
    ref_Ab, ref_Bb = ref_core.split_contraction(A, B, 4)
    Ab, Bb = split_contraction(torch.tensor(A), torch.tensor(B), 4)
    np.testing.assert_array_equal(Ab.numpy(), ref_Ab)
    np.testing.assert_array_equal(Bb.numpy(), ref_Bb)
    np_Ab, np_Bb = split_contraction(A, B, 4)      # numpy stays numpy
    np.testing.assert_array_equal(np_Ab, ref_Ab)
    np.testing.assert_array_equal(np_Bb, ref_Bb)
    with pytest.raises(ValueError, match="divisible"):
        split_contraction(torch.tensor(A), torch.tensor(B), 5)


def test_to_device_keeps_structure_and_values():
    arrays = {"A": np.arange(6.0).reshape(2, 3), "pair": (np.ones(2),
                                                         np.zeros(3))}
    out = to_device(arrays, "cpu", torch.float32)
    assert out["A"].dtype == torch.float32 and isinstance(out["pair"], tuple)
    np.testing.assert_array_equal(out["A"].numpy(), arrays["A"])
    assert to_device(np.ones(3) * 1j, "cpu").is_complex()
