"""Port parity: DFX quantize (repro_torch.kernels.dfx_quant) vs the JAX
Pallas kernel in interpret mode and its oracle.

Inputs come from a numpy seed and go through both sides.  Integer outputs
(mantissas, limb planes) must match bit for bit wherever the scale exponent
lies in XLA:CPU's exact-``exp2`` window (checked at run time); outside it
the reference's scale carries ulps of error, so the test bounds the
mantissa flip rate and holds the port to an exact numpy oracle instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dfx as jdfx  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dfx  # noqa: E402
from repro_torch.kernels import dfx_quant, ops  # noqa: E402


def _exact_exp2(n: int) -> bool:
    """True when XLA:CPU's exp2 is exact at the integer ``n``."""
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _oracle(x: np.ndarray, exp: int, bits: int, u=None) -> np.ndarray:
    """Exact numpy oracle: f32 x times the exact power of two, then
    half-even (or floor(y+u)) and clip — the port's arithmetic."""
    y = x.astype(np.float32) * np.float32(np.ldexp(1.0, -exp))
    y = np.floor(y + u) if u is not None else np.round(y)
    lim = 2 ** (bits - 1) - 1
    return np.clip(y, -lim, lim)


@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("limb_planes", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_matches_pallas_in_exact_window(bits, limb_planes,
                                                 stochastic):
    rng = np.random.default_rng(bits * 4 + 2 * limb_planes + stochastic)
    x = (rng.standard_normal((37, 53)) * 3.0).astype(np.float32)
    u = rng.random((37, 53)).astype(np.float32) if stochastic else None
    exp = int(jdfx._scale_exponent(jnp.asarray(x), None)) - (bits - 1)
    assert _exact_exp2(-exp), exp
    ref = np.asarray(jops.quantize_pallas(
        jnp.asarray(x), jnp.int32(exp), bits,
        u=None if u is None else jnp.asarray(u), interpret=True,
        limb_planes=limb_planes))
    got = ops.quantize(torch.from_numpy(x), torch.tensor(exp, dtype=torch.int32),
                       bits, u=None if u is None else torch.from_numpy(u),
                       limb_planes=limb_planes)
    assert got.numpy().dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if not limb_planes:
        orc = np.asarray(jref.dfx_quantize_ref(
            jnp.asarray(x), jnp.int32(exp), bits,
            None if u is None else jnp.asarray(u)))
        np.testing.assert_array_equal(got.numpy(), orc)


@pytest.mark.parametrize("bits,exp", [(16, -19), (12, -17), (8, -21)])
def test_quantize_outside_window_is_exact_and_flips_rarely(bits, exp):
    """exp outside [-12, 12]: the port equals the exact oracle; the
    reference's inexact exp2 flips at most 1% of mantissas by one step."""
    assert not _exact_exp2(-exp), exp
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((64, 96)) * 2.0 ** (exp + bits - 3)).astype(
        np.float32)
    got = dfx_quant.dfx_quantize(torch.from_numpy(x),
                                 torch.tensor(exp, dtype=torch.int32),
                                 bits=bits).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, _oracle(x, exp, bits))
    ref = np.asarray(jops.quantize_pallas(jnp.asarray(x), jnp.int32(exp),
                                          bits, interpret=True)).astype(np.int64)
    assert np.abs(got - ref).max() <= 1
    assert np.mean(got != ref) <= 0.01


@pytest.mark.parametrize("bits", [8, 10, 12, 14, 16])
def test_limb_split_matches_reference_split(bits):
    """Balanced base-2⁷ planes equal the reference's split, including the
    b=14 raw-carry corner, and reconstruct the mantissa."""
    rng = np.random.default_rng(bits)
    lim = 2 ** (bits - 1) - 1
    m = rng.integers(-lim, lim + 1, (40, 24)).astype(np.int32)
    m[0, :2] = (lim, -lim)
    got = ops.split_limbs_stacked(torch.from_numpy(m), bits).numpy()
    ref = np.asarray(jops.split_limbs_stacked(jnp.asarray(m), bits))
    np.testing.assert_array_equal(got, ref)
    rec = sum(got[j].astype(np.int64) << (7 * j) for j in range(len(got)))
    np.testing.assert_array_equal(rec, m)


def test_scale_exponent_and_pow2_match_reference():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal((8, 8)).astype(np.float32) * 1e-3,
              rng.standard_normal((3, 5)).astype(np.float32) * 7e4,
              np.zeros((4, 4), np.float32)):
        assert int(dfx.scale_exponent(torch.from_numpy(x))) == int(
            jdfx._scale_exponent(jnp.asarray(x), None))
    n = np.arange(-152, 130)
    got = dfx.pow2(torch.from_numpy(n)).numpy()
    with np.errstate(over="ignore"):          # 2^128.. -> inf
        want = np.ldexp(np.float64(1.0), n).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_transposed_input_quantizes_in_place_layout():
    """The tied head quantizes the table in its own (V, D) layout and reads
    the planes as their transposed view: the same planes as quantizing the
    contiguous embed.T, under the same exponent."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    exp = dfx.scale_exponent(table) - 7
    assert int(dfx.scale_exponent(table.t().contiguous())) == int(
        dfx.scale_exponent(table))
    a = dfx_quant.dfx_quantize(table, exp, bits=8,
                               limb_planes=True).transpose(-1, -2)
    b = dfx_quant.dfx_quantize(table.t().contiguous(), exp, bits=8,
                               limb_planes=True)
    assert torch.equal(a, b)
