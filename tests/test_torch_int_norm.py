"""Port parity: integer RMS-norm forward (repro_torch.kernels.int_norm) vs
the JAX Pallas kernel in interpret mode and its exact f64 oracle.

The three digit sums of Σx² are exact on both sides and recombine in f32
in the same order.  The one kept op, rsqrt, may round differently: the port
uses IEEE 1/sqrt, XLA:CPU its own rsqrt.  Stated tolerance, inside the
exact-``exp2`` window: rstd within 2 ulp (relative 2.4e-7) and y within 4
ulp of its row's max magnitude.  Outside the window (x_exp = -19) the
reference's scale carries up to ~34 ulp, so the bound there is 64 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import int_norm, ops  # noqa: E402

ULP = 2.0 ** -23


def _exact_exp2(n: int) -> bool:
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _case(bits, R, D, seed):
    rng = np.random.default_rng(seed)
    lim = 2 ** (bits - 1) - 1
    xm = rng.integers(-lim, lim + 1, (R, D)).astype(
        np.int8 if bits <= 8 else np.int16)
    gamma = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    return xm, gamma


def _run_both(xm, x_exp, gamma):
    y_ref, r_ref = jops.rmsnorm_pallas(jnp.asarray(xm), jnp.int32(x_exp),
                                       jnp.asarray(gamma), interpret=True)
    y, r = ops.rmsnorm(torch.from_numpy(xm),
                       torch.tensor(x_exp, dtype=torch.int32),
                       torch.from_numpy(gamma))
    return y.numpy(), r.numpy(), np.asarray(y_ref), np.asarray(r_ref)


@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("R,D", [(3, 100), (13, 1024)])
def test_rmsnorm_matches_pallas(bits, R, D):
    xm, gamma = _case(bits, R, D, bits + R)
    x_exp = {8: -6, 12: -10, 16: -12}[bits]      # |x| ~ 2: inside window
    assert _exact_exp2(x_exp)
    y, r, y_ref, r_ref = _run_both(xm, x_exp, gamma)
    assert y.shape == (R, D) and r.shape == (R, 1)
    np.testing.assert_allclose(r, r_ref, rtol=2 * ULP, atol=0)
    row = np.abs(y_ref).max(-1, keepdims=True)
    assert np.all(np.abs(y - y_ref) <= 4 * ULP * row)
    # and against the exact f64 oracle
    y_o, r_o = jref.int_rmsnorm_fwd_ref(jnp.asarray(xm), jnp.int32(x_exp),
                                        jnp.asarray(gamma))
    np.testing.assert_allclose(r, np.asarray(r_o), rtol=4 * ULP)
    assert np.all(np.abs(y - np.asarray(y_o)) <= 8 * ULP * row)


def test_rmsnorm_outside_window_within_64_ulp():
    xm, gamma = _case(12, 9, 256, 5)
    x_exp = -19
    assert not _exact_exp2(x_exp)
    y, r, y_ref, r_ref = _run_both(xm, x_exp, gamma)
    np.testing.assert_allclose(r, r_ref, rtol=64 * ULP)
    row = np.abs(y_ref).max(-1, keepdims=True)
    assert np.all(np.abs(y - y_ref) <= 64 * ULP * row)


def test_exact_square_sum_at_int16_extremes():
    """Σx² needs ~40 bits at int16 and D=1024: the digit split keeps the
    int sums exact, so a row of ±32767 gives the f32 rounding of the
    exact value."""
    xm = torch.full((2, 1024), 32767, dtype=torch.int16)
    xm[1] = -32767
    s2 = int_norm.exact_sq_sum(xm)
    exact = np.float32(float(32767 ** 2 * 1024))
    assert np.all(s2.numpy() == exact)
