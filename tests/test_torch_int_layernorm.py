"""Port parity: integer layer-norm forward and backward
(repro_torch.kernels.int_norm) vs the JAX Pallas kernels in interpret mode
(through ``kernels/ops.py``) and their exact f64 oracles in
``kernels/ref.py``.

The integer sums (Σx, the three digit sums of Σx², dβ's Σg) are exact on
both sides.  The f32 arithmetic follows the reference's expressions, but
the kept ops may round differently (the port's IEEE 1/sqrt against
XLA:CPU's rsqrt) and the backward's f32 row and column sums run in another
order.  The one-pass variance E[x²] − μ² is known only to a few ulp of
E[x²], and XLA:CPU evaluates it with a reciprocal multiply and an FMA
where the port (and the CUDA kernel) round each operation: on a row whose
variance is small beside its mean square the two roundings part, the
more the larger the row's cancellation ratio
κ = E[x²] / (Var[x] + eps · 2^(-2·x_exp)) (a constant row of ±1873 gives
κ ≈ 3e7 and an rstd 0.5% apart; the port there equals the exact f64
oracle).  Stated tolerances, inside the exact-``exp2`` window: mu within
2 ulp; rstd within (4 + 4κ) ulp; y within 16 ulp of its row's max|y| plus
rstd's bound times the row's max|xn·γ|; dx within 64 ulp of its row's
max|dx| (the three-term difference cancels); dγ within 64 ulp of the
column's Σ|gq·xn|; dβ bit for bit.  Outside the window (x_exp = -19) the
reference's scale carries up to ~34 ulp, so mu is held within 64 ulp
there and the flat part of the bounds on rstd and y is 128 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import int_norm  # noqa: E402

ULP = 2.0 ** -23


def _exact_exp2(n: int) -> bool:
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _mantissas(rng, bits, shape):
    lim = 2 ** (bits - 1) - 1
    return rng.integers(-lim, lim + 1, shape).astype(
        np.int8 if bits <= 8 else np.int16)


def _case(xbits, gbits, R, D, seed):
    rng = np.random.default_rng(seed)
    xm = _mantissas(rng, xbits, (R, D))
    xm[0] = xm[0, 0]                 # a constant row: variance clamped at 0
    xm[1] += np.asarray(2 ** (xbits - 3), xm.dtype)   # a row with mean >> std
    xm[1] = np.clip(xm[1], -(2 ** (xbits - 1) - 1), 2 ** (xbits - 1) - 1)
    gm = _mantissas(rng, gbits, (R, D))
    gamma = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return xm, gm, gamma, beta


def _e(n):
    return torch.tensor(n, dtype=torch.int32)


def _fwd_both(xm, x_exp, gamma, beta):
    ref = jops.layernorm_pallas(jnp.asarray(xm), jnp.int32(x_exp),
                                jnp.asarray(gamma), jnp.asarray(beta),
                                interpret=True)
    got = int_norm.int_layernorm_fwd(torch.from_numpy(xm), _e(x_exp),
                                     torch.from_numpy(gamma),
                                     torch.from_numpy(beta))
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


def _check_fwd(got, ref, xm, x_exp, gamma, ulps, ulps_mu=2, eps=1e-5):
    y, mu, rstd = got
    y0, mu0, rstd0 = ref
    assert y.shape == y0.shape and mu.shape == rstd.shape == mu0.shape
    np.testing.assert_allclose(mu, mu0, rtol=ulps_mu * ULP, atol=1e-30)
    x = xm.astype(np.float64)
    m2 = (x * x).mean(-1, keepdims=True)
    var = m2 - x.mean(-1, keepdims=True) ** 2
    kappa = m2 / (var + eps * 2.0 ** (-2 * x_exp))
    tol_r = (ulps + 4 * kappa) * ULP
    assert np.all(np.abs(rstd - rstd0) <= tol_r * rstd0)
    xn_g = np.abs((x * 2.0 ** x_exp - mu0) * rstd0 * gamma).max(
        -1, keepdims=True)
    row = np.abs(y0).max(-1, keepdims=True)
    assert np.all(np.abs(y - y0) <= ulps * ULP * row + tol_r * xn_g)


@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("R,D", [(3, 100), (37, 768)])
def test_layernorm_fwd_matches_pallas(bits, R, D):
    xm, _, gamma, beta = _case(bits, 8, R, D, bits + R)
    x_exp = {8: -6, 12: -10, 16: -12}[bits]     # |x| ~ 2: inside window
    assert _exact_exp2(x_exp)
    got, ref = _fwd_both(xm, x_exp, gamma, beta)
    _check_fwd(got, ref, xm, x_exp, gamma, 16)
    # and against the exact f64 oracle
    oracle = [np.asarray(a) for a in jref.int_layernorm_fwd_ref(
        jnp.asarray(xm), jnp.int32(x_exp), jnp.asarray(gamma),
        jnp.asarray(beta))]
    _check_fwd(got, oracle, xm, x_exp, gamma, 16)


def test_layernorm_fwd_outside_window():
    xm, _, gamma, beta = _case(12, 8, 9, 256, 5)
    assert not _exact_exp2(-19)
    got, ref = _fwd_both(xm, -19, gamma, beta)
    _check_fwd(got, ref, xm, -19, gamma, 128, ulps_mu=64)


def _bwd_both(xm, x_exp, gm, g_exp, gamma, mu, rstd):
    ref = jops.layernorm_bwd_pallas(
        jnp.asarray(xm), jnp.int32(x_exp), jnp.asarray(gm), jnp.int32(g_exp),
        jnp.asarray(gamma), jnp.asarray(mu), jnp.asarray(rstd),
        interpret=True)
    got = int_norm.int_layernorm_bwd(torch.from_numpy(xm),
                                     torch.from_numpy(gm), _e(x_exp),
                                     _e(g_exp), torch.from_numpy(gamma),
                                     torch.from_numpy(mu),
                                     torch.from_numpy(rstd))
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


def _check_bwd(got, ref, xm, x_exp, gm, g_exp, mu, rstd):
    dx, dg, db = got
    dx0, dg0, db0 = ref
    assert dx.shape == xm.shape and dg.shape == db.shape == (xm.shape[1],)
    row = np.abs(dx0).max(-1, keepdims=True)
    assert np.all(np.abs(dx - dx0) <= 64 * ULP * row)
    xn = (xm.astype(np.float64) * 2.0 ** x_exp - mu) * rstd
    col = np.abs(gm.astype(np.float64) * 2.0 ** g_exp * xn).sum(0)
    assert np.all(np.abs(dg - dg0) <= 64 * ULP * col)
    np.testing.assert_array_equal(db, db0)


@pytest.mark.parametrize("xbits,gbits", [(12, 8), (16, 16), (8, 8)])
@pytest.mark.parametrize("R,D", [(5, 96), (70, 768)])
def test_layernorm_bwd_matches_pallas(xbits, gbits, R, D):
    xm, gm, gamma, _ = _case(xbits, gbits, R, D, xbits + gbits + R)
    x_exp, g_exp = {8: -6, 12: -10, 16: -12}[xbits], {8: -6, 16: -12}[gbits]
    assert _exact_exp2(x_exp) and _exact_exp2(g_exp)
    _, mu, rstd = int_norm.int_layernorm_fwd_plain(
        torch.from_numpy(xm), _e(x_exp), torch.from_numpy(gamma),
        torch.zeros(D))
    mu, rstd = mu.numpy(), rstd.numpy()
    got, ref = _bwd_both(xm, x_exp, gm, g_exp, gamma, mu, rstd)
    _check_bwd(got, ref, xm, x_exp, gm, g_exp, mu, rstd)
    oracle = [np.asarray(a) for a in jref.int_layernorm_bwd_ref(
        jnp.asarray(xm), jnp.int32(x_exp), jnp.asarray(gm), jnp.int32(g_exp),
        jnp.asarray(gamma), jnp.asarray(mu), jnp.asarray(rstd))]
    _check_bwd(got, oracle, xm, x_exp, gm, g_exp, mu, rstd)


def test_wrappers_check_shapes_and_dtypes():
    xm = torch.zeros((4, 8), dtype=torch.int16)
    g = torch.ones(8)
    with pytest.raises(ValueError):
        int_norm.int_layernorm_fwd(xm, _e(0), torch.ones(7), g)
    with pytest.raises(TypeError):
        int_norm.int_layernorm_fwd(xm.float(), _e(0), g, g)
    r = torch.ones((4, 1))
    with pytest.raises(ValueError):
        int_norm.int_layernorm_bwd(xm, xm[:3], _e(0), _e(0), g, r, r)
    with pytest.raises(TypeError):
        int_norm.int_layernorm_bwd(xm, xm.to(torch.int32), _e(0), _e(0), g,
                                   r, r)
