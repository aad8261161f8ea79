"""Port parity: the backward limb-plane matmuls, NT (dX = G·Wᵀ) and TN
(dW = Xᵀ·G), in repro_torch.kernels.bfp_matmul, vs the JAX Pallas kernels
in interpret mode (through ``kernels/ops.py``) and the ``kernels/ref.py``
oracles.

Every int32 limb-pair partial is exact on both sides and the f32 combine
runs in the same order, so at an output exponent inside XLA:CPU's
exact-``exp2`` window the port and the Pallas kernel agree bit for bit, at
ragged shapes too (the classifier head's N = 4 and 2, the pooler's M = B).
Outside the window the reference's scale is off by a few ulps: the port
must then stay within 64 ulp (relative 2^-17) of it, and bit-exact against
its own exact formula in numpy.  The single-product oracles round the
whole int32 sum once; against them the limb combine is held within 4 ulp
of the largest output (exact at 1x1 limbs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import bfp_matmul as bm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BITS = {1: 8, 2: 12, 3: 16}          # bit-width giving 1 / 2 / 3 limbs
ULP = 2.0 ** -23


def _exact_exp2(n: int) -> bool:
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _mantissas(rng, bits, shape):
    lim = 2 ** (bits - 1) - 1
    return rng.integers(-lim, lim + 1, shape).astype(
        np.int8 if bits <= 8 else np.int16)


def _t(a):
    return torch.from_numpy(a)


def _e(n):
    return torch.tensor(n, dtype=torch.int32)


def _exact_combine(a, b, ba, bb, out_exp, product):
    """The kernel's arithmetic in numpy: int64 pair products, f32 combine
    with exact powers of two, a-limbs outer / b-limbs inner."""
    ap = ops.split_limbs_stacked(_t(a), ba).numpy()
    bp = ops.split_limbs_stacked(_t(b), bb).numpy()
    s0 = np.float32(np.ldexp(1.0, out_exp))
    out = None
    for ja in range(len(ap)):
        for jb in range(len(bp)):
            acc = product(ap[ja].astype(np.int64), bp[jb].astype(np.int64))
            part = (acc.astype(np.float32) * s0) * np.float32(
                2 ** (7 * (ja + jb)))
            out = part if out is None else out + part
    return out


def _nt_both(gm, g_exp, bg, wm, w_exp, bw):
    ref = np.asarray(jops.dfx_matmul_tiled_nt(
        jnp.asarray(gm), jnp.int32(g_exp), bg, jnp.asarray(wm),
        jnp.int32(w_exp), bw, interpret=True))
    got = ops.dfx_matmul_tiled_nt(_t(gm), _e(g_exp), bg, _t(wm), _e(w_exp),
                                  bw)
    return got.numpy(), ref


def _tn_both(xm, x_exp, bx, gm, g_exp, bg):
    ref = np.asarray(jops.dfx_matmul_tiled_tn(
        jnp.asarray(xm), jnp.int32(x_exp), bx, jnp.asarray(gm),
        jnp.int32(g_exp), bg, interpret=True))
    got = ops.dfx_matmul_tiled_tn(_t(xm), _e(x_exp), bx, _t(gm), _e(g_exp),
                                  bg)
    return got.numpy(), ref


# (la, lb): the int8 training preset's (1, 1) NT and (2, 1) TN, plus the
# wider mixes of the int12 / int16 presets
LIMBS = [(1, 1), (2, 1), (1, 2), (3, 3)]
# (M, K, N): the head (N = 4 and 2), the pooler (M = batch), a ragged block
SHAPES = [(6, 40, 4), (9, 24, 2), (3, 48, 48), (70, 33, 130)]


@pytest.mark.parametrize("lg,lw", LIMBS)
@pytest.mark.parametrize("shape", SHAPES)
def test_nt_matches_pallas(lg, lw, shape):
    M, K, N = shape
    bg, bw = _BITS[lg], _BITS[lw]
    rng = np.random.default_rng(100 * lg + 10 * lw + M + N)
    gm, wm = _mantissas(rng, bg, (M, N)), _mantissas(rng, bw, (K, N))
    assert _exact_exp2(-5 - 4)
    got, ref = _nt_both(gm, -5, bg, wm, -4, bw)
    assert got.shape == (M, K)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lx,lg", LIMBS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tn_matches_pallas(lx, lg, shape):
    M, K, N = shape
    bx, bg = _BITS[lx], _BITS[lg]
    rng = np.random.default_rng(7 + 100 * lx + 10 * lg + M + N)
    xm, gm = _mantissas(rng, bx, (M, K)), _mantissas(rng, bg, (M, N))
    assert _exact_exp2(-6 - 3)
    got, ref = _tn_both(xm, -6, bx, gm, -3, bg)
    assert got.shape == (K, N)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("la,lb", [(1, 1), (2, 1)])
def test_outside_window(la, lb):
    """out_exp -21 (a gradient's exponent sits near -20): within 64 ulp of
    the reference, exact vs the numpy formula."""
    ba, bb = _BITS[la], _BITS[lb]
    rng = np.random.default_rng(10 * la + lb)
    assert not _exact_exp2(-21)
    gm, wm = _mantissas(rng, ba, (33, 70)), _mantissas(rng, bb, (50, 70))
    got, ref = _nt_both(gm, -11, ba, wm, -10, bb)
    np.testing.assert_array_equal(
        got, _exact_combine(gm, wm, ba, bb, -21, lambda g, w: g @ w.T))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -17,
                               atol=2.0 ** -17 * np.abs(ref).max())
    xm, gm = _mantissas(rng, ba, (70, 33)), _mantissas(rng, bb, (70, 50))
    got, ref = _tn_both(xm, -11, ba, gm, -10, bb)
    np.testing.assert_array_equal(
        got, _exact_combine(xm, gm, ba, bb, -21, lambda x, g: x.T @ g))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -17,
                               atol=2.0 ** -17 * np.abs(ref).max())


@pytest.mark.parametrize("bits", [8, 16])
def test_against_ref_oracles(bits):
    """The ``kernels/ref.py`` single-product oracles over logical int8 /
    int16 mantissas (against 8-bit weights and gradients, so the oracles'
    own int32 sums cannot overflow): exact at int8 x int8, 4 ulp of
    max|out| at int16."""
    rng = np.random.default_rng(bits)
    gm, wm = _mantissas(rng, bits, (17, 29)), _mantissas(rng, 8, (11, 29))
    xm, g8 = _mantissas(rng, bits, (17, 13)), _mantissas(rng, 8, (17, 29))
    e = jnp.int32(-9)
    nt_ref = np.asarray(jref.bfp_matmul_nt_ref(jnp.asarray(gm),
                                               jnp.asarray(wm), e))
    tn_ref = np.asarray(jref.bfp_matmul_tn_ref(jnp.asarray(xm),
                                               jnp.asarray(g8), e))
    nt = ops.dfx_matmul_tiled_nt(_t(gm), _e(-5), bits, _t(wm), _e(-4),
                                 8).numpy()
    tn = ops.dfx_matmul_tiled_tn(_t(xm), _e(-5), bits, _t(g8), _e(-4),
                                 8).numpy()
    for got, ref in ((nt, nt_ref), (tn, tn_ref)):
        if bits == 8:
            np.testing.assert_array_equal(got, ref)
        else:
            assert np.abs(got - ref).max() <= 4 * ULP * np.abs(ref).max()


def test_wrappers_take_planes_or_mantissas_and_check_shapes():
    rng = np.random.default_rng(3)
    gm, wm = _mantissas(rng, 12, (5, 7)), _mantissas(rng, 8, (9, 7))
    gp = ops.split_limbs_stacked(_t(gm), 12)
    wp = ops.split_limbs_stacked(_t(wm), 8)
    e = _e(-9)
    assert torch.equal(bm.bfp_matmul_nt(gp, wp, e),
                       ops.dfx_matmul_tiled_nt(_t(gm), _e(-5), 12, _t(wm),
                                               _e(-4), 8))
    with pytest.raises(ValueError):
        bm.bfp_matmul_nt(gp, wp.transpose(1, 2), e)
    with pytest.raises(ValueError):
        bm.bfp_matmul_tn(gp, wp, e)
    with pytest.raises(TypeError):
        bm.bfp_matmul_tn(gp.to(torch.int16), gp, e)
