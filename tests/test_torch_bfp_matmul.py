"""Port parity: limb-plane integer matmul (repro_torch.kernels.bfp_matmul)
vs the JAX Pallas kernel in interpret mode and the exact int64 oracle.

Every int32 limb-pair partial is exact on both sides and the f32 combine
runs in the same order, so at an output exponent inside XLA:CPU's
exact-``exp2`` window the two agree bit for bit.  Outside the window the
reference's scale is off by a few ulps: the port must then stay within 64
ulp (relative 2^-17) of it, and bit-exact against the port's own exact
formula in numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import bfp_matmul as bm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

_BITS = {1: 8, 2: 12, 3: 16}          # bit-width giving 1 / 2 / 3 limbs


def _exact_exp2(n: int) -> bool:
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _mantissas(rng, bits, shape):
    lim = 2 ** (bits - 1) - 1
    return rng.integers(-lim, lim + 1, shape).astype(
        np.int8 if bits <= 8 else np.int16)


def _exact_combine(xm, wm, bx, bw, out_exp):
    """The kernel's arithmetic in numpy: int64 pair products, f32 combine
    with exact powers of two, x-limbs outer / w-limbs inner."""
    xp = ops.split_limbs_stacked(torch.from_numpy(xm), bx).numpy()
    wp = ops.split_limbs_stacked(torch.from_numpy(wm), bw).numpy()
    s0 = np.float32(np.ldexp(1.0, out_exp))
    out = None
    for jx in range(len(xp)):
        for jw in range(len(wp)):
            acc = xp[jx].astype(np.int64) @ wp[jw].astype(np.int64)
            part = (acc.astype(np.float32) * s0) * np.float32(2 ** (7 * (jx + jw)))
            out = part if out is None else out + part
    return out


def _run_both(xm, x_exp, bx, wm, w_exp, bw):
    ref = np.asarray(jops.dfx_matmul_tiled(
        jnp.asarray(xm), jnp.int32(x_exp), bx, jnp.asarray(wm),
        jnp.int32(w_exp), bw, interpret=True))
    got = ops.dfx_matmul_tiled(
        torch.from_numpy(xm), torch.tensor(x_exp, dtype=torch.int32), bx,
        torch.from_numpy(wm), torch.tensor(w_exp, dtype=torch.int32), bw)
    return got.numpy(), ref


@pytest.mark.parametrize("lx", [1, 2, 3])
@pytest.mark.parametrize("lw", [1, 2, 3])
@pytest.mark.parametrize("shape", [(5, 37, 19), (33, 70, 130)])
def test_matmul_matches_pallas(lx, lw, shape):
    M, K, N = shape
    bx, bw = _BITS[lx], _BITS[lw]
    rng = np.random.default_rng(100 * lx + 10 * lw + M)
    xm, wm = _mantissas(rng, bx, (M, K)), _mantissas(rng, bw, (K, N))
    x_exp, w_exp = -5, -4                       # out_exp -9: exact window
    assert _exact_exp2(x_exp + w_exp)
    got, ref = _run_both(xm, x_exp, bx, wm, w_exp, bw)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lx", [1, 2, 3])
@pytest.mark.parametrize("lw", [1, 2, 3])
def test_matmul_outside_window(lx, lw):
    """out_exp -21: within 64 ulp of the reference, exact vs numpy."""
    bx, bw = _BITS[lx], _BITS[lw]
    rng = np.random.default_rng(10 * lx + lw)
    xm, wm = _mantissas(rng, bx, (33, 70)), _mantissas(rng, bw, (70, 130))
    assert not _exact_exp2(-21)
    got, ref = _run_both(xm, -11, bx, wm, -10, bw)
    np.testing.assert_array_equal(got, _exact_combine(xm, wm, bx, bw, -21))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -17,
                               atol=2.0 ** -17 * np.abs(ref).max())


def test_kmajor_weight_layout_matches():
    """The tied head's planes arrive K-contiguous ((Lw, N, K) storage)."""
    rng = np.random.default_rng(7)
    xp = torch.from_numpy(rng.integers(-64, 64, (2, 6, 40)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-64, 64, (1, 52, 40)).astype(np.int8))
    e = torch.tensor(-9, dtype=torch.int32)
    a = bm.bfp_matmul(xp, wt.transpose(1, 2), e)
    b = bm.bfp_matmul(xp, wt.transpose(1, 2).contiguous(), e)
    assert torch.equal(a, b)
