"""Port parity: the MoE kernels' plain versions — the grouped-scale quantize
(``dfx_quantize_grouped``) and the batched NN / NT / TN limb-plane matmuls
(``bfp_matmul_batched{,_nt,_tn}``) — against the JAX Pallas kernels in
interpret mode (through ``kernels/ops.py``) and the ``kernels/ref.py``
oracles.

Integers (mantissas, limb planes, int32 limb-pair partials) must match bit
for bit wherever the scale exponent lies in XLA:CPU's exact-``exp2`` window
(checked at run time).  Outside it the reference's scale is off by ulps:
the port must then equal an exact numpy formula, stay within 64 ulp
(relative 2^-17 of the largest output) of the reference's matmuls, and flip
at most 1% of the reference's mantissas, by one step.  The single-product
oracles round the whole int32 sum once; against them a 1x1-limb product is
exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dfx as jdfx  # noqa: E402
from repro.core import int_ops as jint_ops  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dfx  # noqa: E402
from repro_torch.kernels import bfp_matmul as bm  # noqa: E402
from repro_torch.kernels import dfx_quant, ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BITS = {1: 8, 2: 12, 3: 16}          # bit-width giving 1 / 2 / 3 limbs


def _exact_exp2(n: int) -> bool:
    """True when XLA:CPU's exp2 is exact at the integer ``n``."""
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _stack(rng, E, M, N, zero_slice):
    """(E, M, N) f32 with per-slice magnitudes 2^-1 .. 2^2 (exponents in
    the exact window), slice 1 all zero when asked (an empty expert)."""
    x = rng.standard_normal((E, M, N)).astype(np.float32)
    x *= (2.0 ** np.arange(-1, E - 1, dtype=np.float32))[:, None, None]
    if zero_slice:
        x[1] = 0.0
    return x


@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("limb_planes", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_grouped_quantize_matches_pallas(bits, limb_planes, stochastic):
    rng = np.random.default_rng(bits * 4 + 2 * limb_planes + stochastic)
    E, M, N = 4, 21, 34
    x = _stack(rng, E, M, N, zero_slice=True)
    u = rng.random((E, M, N)).astype(np.float32) if stochastic else None
    exp = np.asarray(jdfx._scale_exponent(jnp.asarray(x), (1, 2))).reshape(E)
    exp = (exp - (bits - 1)).astype(np.int32)
    assert exp[1] == -(bits - 1)                 # the empty slice
    assert all(_exact_exp2(-int(e)) for i, e in enumerate(exp) if i != 1)
    ref = np.asarray(jops.quantize_pallas_batched(
        jnp.asarray(x), jnp.asarray(exp), bits,
        u=None if u is None else jnp.asarray(u), interpret=True,
        limb_planes=limb_planes))
    tu = None if u is None else torch.from_numpy(u)
    got = ops.quantize_batched(torch.from_numpy(x), torch.from_numpy(exp),
                               bits, u=tu, limb_planes=limb_planes)
    assert got.numpy().dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if limb_planes:
        assert got.shape == (dfx_quant.n_limbs(bits), E, M, N)
        assert not got[:, 1].any()
    else:
        orc = np.asarray(jref.dfx_quantize_grouped_ref(
            jnp.asarray(x), jnp.asarray(exp), bits,
            None if u is None else jnp.asarray(u)))
        np.testing.assert_array_equal(got.numpy(), orc)
        # the grouped form is the per-tensor kernel slice by slice
        for e in range(E):
            one = dfx_quant.dfx_quantize(
                torch.from_numpy(x[e]), torch.tensor(int(exp[e])), bits=bits,
                u=None if u is None else tu[e])
            assert torch.equal(got[e], one)


@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("stochastic", [False, True])
def test_stacked_quantize_matches_reference(bits, stochastic):
    """``dfx.quantize_stacked`` is the reference's
    ``_stacked_pallas_quantize``: per-expert (E, 1, 1) exponents, an
    all-zero expert at exponent 0 - (b - 1), and with ``u`` one draw over
    the whole stack (the reference's own draw, fed in)."""
    rng = np.random.default_rng(40 + bits + stochastic)
    x = _stack(rng, 3, 10, 16, zero_slice=True)
    key = jax.random.PRNGKey(bits)
    ref = jint_ops._stacked_pallas_quantize(
        jnp.asarray(x), bits, stochastic=stochastic,
        key=key if stochastic else None, limb_planes=True)
    u = None
    if stochastic:
        u = torch.from_numpy(np.array(
            jax.random.uniform(key, x.shape, dtype=jnp.float32)))
    got = dfx.quantize_stacked(torch.from_numpy(x), bits, u=u,
                               limb_planes=True)
    assert tuple(got.exp.shape) == (3, 1, 1)
    np.testing.assert_array_equal(got.exp.numpy(), np.asarray(ref.exp))
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(ref.m))
    assert int(got.exp[1]) == -(bits - 1)


@pytest.mark.parametrize("bits,exp", [(8, -21), (12, -17)])
def test_grouped_quantize_outside_window(bits, exp):
    """Exponents outside [-12, 12]: the port equals the exact oracle; the
    reference's inexact exp2 flips at most 1% of mantissas by one step."""
    exps = np.array([exp, exp - 2, exp + 2], np.int32)
    assert not any(_exact_exp2(-int(e)) for e in exps)
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 32, 48))
         * 2.0 ** (exps[:, None, None] + bits - 3)).astype(np.float32)
    got = dfx_quant.dfx_quantize_grouped(
        torch.from_numpy(x), torch.from_numpy(exps),
        bits=bits).numpy().astype(np.int64)
    y = x * np.ldexp(np.float32(1.0), -exps)[:, None, None]
    lim = 2 ** (bits - 1) - 1
    np.testing.assert_array_equal(got, np.clip(np.round(y), -lim, lim))
    ref = np.asarray(jops.quantize_pallas_batched(
        jnp.asarray(x), jnp.asarray(exps), bits,
        interpret=True)).astype(np.int64)
    assert np.abs(got - ref).max() <= 1
    assert np.mean(got != ref) <= 0.01


def _mantissas(rng, bits, shape):
    lim = 2 ** (bits - 1) - 1
    return rng.integers(-lim, lim + 1, shape).astype(
        np.int8 if bits <= 8 else np.int16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


#: name -> (port wrapper, reference wrapper, operand shapes from (E, M, K,
#: N), the int64 product of expert e)
LAYOUTS = {
    "nn": (ops.dfx_matmul_tiled_batched, jops.dfx_matmul_tiled_batched,
           lambda E, M, K, N: ((E, M, K), (E, K, N)),
           lambda a, b: np.einsum("emk,ekn->emn", a, b)),
    "nt": (ops.dfx_matmul_tiled_batched_nt,
           jops.dfx_matmul_tiled_batched_nt,
           lambda E, M, K, N: ((E, M, N), (E, K, N)),
           lambda a, b: np.einsum("emn,ekn->emk", a, b)),
    "tn": (ops.dfx_matmul_tiled_batched_tn,
           jops.dfx_matmul_tiled_batched_tn,
           lambda E, M, K, N: ((E, M, K), (E, M, N)),
           lambda a, b: np.einsum("emk,emn->ekn", a, b)),
}
#: (E, (M, K, N), (la, lb)): the int8 preset's forward (a12 x w8) and
#: backward (g8) limb mixes, a 3x3 int16 case, ragged shapes, E = 1 and 4
CASES = [(1, (24, 40, 16), (2, 1)), (4, (37, 50, 29), (1, 1)),
         (4, (9, 70, 33), (2, 1)), (4, (16, 24, 40), (3, 3))]


def _exact_combine(a, b, ba, bb, exps, product):
    """The kernel's arithmetic in numpy: int64 pair products, f32 combine
    with exact powers of two, a-limbs outer / b-limbs inner."""
    ap = ops.split_limbs_stacked(_t(a), ba).numpy()
    bp = ops.split_limbs_stacked(_t(b), bb).numpy()
    s0 = np.ldexp(np.float32(1.0), exps).astype(np.float32)[:, None, None]
    out = None
    for ja in range(len(ap)):
        for jb in range(len(bp)):
            acc = product(ap[ja].astype(np.int64), bp[jb].astype(np.int64))
            part = (acc.astype(np.float32) * s0) * np.float32(
                2 ** (7 * (ja + jb)))
            out = part if out is None else out + part
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("E,shape,limbs", CASES)
def test_batched_matmul_matches_pallas(layout, E, shape, limbs):
    port, jax_fn, shapes, product = LAYOUTS[layout]
    (la, lb), (M, K, N) = limbs, shape
    ba, bb = _BITS[la], _BITS[lb]
    rng = np.random.default_rng(M * 7 + E + la * 3 + lb)
    sa, sb = shapes(E, M, K, N)
    a, b = _mantissas(rng, ba, sa), _mantissas(rng, bb, sb)
    ea = (np.arange(E) - 5).astype(np.int32).reshape(E, 1, 1)
    eb = np.full((E, 1, 1), -3, np.int32)
    assert all(_exact_exp2(int(e)) for e in (ea + eb).ravel())
    ref = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(ea), ba,
                            jnp.asarray(b), jnp.asarray(eb), bb,
                            interpret=True))
    # logical mantissas and (E, 1, 1) exponents, split into planes inside
    got = port(_t(a), _t(ea), ba, _t(b), _t(eb), bb).numpy()
    np.testing.assert_array_equal(got, ref)
    # planes in, as the grouped quantize writes them
    ap, bp = ops.split_limbs_stacked(_t(a), ba), ops.split_limbs_stacked(
        _t(b), bb)
    kernel = {"nn": bm.bfp_matmul_batched, "nt": bm.bfp_matmul_batched_nt,
              "tn": bm.bfp_matmul_batched_tn}[layout]
    exps = torch.from_numpy((ea + eb).reshape(E))
    np.testing.assert_array_equal(kernel(ap, bp, exps).numpy(), ref)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_batched_matmul_outside_window(layout):
    """Per-expert output exponents near -20 (a MoE gradient's): exact vs
    the numpy formula, within 64 ulp of the reference."""
    port, jax_fn, shapes, product = LAYOUTS[layout]
    E, (M, K, N), ba, bb = 3, (20, 36, 28), 12, 8
    rng = np.random.default_rng(len(layout))
    sa, sb = shapes(E, M, K, N)
    a, b = _mantissas(rng, ba, sa), _mantissas(rng, bb, sb)
    ea = np.array([-11, -12, -9], np.int32)
    eb = np.full(E, -10, np.int32)
    assert not any(_exact_exp2(int(e)) for e in ea + eb)
    got = port(_t(a), _t(ea), ba, _t(b), _t(eb), bb).numpy()
    np.testing.assert_array_equal(
        got, _exact_combine(a, b, ba, bb, ea + eb, product))
    ref = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(ea), ba,
                            jnp.asarray(b), jnp.asarray(eb), bb,
                            interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -17,
                               atol=2.0 ** -17 * np.abs(ref).max())


def test_batched_matmul_against_ref_oracles():
    """The ``kernels/ref.py`` batched oracles over logical int8 mantissas
    (one limb pair: the oracle's single rounding is the combine's)."""
    rng = np.random.default_rng(5)
    E, M, K, N = 4, 13, 30, 22
    exps = (np.arange(E) - 9).astype(np.int32)
    x, w = _mantissas(rng, 8, (E, M, K)), _mantissas(rng, 8, (E, K, N))
    g, wn = _mantissas(rng, 8, (E, M, N)), _mantissas(rng, 8, (E, K, N))
    e0 = np.zeros(E, np.int32)
    for got, orc in (
            (ops.dfx_matmul_tiled_batched(_t(x), _t(exps), 8, _t(w), _t(e0),
                                          8),
             jref.bfp_matmul_batched_ref(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(exps))),
            (ops.dfx_matmul_tiled_batched_nt(_t(g), _t(exps), 8, _t(wn),
                                             _t(e0), 8),
             jref.bfp_matmul_batched_nt_ref(jnp.asarray(g), jnp.asarray(wn),
                                            jnp.asarray(exps))),
            (ops.dfx_matmul_tiled_batched_tn(_t(x), _t(exps), 8, _t(g),
                                             _t(e0), 8),
             jref.bfp_matmul_batched_tn_ref(jnp.asarray(x), jnp.asarray(g),
                                            jnp.asarray(exps)))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(orc))


def test_batched_wrappers_check_their_arguments():
    rng = np.random.default_rng(3)
    a = ops.split_limbs_stacked(_t(_mantissas(rng, 12, (2, 5, 7))), 12)
    b = ops.split_limbs_stacked(_t(_mantissas(rng, 8, (2, 7, 3))), 8)
    e = torch.zeros(2, dtype=torch.int32)
    assert bm.bfp_matmul_batched(a, b, e).shape == (2, 5, 3)
    with pytest.raises(ValueError):                 # contraction mismatch
        bm.bfp_matmul_batched_nt(a, b, e)
    with pytest.raises(ValueError):                 # expert count mismatch
        bm.bfp_matmul_batched(a, b[:, :1], e)
    with pytest.raises(ValueError):                 # one exponent per expert
        bm.bfp_matmul_batched(a, b, e[:1])
    with pytest.raises(TypeError):
        bm.bfp_matmul_batched(a.to(torch.int16), b, e)
    with pytest.raises(ValueError):                 # int32 sums overflow
        long = torch.zeros((1, 1, bm.MAX_CONTRACTION + 1, 1),
                           dtype=torch.int8)
        bm.bfp_matmul_batched_tn(long, long, torch.zeros(1))
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError):
        dfx_quant.dfx_quantize_grouped(x, torch.zeros(3, dtype=torch.int32),
                                       bits=8)
    with pytest.raises(ValueError):
        dfx_quant.dfx_quantize_grouped(x[0], torch.zeros(3), bits=8)
