"""Port parity of the state plane's container, ``core/qtensor.py``, and of
``dfx.health_stats``, against ``repro.core.qtensor`` / ``repro.core.dfx``
on the same numpy-seeded inputs.

QTensor ops per tensor and with one exponent per leading slice
(``group_axis=0``), at 8 bits (one plane) and 16 (three), round to nearest
and stochastic with the reference's ``jax.random.uniform`` noise fed in:
the planes, exponents, logical mantissas and dequantized values bit for
bit.  The inputs keep every step exponent inside [-12, 12], where
XLA:CPU's ``exp2`` is exact (checked at run time), as the repo's parity
tests do.  The port's own noise (a ``torch.Generator``) is held by
statistics: the stochastic-rounding EMA is mean-preserving.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dfx as jdfx  # noqa: E402
from repro.core import qtensor as jq  # noqa: E402
from repro_torch.core import dfx, qtensor  # noqa: E402


def _exact_window(exps) -> None:
    """The reference's scales at these exponents are exact powers of 2."""
    for e in np.unique(np.asarray(exps)):
        got = float(jnp.exp2(jnp.float32(e)))
        assert got == np.ldexp(1.0, int(e)), f"exp2({e}) inexact: {got}"


def _inputs(shape, seed=0):
    """Per-slice magnitudes 2^3 .. 2^10 (a 16-bit step exponent in
    [-12, -5], an 8-bit one in [-4, 3]; no element below half its slice's
    scale, so a slice of one element is in the window too); slice 1 (of
    more than one) all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x = np.where(np.abs(x) < 0.5, np.copysign(0.5, x), x)
    scale = 2.0 ** rng.integers(3, 10, size=(shape[0],) + (1,) *
                                (len(shape) - 1))
    x = (x * scale).astype(np.float32)
    if shape[0] > 1:
        x[1] = 0
    return x


def _jq(x, bits, group_axis, u):
    """The reference's QTensor of ``x``, stochastic with noise ``u``."""
    if u is None:
        return jq.quantize(jnp.asarray(x), bits, group_axis=group_axis)
    key = jax.random.PRNGKey(7)
    t = jq.quantize(jnp.asarray(x), bits, group_axis=group_axis,
                    stochastic=True, key=key)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(key, x.shape, jnp.float32)), u)
    return t


def _fed(u):
    """A port key that hands in the noise ``u``."""
    return lambda shape, device: torch.from_numpy(np.array(u).reshape(shape))


def _same(t, r):
    assert t.bits == r.bits and t.shape == tuple(r.m.shape[1:])
    assert t.m.dtype == torch.int8 and t.exp.dtype == torch.int32
    np.testing.assert_array_equal(t.m.numpy(), np.asarray(r.m))
    np.testing.assert_array_equal(t.exp.numpy(), np.asarray(r.exp))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("group_axis", [None, 0])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("shape", [(6, 5, 33), (7, 40), (9,)])
def test_quantize_matches_reference(bits, group_axis, stochastic, shape):
    x = _inputs(shape, seed=bits + len(shape))
    u = (np.asarray(jax.random.uniform(jax.random.PRNGKey(7), shape,
                                       jnp.float32))
         if stochastic else None)
    r = _jq(x, bits, group_axis, u)
    _exact_window(np.asarray(r.exp)[np.any(x != 0, axis=tuple(
        range(1, x.ndim))) if group_axis == 0 else ()])
    t = qtensor.quantize(torch.from_numpy(x), bits, group_axis=group_axis,
                         stochastic=stochastic,
                         key=_fed(u) if stochastic else None)
    _same(t, r)
    assert t.group_axis == r.group_axis
    assert t.n_limbs == r.n_limbs and t.nbytes == r.nbytes
    np.testing.assert_array_equal(qtensor.int_mantissa(t).numpy(),
                                  np.asarray(jq.int_mantissa(r)))
    np.testing.assert_array_equal(qtensor.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(r)))
    np.testing.assert_array_equal(
        qtensor.step_exponent(torch.from_numpy(x), bits, group_axis).numpy(),
        np.asarray(jq.step_exponent(jnp.asarray(x), bits, group_axis)))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("group_axis", [None, 0])
def test_zeros_match_reference_and_quantize_of_zeros(bits, group_axis):
    shape = (4, 3, 5)
    z = qtensor.zeros(shape, bits, group_axis)
    _same(z, jq.zeros(shape, bits, group_axis))
    _same(qtensor.quantize(torch.zeros(shape), bits, group_axis=group_axis),
          jq.zeros(shape, bits, group_axis))
    assert float(qtensor.dequantize(z).abs().max()) == 0.0


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shape", [(5, 2, 24), (1, 24)])
def test_ema_update_matches_reference(bits, shape):
    """One stochastic-rounding EMA at the reference's noise; the stored
    exponent keeps its shape, the degenerate (1, 1) keep-dims too."""
    x, prev = _inputs(shape, 3), _inputs(shape, 4)
    r0 = jq.quantize(jnp.asarray(prev), bits, group_axis=0)
    t0 = qtensor.quantize(torch.from_numpy(prev), bits, group_axis=0)
    _same(t0, r0)
    key = jax.random.PRNGKey(11)
    r = jq.ema_update(r0, jnp.asarray(x), 0.9, key)
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    t = qtensor.ema_update(t0, torch.from_numpy(x), 0.9, _fed(u))
    _exact_window(np.asarray(r.exp)[np.asarray(r.exp) > -(bits - 1)])
    _same(t, r)
    assert t.exp.shape == t0.exp.shape


def test_fake_quant_ste_forward_and_identity_gradient():
    x = _inputs((16, 12), 5)
    r = jq.fake_quant_ste(jnp.asarray(x), 8)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = qtensor.fake_quant_ste(xt, 8)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        y.detach().numpy(),
        qtensor.dequantize(qtensor.quantize(xt.detach(), 8)).numpy())
    ct = torch.from_numpy(_inputs((16, 12), 6))
    (g,) = torch.autograd.grad(y, xt, ct)
    assert torch.equal(g, ct)


@pytest.mark.parametrize("bits", [8, 16])
def test_round_trip_within_one_step_and_idempotent(bits):
    x = torch.from_numpy(_inputs((64, 32), bits))
    for group_axis in (None, 0):
        t = qtensor.quantize(x, bits, group_axis=group_axis)
        y = qtensor.dequantize(t)
        step = dfx.pow2(t.exp)
        assert bool(((y - x).abs() <= 0.5 * step).all())
        t2 = qtensor.quantize(y, bits, group_axis=group_axis)
        assert torch.equal(t2.m, t.m) and torch.equal(t2.exp, t.exp)


def test_wire_bytes_and_group_axes():
    assert qtensor.wire_bytes(1000, 8) == jq.wire_bytes(1000, 8) == 1004
    assert qtensor.wire_bytes(1000, 16, 10) == jq.wire_bytes(1000, 16, 10)
    t = qtensor.quantize(torch.ones(6, 4), 8, group_axis=0)
    assert t.nbytes == qtensor.wire_bytes(24, 8, 6)
    assert qtensor.is_qtensor(t) and not qtensor.is_qtensor(t.m)
    with pytest.raises(NotImplementedError):
        qtensor.quantize(torch.ones(6, 4), 8, group_axis=1)
    with pytest.raises(ValueError):
        qtensor.quantize(torch.ones(6, 4), 8, stochastic=True)


def test_sr_ema_is_mean_preserving_with_the_ports_generator():
    """E[Q_sr(y)] = y: over 512 draws of the port's own generator the
    quantized EMA's mean sits within 6 sigma of the FP32 EMA."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    t = qtensor.quantize(torch.from_numpy(
        rng.standard_normal(256).astype(np.float32)), 8)
    exact = 0.9 * qtensor.dequantize(t) + 0.1 * x
    gen = torch.Generator().manual_seed(0)
    n = 512
    mean = sum(qtensor.dequantize(qtensor.ema_update(t, x, 0.9, gen))
               for _ in range(n)) / n
    step = float(dfx.pow2(t.exp))
    assert float((mean - exact).abs().max()) <= 6.0 * step / np.sqrt(n)


def test_health_stats_match_reference():
    rng = np.random.default_rng(1)
    cases = [np.array([1.0, -1.0, 0.5, 127.0], np.float32),
             np.array([np.nan, np.inf, 1.0, -np.inf, 3.0], np.float32),
             np.full((8,), 127.0, np.float32),
             np.zeros((3, 4), np.float32),
             (rng.standard_normal((32, 48)) * 5).astype(np.float32)]
    for x in cases:
        for bits in (8, 12):
            got = dfx.health_stats(torch.from_numpy(x), bits)
            ref = jdfx.health_stats(jnp.asarray(x), bits)
            assert sorted(got) == sorted(ref)
            for k in got:
                assert got[k].dim() == 0 and got[k].dtype == torch.float32
                np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                           rtol=1e-6, err_msg=k)
    s = dfx.health_stats(torch.tensor([np.nan, np.inf, 1.0]), 8)
    assert float(s["nonfinite"]) == 2.0 and float(s["exp"]) == -6.0
