"""Port parity of the integer kept ops: ``repro_torch.core.iapprox`` against
``repro.core.iapprox`` and the ``repro/kernels/ref.py`` f64 oracles.

Stated tolerances.  XLA:CPU's ``exp2`` is exact only for integer arguments
in about [-12, 12], and ``i_exp`` scales by 2^(q-14) with q - 14 in
[-58, 29], ``i_recip`` by 2^-(15+e): so the reference's f32 results are a
few ulps off for most inputs, and the port (exact powers of two) does not
copy that.  Hence:

* the integer intermediates (``ti``, ``q``, the Horner sum ``acc``, the
  normalised ``d``, the Newton iterate ``x``) equal the reference's
  expressions on XLA bit for bit;
* the port's f32 results equal ``np.ldexp`` of its integers exactly;
* every op equals the reference bit for bit with ``jnp.exp2`` made exact
  for integer arguments (patched around the call); i_softmax within 4 ulp
  of its row's max plus 2e-4 of the value (its row sum runs in another
  order, which can move i_recip's rounded d by one Q.14 step);
* against the reference as it runs here: i_exp within 64 ulp (caveat
  A's window) and exactly where its scale lies in the window; the ops
  whose integer rounding takes an inexact XLA scale (i_recip's normalised
  d, ...) within one Q.14 step, 2^-12 (1 + |result|);
* against the f64 oracles within the reference's own bounds (DESIGN.md
  §10); a hypothesis sweep with f32-representable bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import iapprox as jia  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.core import iapprox as tia  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F = 14
ULP = 2.0 ** -23
#: DESIGN.md §10's bound table (the reference's tests/test_iapprox.py)
BOUNDS = {"i_exp": 3e-4, "i_recip": 4e-4, "i_rsqrt": 4e-4, "i_sqrt": 4e-4,
          "i_sigmoid": 1e-3, "i_tanh": 1e-3, "i_gelu": 2e-3, "i_silu": 4e-3,
          "i_softmax": 1e-3}
OPS = ("i_exp", "i_recip", "i_rsqrt", "i_sqrt", "i_sigmoid", "i_tanh",
       "i_gelu", "i_silu", "d_tanh", "d_sigmoid", "d_gelu", "d_silu")


def exact_exp2(orig):
    """``jnp.exp2`` exact at integer f32 arguments (exponent bits written),
    the original elsewhere."""
    def exp2(x):
        x = jnp.asarray(x)
        if x.dtype != jnp.float32:
            return orig(x)
        n = x.astype(jnp.int32)
        bits = jnp.left_shift(jnp.clip(n, -126, 127) + 127, 23)
        return jnp.where(n.astype(jnp.float32) == x,
                         jax.lax.bitcast_convert_type(bits, jnp.float32),
                         orig(x))
    return exp2


@pytest.fixture
def exact_jax():
    """Patch ``jnp.exp2`` exact for the test (jit caches cleared around
    it, so no traced kernel keeps the other form)."""
    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    mp.setattr(jnp, "exp2", exact_exp2(jnp.exp2))
    assert float(jnp.exp2(jnp.float32(-40))) == 2.0 ** -40
    yield
    mp.undo()
    jax.clear_caches()


def _inputs(op, n=4001, seed=0):
    """Inputs across the op's domain, f32: exp-like ops over ±32 (past the
    clamp), recip / rsqrt / sqrt over positive values across binades."""
    rng = np.random.default_rng([seed, len(op)])
    if op in ("i_recip", "i_rsqrt", "i_sqrt"):
        mags = np.exp(rng.uniform(np.log(1e-8), np.log(1e8), n))
        return np.concatenate([mags, [1.0, 2.0, 0.5, 3.0, 1e-20]]).astype(
            np.float32)
    x = rng.uniform(-32.0, 32.0, n)
    return np.concatenate([x, [0.0, -30.0, 30.0, -31.0, 1e-3]]).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# =========================================================================
# integer intermediates, and the f32 results from them
# =========================================================================

def test_exp_integers_match_reference():
    """``ti``, ``q`` and ``acc`` of i_exp: the reference's expressions
    (``repro/core/iapprox.py`` i_exp, _exp2_frac) on XLA, bit for bit; the
    port's f32 result equals ``ldexp(acc, q - 14)`` exactly."""
    x = _inputs("i_exp")
    xc = jnp.clip(jnp.asarray(x), -30.0, 30.0)
    ti_r = jnp.round(xc * jnp.float32(jia._LOG2E) * (1 << F)).astype(
        jnp.int32)
    q_r = ti_r >> F
    acc_r = jia._exp2_frac(ti_r - (q_r << F))
    ti, q, acc = tia.exp_parts(_t(x))
    for got, want in ((ti, ti_r), (q, q_r), (acc, acc_r)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = tia.i_exp(_t(x)).numpy()
    want = np.ldexp(acc.numpy().astype(np.float64),
                    q.numpy() - F).astype(np.float32)
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("op", ["i_recip", "i_rsqrt"])
def test_newton_integers_match_reference(op):
    """``e``, the normalised ``d`` and the Newton iterate ``x`` of i_recip /
    i_rsqrt against the reference's expressions on XLA (with its scales
    exact: a power of two times y is exact there anyway inside the
    window, and the tested inputs keep -(e+1) in it); the f32 results equal
    ``ldexp`` of the port's integers exactly."""
    rng = np.random.default_rng(1)
    y = np.exp(rng.uniform(np.log(2.0 ** -11), np.log(2.0 ** 11),
                           3001)).astype(np.float32)
    yj = jnp.asarray(y)
    e_r = jia._floor_log2(yj)
    if op == "i_recip":
        d_r = jnp.round(yj * jnp.exp2((-(e_r + 1)).astype(jnp.float32))
                        * (1 << F)).astype(jnp.int32)
        x_r = jia._RECIP_A - ((jia._RECIP_B * d_r) >> F)
        for _ in range(3):
            x_r = (x_r * ((2 << F) - ((d_r * x_r) >> F))) >> F
        e, d, x = tia.recip_parts(_t(y))
        want = np.ldexp(x.numpy().astype(np.float64), -(F + e.numpy() + 1))
        got = tia.i_recip(_t(y)).numpy()
    else:
        d_r = jnp.round(yj * jnp.exp2((-e_r).astype(jnp.float32))
                        * (1 << F)).astype(jnp.int32)
        x_r = jia._RSQRT_A - ((jia._RSQRT_B * d_r) >> F)
        for _ in range(3):
            t = (((d_r * x_r) >> F) * x_r) >> F
            x_r = (x_r * ((3 << F) - t)) >> (F + 1)
        e, d, x = tia.rsqrt_parts(_t(y))
        en = e.numpy()
        k = en >> 1
        want = np.ldexp(x.numpy().astype(np.float64), -(F + k)).astype(
            np.float32)
        want = np.where(en - 2 * k == 1,
                        want * np.float32(0.7071067811865476), want)
        got = tia.i_rsqrt(_t(y)).numpy()
    for a, b in ((e, e_r), (d, d_r), (x, x_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


# =========================================================================
# whole ops against the reference
# =========================================================================

@pytest.mark.parametrize("op", OPS)
def test_ops_match_reference_with_exact_exp2(op, exact_jax):
    """Every op and derivative bit for bit against the reference once its
    powers of two are exact."""
    x = _inputs(op)
    want = np.asarray(getattr(jia, op)(jnp.asarray(x)))
    got = getattr(tia, op)(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", OPS)
def test_ops_within_caveat_a_window_of_reference(op):
    """Against the reference as it runs here (XLA:CPU's inexact exp2).
    i_exp: within 64 ulp of |result|, and bit for bit where its scale
    2^(q-14) is exact on XLA.  The others feed an inexact scale into an
    integer rounding (i_recip's and i_rsqrt's normalised d, the sigmoid's
    1 + z), which moves a Q.14 step: within 2^-12 (1 + |result|), d_gelu
    on its documented |x| <= 10."""
    x = _inputs(op)
    if op == "d_gelu":
        x = x[np.abs(x) <= 10]
    want = np.asarray(getattr(jia, op)(jnp.asarray(x)), np.float64)
    got = getattr(tia, op)(_t(x)).numpy().astype(np.float64)
    if op != "i_exp":
        assert np.all(np.abs(got - want) <= 2.0 ** -12 * (1 + np.abs(want)))
        return
    assert np.all(np.abs(got - want) <= 64 * ULP * np.abs(want))
    _, q, _ = tia.exp_parts(_t(x))
    exact = np.array([float(jnp.exp2(jnp.float32(v))) == np.ldexp(1, v)
                      for v in range(-60, 31)])
    inside = exact[q.numpy() - F + 60]
    assert inside.sum() > 100
    np.testing.assert_array_equal(got[inside], want[inside])


def test_softmax_matches_reference(exact_jax):
    """i_softmax over rows of widths 2..64: within 4 ulp of the row's max
    against the reference with exact scales (the row sums run in another
    order, which can move i_recip's rounded d by one step in rare rows),
    and rows summing to 1 within 1e-3."""
    rng = np.random.default_rng(3)
    for width in (2, 7, 64):
        x = (4 * rng.standard_normal((50, width))).astype(np.float32)
        want = np.asarray(jia.i_softmax(jnp.asarray(x)))
        got = tia.i_softmax(_t(x)).numpy()
        assert np.all(np.abs(got - want) <= 4 * ULP
                      * np.abs(want).max(-1, keepdims=True) + 2e-4 * want)
        assert np.max(np.abs(got.sum(-1) - 1.0)) <= BOUNDS["i_softmax"]


# =========================================================================
# against the f64 oracles (DESIGN.md §10's bounds)
# =========================================================================

def _rel(a, e):
    a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
    return np.max(np.abs(a - e) / np.maximum(np.abs(e), 1e-300))


def _abs(a, e):
    return np.max(np.abs(np.asarray(a, np.float64)
                         - np.asarray(e, np.float64)))


@pytest.mark.parametrize("op,lo,hi,kind", [
    ("i_exp", -32.0, 32.0, "rel"),
    ("i_recip", 0.5, 2.0, "rel"),
    ("i_rsqrt", 1.0, 4.0, "rel"),
    ("i_sqrt", 1e-3, 1e4, "rel"),
    ("i_sigmoid", -40.0, 40.0, "abs"),
    ("i_tanh", -40.0, 40.0, "abs"),
    ("i_gelu", -10.0, 10.0, "abs"),
    ("i_silu", -30.0, 30.0, "abs"),
])
def test_bounds_against_oracles(op, lo, hi, kind):
    x = np.linspace(lo, hi, 50_001).astype(np.float32)
    if op in ("i_recip", "i_rsqrt"):                # and across binades
        x = np.concatenate([x * np.float32(2.0 ** s) for s in (-20, 0, 20)])
    got = getattr(tia, op)(_t(x)).numpy()
    want = np.asarray(getattr(ref, op + "_ref")(jnp.asarray(x)))
    err = _rel(got, want) if kind == "rel" else _abs(got, want)
    assert err <= BOUNDS[op], (op, err)


def test_sqrt_zero_guard_and_exp_clamp():
    assert float(tia.i_sqrt(torch.tensor([0.0]))[0]) == 0.0
    assert float(tia.i_sqrt(torch.tensor([-3.0]))[0]) == 0.0
    out = tia.i_exp(torch.tensor([-1e30, 1e30, -50.0])).numpy()
    np.testing.assert_allclose(out[:2], [np.exp(-30.0), np.exp(30.0)],
                               rtol=3e-4)
    assert out[2] == out[0]


@pytest.mark.parametrize("op,f64", [
    ("d_tanh", lambda x: 1.0 - np.tanh(x) ** 2),
    ("d_sigmoid", lambda x: np.exp(-x) / (1 + np.exp(-x)) ** 2),
    ("d_silu", lambda x: (1 / (1 + np.exp(-x)))
     * (1 + x * (1 - 1 / (1 + np.exp(-x))))),
    ("d_gelu", lambda x: 0.5 * (1 + np.tanh(0.7978845608028654 * (
        x + 0.044715 * x ** 3))) + 0.5 * x * (1 - np.tanh(
            0.7978845608028654 * (x + 0.044715 * x ** 3)) ** 2)
     * 0.7978845608028654 * (1 + 3 * 0.044715 * x ** 2)),
])
def test_derivatives_against_analytic(op, f64):
    """The reference's bound for its derivative forms: 5e-3 absolute."""
    x = np.linspace(-8.0, 8.0, 20_001).astype(np.float32)
    got = getattr(tia, op)(_t(x)).numpy()
    assert _abs(got, f64(x.astype(np.float64))) <= 5e-3


def test_hypothesis_sweeps():
    """Hypothesis point sweeps of i_exp, i_recip / i_rsqrt and the
    activations against the oracles.  The bounds handed to
    ``st.floats(width=32)`` must be f32-representable
    (``float(np.float32(1e-9))``), or hypothesis refuses them before
    drawing any input."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    def pts(lo, hi):
        return st.lists(st.floats(min_value=float(np.float32(lo)),
                                  max_value=float(np.float32(hi)), width=32,
                                  allow_nan=False, allow_infinity=False),
                        min_size=1, max_size=64)

    @hyp.settings(max_examples=80, deadline=None)
    @hyp.given(pts(-30.0, 30.0))
    def exp_and_acts(xs):
        x = np.asarray(xs, np.float32)
        xj = jnp.asarray(x)
        assert _rel(tia.i_exp(_t(x)), ref.i_exp_ref(xj)) <= BOUNDS["i_exp"]
        for op in ("i_sigmoid", "i_tanh", "i_silu"):
            assert _abs(getattr(tia, op)(_t(x)),
                        getattr(ref, op + "_ref")(xj)) <= BOUNDS[op]

    @hyp.settings(max_examples=80, deadline=None)
    @hyp.given(pts(1e-9, 1e9))
    def recip_rsqrt(xs):
        y = np.asarray(xs, np.float32)
        yj = jnp.asarray(y)
        assert _rel(tia.i_recip(_t(y)),
                    ref.i_recip_ref(yj)) <= BOUNDS["i_recip"]
        assert _rel(tia.i_rsqrt(_t(y)),
                    ref.i_rsqrt_ref(yj)) <= BOUNDS["i_rsqrt"]

    exp_and_acts()
    recip_rsqrt()
