"""Port parity of the integer layers' gradients: the autograd Functions of
repro_torch.core.int_ops (``int_linear``, ``int_embedding``,
``int_layernorm``) against ``jax.vjp`` of the JAX layers on the pallas
backend (kernels in interpret mode), on inputs and cotangents made with
numpy from a seed.

Stochastic gradient rounding: the reference draws its noise as
``jax.random.uniform(key, (rows, N))`` over the gradient's 2-D view; the
test draws the same array and hands it to the port through a callable key
(``core/dfx.py::uniform``), so both sides round with the same ``u``.

Stated tolerances.  Inside XLA:CPU's exact-``exp2`` window (inputs scaled
so that every quantization exponent and every product's output exponent
lies in [-12, 12]): the quantized gradient mantissas bit for bit; dX, dW
and the embedding table's gradient bit for bit; the bias gradient (an f32
row sum in another order) within 4 ulp of the column's Σ|g|; the
layer-norm's dx within 64 ulp of its row's max|dx|, dγ within 64 ulp of
the column's Σ|gq·xn| and dβ bit for bit (as the kernel tests).  At int16
the layer-norm's γ (≈ 1) is quantized at exponent -14, outside the window,
so its bounds there are 256 ulp.  At the scales training sees (gradient
exponents near -20, outside the window) the reference's scales are off by
up to ~34 ulp, which can move a stochastic floor by one step: dX and dW
are held there within 1e-3 of their largest magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import int_ops as jint_ops  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro_torch.core import dfx, int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402

ULP = 2.0 ** -23
#: amplitude that puts a tensor's max-abs exponent at 3 (8-bit planes and
#: a12 activations) or 10 (16 bits): every exponent in the exact window
AMP = {"int8": 2.0, "int16": 300.0}


def _cfgs(preset, stochastic):
    jcfg = dataclasses.replace(JQuantConfig.preset(preset), backend="pallas",
                               stochastic_grad=stochastic)
    tcfg = dataclasses.replace(QuantConfig.preset(preset),
                               stochastic_grad=stochastic)
    return jcfg, tcfg


def _keys(seed, rows, n, stochastic):
    """(JAX key, port key) drawing the same u over a (rows, n) gradient."""
    if not stochastic:
        return None, None
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, (rows, n), dtype=jnp.float32))

    def port_key(shape, device):
        assert tuple(shape) == u.shape
        return torch.from_numpy(u).to(device)
    return key, port_key


def _grads(fn, args, cot):
    """Port gradients of ``fn(*args)`` against cotangent ``cot``."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _exact_exp2(n: int) -> bool:
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


@pytest.mark.parametrize("preset", ["int8", "int16"])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_int_linear_grads_match_reference(preset, stochastic, bias):
    rng = np.random.default_rng([len(preset), stochastic, bias])
    a = AMP[preset]
    x = (a * rng.standard_normal((2, 5, 24))).astype(np.float32)
    w = (a * rng.standard_normal((24, 10))).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    cot = (a * rng.standard_normal((2, 5, 10))).astype(np.float32)
    jcfg, tcfg = _cfgs(preset, stochastic)
    jkey, tkey = _keys(3, 10, 10, stochastic)
    args = (x, w, b) if bias else (x, w)

    def jfn(*p):
        return jint_ops.int_linear(p[0], p[1], p[2] if bias else None, jkey,
                                   jcfg)
    y_ref, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(cot))]
    y, got = _grads(lambda *p: int_ops.int_linear(
        p[0], p[1], p[2] if bias else None, tkey, tcfg), args, cot)
    np.testing.assert_array_equal(y - (b if bias else 0),
                                  np.asarray(y_ref) - (b if bias else 0))
    np.testing.assert_array_equal(got[0], refs[0])          # dX (NT)
    np.testing.assert_array_equal(got[1], refs[1])          # dW (TN)
    if bias:
        col = np.abs(cot.reshape(-1, 10)).sum(0)
        assert np.all(np.abs(got[2] - refs[2]) <= 4 * ULP * col)


def test_tied_head_is_forward_only():
    """``transposed_w`` (the LM's tied head) is no longer forward-only: its
    gradients flow, are finite, and equal those of the same product with
    the table transposed beforehand (dX by NN over the table's own planes,
    the table's gradient by TN landing in its (V, D) layout)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    table = (0.5 * rng.standard_normal((12, 16))).astype(np.float32)
    cot = rng.standard_normal((3, 12)).astype(np.float32)
    cfg = QuantConfig.int8()
    y, (dx, dt) = _grads(lambda a, t: int_ops.int_linear(
        a, t, None, None, cfg, transposed_w=True), (x, table), cot)
    y2, (dx2, dw2) = _grads(lambda a, w: int_ops.int_linear(
        a, w, None, None, cfg), (x, np.ascontiguousarray(table.T)), cot)
    assert np.all(np.isfinite(dx)) and np.all(np.isfinite(dt))
    assert np.abs(dx).max() > 0 and np.abs(dt).max() > 0
    np.testing.assert_array_equal(y, y2)
    np.testing.assert_array_equal(dx, dx2)
    np.testing.assert_array_equal(dt, dw2.T)


def test_int_linear_grads_at_training_scales():
    """Gradient exponents near -20, outside the exact window."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    w = (0.02 * rng.standard_normal((48, 96))).astype(np.float32)
    cot = (1e-4 * rng.standard_normal((64, 96))).astype(np.float32)
    jcfg, tcfg = _cfgs("int8", True)
    jkey, tkey = _keys(9, 64, 96, True)
    _, vjp = jax.vjp(lambda x_, w_: jint_ops.int_linear(x_, w_, None, jkey,
                                                        jcfg),
                     jnp.asarray(x), jnp.asarray(w))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(cot))]
    _, got = _grads(lambda x_, w_: int_ops.int_linear(x_, w_, None, tkey,
                                                      tcfg), (x, w), cot)
    for g, r in zip(got, refs):
        assert np.abs(g - r).max() <= 1e-3 * np.abs(r).max()


@pytest.mark.parametrize("preset", ["int8", "int16"])
@pytest.mark.parametrize("stochastic", [True, False])
def test_int_embedding_grads_match_reference(preset, stochastic):
    rng = np.random.default_rng(21)
    a = AMP[preset]
    table = (a * rng.standard_normal((40, 16))).astype(np.float32)
    ids = rng.integers(0, 40, (3, 9)).astype(np.int32)
    ids[0, :3] = 5                                   # repeated rows add up
    cot = (a * rng.standard_normal((3, 9, 16))).astype(np.float32)
    jcfg, tcfg = _cfgs(preset, stochastic)
    jkey, tkey = _keys(2, 27, 16, stochastic)
    y_ref, vjp = jax.vjp(lambda t: jint_ops.int_embedding(
        t, jnp.asarray(ids), jkey, jcfg), jnp.asarray(table))
    (dt_ref,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_(True)
    y = int_ops.int_embedding(t, torch.from_numpy(ids).long(), tkey, tcfg)
    y.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(dt_ref))


@pytest.mark.parametrize("preset", ["int8", "int16"])
@pytest.mark.parametrize("stochastic", [True, False])
def test_int_layernorm_grads_match_reference(preset, stochastic):
    rng = np.random.default_rng(31)
    a = AMP[preset]
    R, D = 21, 48
    x = (a * rng.standard_normal((3, 7, D))).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    cot = (a * rng.standard_normal((3, 7, D))).astype(np.float32)
    jcfg, tcfg = _cfgs(preset, stochastic)
    jkey, tkey = _keys(4, R, D, stochastic)
    y_ref, vjp = jax.vjp(lambda *p: jint_ops.int_layernorm(*p, jkey, jcfg),
                         jnp.asarray(x), jnp.asarray(gamma),
                         jnp.asarray(beta))
    dx_ref, dg_ref, db_ref = (np.asarray(r) for r in vjp(jnp.asarray(cot)))
    y, (dx, dg, db) = _grads(lambda *p: int_ops.int_layernorm(*p, tkey, tcfg),
                             (x, gamma, beta), cot)
    ulps = 64 if preset == "int8" else 256
    row = np.abs(dx_ref).max(-1, keepdims=True)
    assert np.all(np.abs(dx - dx_ref) <= ulps * ULP * row)
    # Σ|gq·xn| per column, from the reference's own output: xn = (y-β)/γ
    xn = (np.asarray(y_ref, np.float64) - beta) / gamma
    col = np.abs(cot.astype(np.float64) * xn).reshape(R, D).sum(0)
    assert np.all(np.abs(dg - dg_ref) <= ulps * ULP * (col + 1e-30))
    np.testing.assert_array_equal(db, db_ref)
    rowy = np.abs(np.asarray(y_ref)).max(-1, keepdims=True)
    assert np.all(np.abs(y - np.asarray(y_ref)) <= ulps * ULP * rowy)


@pytest.mark.parametrize("bits", [8, 16])
def test_stochastic_grad_mantissas_bit_exact(bits):
    """The quantized gradient itself, reference u fed in: the same integer
    mantissas (logical and as limb planes), exponent inside the window."""
    rng = np.random.default_rng(bits)
    g = (AMP["int8" if bits == 8 else "int16"]
         * rng.standard_normal((13, 30))).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    jcfg, tcfg = _cfgs("int8" if bits == 8 else "int16", True)
    _, tkey = _keys(bits, 13, 30, True)
    for planes in (False, True):
        ref = jint_ops._quant_grad(jnp.asarray(g), jcfg, key,
                                   limb_planes=planes)
        got = int_ops._quant_grad(torch.from_numpy(g), tcfg, tkey,
                                  limb_planes=planes)
        assert _exact_exp2(-int(ref.exp))
        assert int(got.exp) == int(ref.exp)
        np.testing.assert_array_equal(got.m.numpy(), np.asarray(ref.m))


def test_port_stochastic_rounding_is_unbiased():
    """With its own generator the port rounds each value to floor or ceil
    only, and on average to the value itself (Assumption 2)."""
    n = 200_000
    frac = np.array([0.1, 0.25, 0.5, 0.9], np.float32)
    vals = np.repeat(3.0 + frac, n)            # mantissas 3.x at exp 0 ...
    vals[:4] = [126.0, -126.0, 0.0, 0.0]       # ... under a max of 126
    cfg = QuantConfig(weight_bits=8, act_bits=12, grad_bits=8)
    gen = torch.Generator().manual_seed(0)
    q = int_ops._quant_grad(torch.from_numpy(vals).reshape(1, -1), cfg, gen)
    assert int(q.exp) == 0
    m = q.m.numpy().reshape(-1)[4:].reshape(4, n - 1)
    for f, row in zip(frac, m):
        assert set(np.unique(row)) <= {3, 4}
        p = (row == 4).mean()
        assert abs(p - f) <= 5 * np.sqrt(f * (1 - f) / row.size)
    # the same generator state gives the same draw; round-to-nearest
    # without a key
    q2 = int_ops._quant_grad(torch.from_numpy(vals).reshape(1, -1), cfg,
                             torch.Generator().manual_seed(0))
    assert torch.equal(q.m, q2.m)
    rn = int_ops._quant_grad(torch.from_numpy(vals).reshape(1, -1), cfg, None)
    assert torch.equal(rn.m, torch.round(torch.from_numpy(vals)).to(
        torch.int8).reshape(1, -1))


def test_fp32_layers_are_plain_autograd():
    """Quantization disabled: gradients of the FP32 forms, within f32."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    beta = rng.standard_normal(16).astype(np.float32)
    cot = rng.standard_normal((4, 6, 16)).astype(np.float32)
    jcfg = JQuantConfig.fp32()
    _, vjp = jax.vjp(lambda *p: jint_ops.int_layernorm(*p, None, jcfg),
                     *map(jnp.asarray, (x, gamma, beta)))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(cot))]
    _, got = _grads(lambda *p: int_ops.int_layernorm(
        *p, None, QuantConfig.fp32()), (x, gamma, beta), cot)
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_integer_attention_and_rmsnorm_stay_forward_only():
    """Integer attention and RMS-norm now have their backward: under grad
    the gradients flow and are finite (their parity with JAX is in
    test_torch_int_attention_bwd.py / test_torch_int_rmsnorm_bwd.py);
    ``kept_ops="integer"`` still raises."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 2, 1, 8, generator=gen, requires_grad=True)
    k = torch.randn(1, 4, 2, 8, generator=gen, requires_grad=True)
    o = int_ops.int_attention(x, k, k, 0, None, QuantConfig.int8(),
                              QuantConfig.int8(), False, None)
    assert o.shape == x.shape
    o.square().sum().backward()
    for t in (x, k):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    h = torch.randn(3, 8, generator=gen, requires_grad=True)
    g = torch.ones(8, requires_grad=True)
    (int_ops.int_rmsnorm(h, g, None, QuantConfig.int8())
     * torch.arange(8.0)).sum().backward()
    for t in (h, g):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    with pytest.raises(NotImplementedError):
        int_ops.int_attention(x, k, k, 0, None,
                              QuantConfig(kept_ops="integer"),
                              QuantConfig.int8(), False, None)


def test_uniform_key_kinds():
    gen = torch.Generator().manual_seed(1)
    u = dfx.uniform(gen, (3, 4), "cpu")
    assert u.shape == (3, 4) and u.dtype == torch.float32
    assert float(u.min()) >= 0 and float(u.max()) < 1
    v = dfx.uniform(lambda shape, device: torch.full(shape, 0.5), (2, 2),
                    "cpu")
    assert torch.equal(v, torch.full((2, 2), 0.5))
