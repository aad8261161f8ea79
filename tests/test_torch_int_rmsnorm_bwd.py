"""Port parity: the RMS-norm backward (the plain version of
``int_rmsnorm_bwd`` in repro_torch.kernels.int_norm) against the JAX Pallas
kernel in interpret mode (through ``rmsnorm_bwd_pallas``, which pads the
rows) and the f64 oracle ``kernels/ref.py::int_rmsnorm_bwd_ref``, and
``int_ops.int_rmsnorm``'s gradients against ``jax.vjp``.

Stated tolerances (f32 sums in another order; no exponent leaves XLA:CPU's
exact-``exp2`` window): dx within 64 ulp of its row's max|dx|, dγ within
64 ulp of the column's Σ|gq·xn|.  Through ``int_rmsnorm`` (quantize,
forward kernel, backward kernel) against ``jax.vjp`` on the pallas
backend, the reference's stochastic noise ``u`` fed in through a callable
key: y within 8 ulp and dx within 64 ulp of their row's max, dγ within
64 ulp of the column's Σ|cot·y/γ| (256 ulp at int16, whose γ is quantized
at exponent -14, outside the window).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import int_ops as jint_ops  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dfx, int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels import int_norm, ops  # noqa: E402

ULP = 2.0 ** -23


def _inputs(R, D, x_dtype, g_dtype, seed):
    rng = np.random.default_rng(seed)
    xlim = 2047 if x_dtype == np.int16 else 127
    xm = rng.integers(-xlim, xlim + 1, (R, D)).astype(x_dtype)
    gm = rng.integers(-127, 128, (R, D)).astype(g_dtype)
    gamma = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    x_exp, g_exp = (-9 if x_dtype == np.int16 else -5), -7
    _, rstd = int_norm.int_rmsnorm_fwd_plain(
        torch.from_numpy(xm), torch.tensor(x_exp), torch.from_numpy(gamma))
    return xm, gm, x_exp, g_exp, gamma, rstd


def _bounds(xm, gm, x_exp, g_exp, gamma, rstd, dx_ref):
    xn = xm.astype(np.float64) * 2.0 ** x_exp * rstd.numpy()
    col = np.abs(gm.astype(np.float64) * 2.0 ** g_exp * xn).sum(0)
    row = np.abs(dx_ref).max(-1, keepdims=True)
    return row, col


@pytest.mark.parametrize("R,D", [(37, 48), (64, 256), (130, 96)])
@pytest.mark.parametrize("x_dtype,g_dtype", [(np.int16, np.int8),
                                             (np.int8, np.int8),
                                             (np.int16, np.int16)])
def test_rmsnorm_bwd_matches_pallas_and_oracle(R, D, x_dtype, g_dtype):
    xm, gm, x_exp, g_exp, gamma, rstd = _inputs(R, D, x_dtype, g_dtype,
                                                R + D)
    dx, dg = ops.rmsnorm_bwd(torch.from_numpy(xm), torch.tensor(x_exp),
                             torch.from_numpy(gm), torch.tensor(g_exp),
                             torch.from_numpy(gamma), rstd)
    assert dx.shape == (R, D) and dg.shape == (D,)
    args = (jnp.asarray(xm), jnp.int32(x_exp), jnp.asarray(gm),
            jnp.int32(g_exp), jnp.asarray(gamma), jnp.asarray(rstd.numpy()))
    for dx_ref, dg_ref in (jops.rmsnorm_bwd_pallas(*args, interpret=True),
                           jref.int_rmsnorm_bwd_ref(*args)):
        dx_ref, dg_ref = np.asarray(dx_ref), np.asarray(dg_ref)
        row, col = _bounds(xm, gm, x_exp, g_exp, gamma, rstd, dx_ref)
        assert np.all(np.abs(dx.numpy() - dx_ref) <= 64 * ULP * row)
        assert np.all(np.abs(dg.numpy() - dg_ref) <= 64 * ULP * col)


def test_rmsnorm_bwd_wrapper_checks_its_arguments():
    xm, gm, x_exp, g_exp, gamma, rstd = _inputs(8, 16, np.int16, np.int8, 0)
    x, g = torch.from_numpy(xm), torch.from_numpy(gm)
    with pytest.raises(ValueError):
        int_norm.int_rmsnorm_bwd(x, g[:4], torch.tensor(x_exp),
                                 torch.tensor(g_exp),
                                 torch.from_numpy(gamma), rstd)
    with pytest.raises(ValueError):
        int_norm.int_rmsnorm_bwd(x, g, torch.tensor(x_exp),
                                 torch.tensor(g_exp),
                                 torch.from_numpy(gamma), rstd[:4])
    with pytest.raises(TypeError):
        int_norm.int_rmsnorm_bwd(x.float(), g, torch.tensor(x_exp),
                                 torch.tensor(g_exp),
                                 torch.from_numpy(gamma), rstd)


@pytest.mark.parametrize("preset", ["int8", "int16"])
@pytest.mark.parametrize("stochastic", [True, False])
def test_int_rmsnorm_grads_match_jax_vjp(preset, stochastic):
    rng = np.random.default_rng([len(preset), stochastic])
    amp = 2.0 if preset == "int8" else 300.0
    x = (amp * rng.standard_normal((3, 7, 48))).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(48)).astype(np.float32)
    cot = (amp * rng.standard_normal((3, 7, 48))).astype(np.float32)
    jcfg = dataclasses.replace(JQuantConfig.preset(preset), backend="pallas",
                               stochastic_grad=stochastic)
    tcfg = dataclasses.replace(QuantConfig.preset(preset),
                               stochastic_grad=stochastic)
    jkey = tkey = None
    if stochastic:
        jkey = jax.random.PRNGKey(11)
        u = np.array(jax.random.uniform(jkey, (21, 48), dtype=jnp.float32))

        def tkey(shape, device):
            assert tuple(shape) == u.shape
            return torch.from_numpy(u).to(device)
    y_ref, vjp = jax.vjp(lambda a, b: jint_ops.int_rmsnorm(a, b, jkey, jcfg),
                         jnp.asarray(x), jnp.asarray(gamma))
    dx_ref, dg_ref = (np.asarray(r) for r in vjp(jnp.asarray(cot)))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    y = int_ops.int_rmsnorm(xt, gt, tkey, tcfg)
    y.backward(torch.from_numpy(cot))
    ulps = 64 if preset == "int8" else 256
    y_ref = np.asarray(y_ref)
    rowy = np.abs(y_ref).max(-1, keepdims=True)
    assert np.all(np.abs(y.detach().numpy() - y_ref) <= 8 * ULP * rowy)
    row = np.abs(dx_ref).max(-1, keepdims=True)
    assert np.all(np.abs(xt.grad.numpy() - dx_ref) <= ulps * ULP * row)
    # Σ|gq·xn| per column, from the reference's own output: xn = y / γq
    gq = dfx.dequantize(dfx.quantize(torch.from_numpy(gamma),
                                     tcfg.weight_bits)).numpy()
    col = np.abs(cot.astype(np.float64) * y_ref / gq).reshape(21, 48).sum(0)
    assert np.all(np.abs(gt.grad.numpy() - dg_ref) <= ulps * ULP * col)
