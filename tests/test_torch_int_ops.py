"""Port parity of the integer layers (repro_torch.core.int_ops) against the
JAX layers on the pallas backend (kernels in interpret mode), on float
inputs from a numpy seed: quantize + kernel end to end.

Stated tolerances, int8 (w8·a12): ``int_embedding`` bit for bit (the
table's scale exponent, -10, lies in XLA:CPU's exact-``exp2`` window);
``int_linear`` within 64 ulp of the largest output (both quantization
scales lie in the window, so every mantissa and int32 partial agrees, but
the output exponent x_exp + w_exp = -18 does not); ``int_rmsnorm`` within
4 ulp of the row's largest output (rsqrt rounding).  At int16 the weight
exponent (-18) itself lies outside the window: the reference's weight
mantissas flip by one step at rounding boundaries, so the bounds there are
64 ulp (embedding) and 1e-4 of the largest output (linear).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import int_ops as jint_ops  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro_torch.core import int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402

ULP = 2.0 ** -23


def _cfgs(preset):
    jcfg = dataclasses.replace(JQuantConfig.preset(preset), backend="pallas",
                               stochastic_grad=False)
    return jcfg, QuantConfig.preset(preset)


@pytest.mark.parametrize("preset", ["int8", "int16"])
@pytest.mark.parametrize("tied", [False, True])
def test_int_linear_matches_reference(preset, tied):
    rng = np.random.default_rng(7 + tied)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    if tied:                    # the LM head: w = embed.T, passed as the table
        table = (0.02 * rng.standard_normal((72, 48))).astype(np.float32)
        jw, tw = jnp.asarray(table).T, torch.from_numpy(table)
        b = None
    else:
        w = (0.02 * rng.standard_normal((48, 72))).astype(np.float32)
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        b = (0.1 * rng.standard_normal(72)).astype(np.float32)
    jcfg, tcfg = _cfgs(preset)
    ref = np.asarray(jint_ops.int_linear(
        jnp.asarray(x), jw, None if b is None else jnp.asarray(b), None, jcfg))
    with torch.no_grad():
        got = int_ops.int_linear(torch.from_numpy(x), tw,
                                 None if b is None else torch.from_numpy(b),
                                 None, tcfg, transposed_w=tied).numpy()
    assert got.shape == ref.shape == (2, 5, 72)
    tol = 64 * ULP if preset == "int8" else 1e-4
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("preset", ["int8", "int16"])
def test_int_embedding_matches_reference(preset):
    rng = np.random.default_rng(3)
    table = (0.02 * rng.standard_normal((300, 40))).astype(np.float32)
    ids = rng.integers(0, 300, (3, 7)).astype(np.int32)
    jcfg, tcfg = _cfgs(preset)
    ref = np.asarray(jint_ops.int_embedding(jnp.asarray(table),
                                            jnp.asarray(ids), None, jcfg))
    with torch.no_grad():
        got = int_ops.int_embedding(torch.from_numpy(table),
                                    torch.from_numpy(ids).long(), None,
                                    tcfg).numpy()
    if preset == "int8":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=64 * ULP, atol=0)


@pytest.mark.parametrize("preset", ["int8", "int16"])
def test_int_rmsnorm_matches_reference(preset):
    rng = np.random.default_rng(5)
    x = (2.0 * rng.standard_normal((3, 4, 96))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    jcfg, tcfg = _cfgs(preset)
    ref = np.asarray(jint_ops.int_rmsnorm(jnp.asarray(x), jnp.asarray(gamma),
                                          None, jcfg))
    with torch.no_grad():
        got = int_ops.int_rmsnorm(torch.from_numpy(x),
                                  torch.from_numpy(gamma), None, tcfg).numpy()
    row = np.abs(ref).max(-1, keepdims=True)
    assert np.all(np.abs(got - ref) <= 4 * ULP * row)


def test_fp32_config_is_the_float_reference():
    """With quantization disabled each layer is its FP32 form."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    cfg = QuantConfig.fp32()
    with torch.no_grad():
        assert torch.equal(int_ops.int_linear(x, w, None, None, cfg), x @ w)
        ids = torch.tensor([[1, 3]])
        assert torch.equal(int_ops.int_embedding(w, ids, None, cfg), w[ids])
