"""``dfx.error_bound`` / ``variance_bound`` (the paper's Proposition 1
step, ``2^(e_scale - b + 1)``, and its square) against the reference's.

The port builds the power of two exactly (``pow2``); the reference's
``jnp.exp2`` is exact on XLA:CPU only for integer arguments in about
[-12, 12] (caveat A).  So: the port equals ``np.ldexp`` at every exponent,
and equals the reference bit for bit wherever the run-time check
``jnp.exp2(n) == np.ldexp(1, n)`` holds for that exponent (or within 64
ulp where it does not).  Also the bound itself: round-to-nearest
quantization errs by at most half of it, stochastic rounding by less than
all of it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dfx as jdfx  # noqa: E402
from repro_torch.core import dfx  # noqa: E402

CASES = [(b, k) for b in (8, 12, 16) for k in (-20, -6, 0, 3, 9, 25)]


@pytest.mark.parametrize("bits,k", CASES)
def test_error_bound_matches_reference(bits, k):
    x = (np.random.default_rng(bits * 100 + k).standard_normal((7, 33))
         * 2.0 ** k).astype(np.float32)
    _, e = np.frexp(np.abs(x).max())
    n = int(e) - (bits - 1)
    got = dfx.error_bound(torch.from_numpy(x), bits)
    var = dfx.variance_bound(torch.from_numpy(x), bits)
    assert got.dtype == var.dtype == torch.float32 and got.dim() == 0
    assert float(got) == np.ldexp(1.0, n)
    assert float(var) == np.float32(np.ldexp(1.0, n)) ** 2
    ref = float(jdfx.error_bound(jnp.asarray(x), bits))
    ref_var = float(jdfx.variance_bound(jnp.asarray(x), bits))
    if float(jnp.exp2(jnp.float32(n))) == np.ldexp(1.0, n):
        assert float(got) == ref and float(var) == ref_var
    else:
        assert abs(float(got) - ref) <= 64 * np.spacing(np.float32(ref))


def test_error_bound_of_zero_and_the_bound_holds():
    assert float(dfx.error_bound(torch.zeros(4, 4), 8)) == 2.0 ** -7
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 48), generator=gen) * 3.0
    for bits in (8, 12, 16):
        step = float(dfx.error_bound(x, bits))
        rn = dfx.dequantize(dfx.quantize(x, bits))
        assert float((rn - x).abs().max()) <= step / 2
        u = torch.rand(x.shape, generator=gen)
        sr = dfx.dequantize(dfx.quantize(x, bits, u=u))
        assert float((sr - x).abs().max()) < step
