"""Port parity: integer flash-attention forward
(repro_torch.kernels.int_attention) vs the JAX Pallas kernel in interpret
mode, its f64 oracle, and ``int_ops.int_attention`` end to end.

Integer dots are exact and every f32 expression runs in the reference's
order, but two kept ops round differently: ``exp`` (XLA:CPU's polynomial vs
PyTorch's) and the 128-term row sum of p (another summation order).  An exp
ulp can move p across a rounding boundary of its p_bits mantissa, which
moves o by at most one P step, |v|·2^-(p_bits-1)/l.  Stated tolerance:
o within 2^-(p_bits-1) · max|v| of the reference, and lse within 1e-5
absolute, with the score exponent inside the exact-``exp2`` window.
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
from repro_torch.core import int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_EXPS = (-5, -5, -6)            # q, k, v: q_exp + k_exp = -10, in window


def _exact_exp2(n: int) -> bool:
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _mantissas(rng, bits, shape, sigma=40.0):
    lim = 2 ** (bits - 1) - 1
    return np.clip(np.round(rng.standard_normal(shape) * sigma), -lim,
                   lim).astype(np.int32)


def _run(qm, km, vm, off, qk_bits, pv_bits, causal, window, exps=_EXPS):
    """(port o, lse), (reference o, lse) from logical mantissas."""
    planes = [ops.split_limbs_stacked(torch.from_numpy(m), b)
              for m, b in ((qm, qk_bits), (km, qk_bits), (vm, pv_bits))]
    e = [torch.tensor(x, dtype=torch.int32) for x in exps]
    o, lse = ops.attention_fwd(planes[0], e[0], planes[1], e[1], planes[2],
                               e[2], torch.tensor(off, dtype=torch.int32),
                               pv_bits, causal=causal, window=window)
    jp = [jnp.asarray(p.numpy()) for p in planes]
    o_ref, lse_ref = jops.attention_fwd(
        jp[0], jnp.int32(exps[0]), jp[1], jnp.int32(exps[1]), jp[2],
        jnp.int32(exps[2]), jnp.asarray(off, jnp.int32), pv_bits,
        causal=causal, window=window, interpret=True)
    return (o.numpy(), lse.numpy()), (np.asarray(o_ref), np.asarray(lse_ref))


CASES = {
    # name: (B, Sq, Sk, KV, G, hd, offsets, causal, window)
    "decode": (3, 1, 200, 2, 1, 32, [150, 60, 199], True, None),
    "chunked_prefill_gqa": (2, 20, 300, 2, 2, 16, [100, 37], True, None),
    "window": (1, 17, 260, 1, 2, 24, [200], True, 40),
    "bidirectional": (2, 9, 9, 1, 3, 8, [0, 0], False, None),
    # heads wider than the CUDA kernel's staged body takes (its direct
    # body); named to sort last, so the seeds of the cases above stay
    "x_head_dim_256": (1, 9, 140, 1, 1, 256, [131], True, None),
    "x_head_dim_384": (1, 9, 140, 1, 2, 384, [131], True, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("qk_bits,pv_bits", [(8, 8), (12, 12), (16, 12)])
def test_attention_matches_pallas(case, qk_bits, pv_bits):
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) * 100 + qk_bits + pv_bits)
    qm = _mantissas(rng, qk_bits, (B, Sq, KV, G, hd))
    km = _mantissas(rng, qk_bits, (B, Sk, KV, hd))
    vm = _mantissas(rng, pv_bits, (B, Sk, KV, hd))
    assert _exact_exp2(_EXPS[0] + _EXPS[1]) and _exact_exp2(_EXPS[2])
    (o, lse), (o_ref, lse_ref) = _run(qm, km, vm, off, qk_bits, pv_bits,
                                      causal, window)
    assert o.shape == (B, Sq, KV, G, hd) and lse.shape == (B, KV, G, Sq)
    vmax = np.abs(vm).max() * 2.0 ** _EXPS[2]
    assert np.abs(o - o_ref).max() <= 2.0 ** -(pv_bits - 1) * vmax
    np.testing.assert_allclose(lse, lse_ref, rtol=0, atol=1e-5)


def test_head_dim_256_three_limbs_matches_pallas():
    """16-bit q, k, v and P (3 limb planes each, the int16 preset's) at head
    dim 256: the shape whose tiles passed the old kernel's shared memory."""
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES["x_head_dim_256"]
    rng = np.random.default_rng(1616)
    qm = _mantissas(rng, 16, (B, Sq, KV, G, hd))
    km = _mantissas(rng, 16, (B, Sk, KV, hd))
    vm = _mantissas(rng, 16, (B, Sk, KV, hd))
    (o, lse), (o_ref, lse_ref) = _run(qm, km, vm, off, 16, 16, causal,
                                      window)
    vmax = np.abs(vm).max() * 2.0 ** _EXPS[2]
    assert np.abs(o - o_ref).max() <= 2.0 ** -15 * vmax
    np.testing.assert_allclose(lse, lse_ref, rtol=0, atol=1e-5)


def test_block_row_sum_takes_the_kernels_order():
    """``_block_row_sum`` adds column 8j + 2t + e to partial t in column
    order, then (p0 + p1) + (p2 + p3): the order of the CUDA kernel's MMA
    lanes and quad shuffles, here spelled out in float32 one add at a time;
    and it stays within a few ulps of an f64 sum."""
    from repro_torch.kernels import int_attention as ia
    rng = np.random.default_rng(7)
    for n in (128, 77, 1):
        p = rng.random((3, n)).astype(np.float32) ** 4
        got = ia._block_row_sum(torch.from_numpy(p)).numpy()[:, 0]
        for row, g in zip(np.pad(p, ((0, 0), (0, 128 - n))), got):
            part = [np.float32(0)] * 4
            for j in range(16):
                for t in range(4):
                    for e in range(2):
                        part[t] = np.float32(part[t] + row[8 * j + 2 * t + e])
            want = np.float32(np.float32(part[0] + part[1])
                              + np.float32(part[2] + part[3]))
            assert g == want
            assert abs(float(g) - row.astype(np.float64).sum()) <= \
                8 * np.spacing(np.float32(g))


def test_single_block_matches_f64_oracle():
    """Within one 128-key block the running max is the global max, so the
    f64 oracle (global-max softmax) applies with the same tolerance."""
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES["bidirectional"]
    rng = np.random.default_rng(11)
    qm = _mantissas(rng, 12, (B, Sq, KV, G, hd))
    km = _mantissas(rng, 12, (B, Sk, KV, hd))
    vm = _mantissas(rng, 12, (B, Sk, KV, hd))
    (o, lse), _ = _run(qm, km, vm, off, 12, 12, causal, window)
    o_o, lse_o = jref.int_attention_fwd_ref(
        jnp.asarray(qm), jnp.int32(_EXPS[0]), jnp.asarray(km),
        jnp.int32(_EXPS[1]), jnp.asarray(vm), jnp.int32(_EXPS[2]), 12,
        jnp.asarray(off), causal=causal, window=window)
    vmax = np.abs(vm).max() * 2.0 ** _EXPS[2]
    assert np.abs(o - np.asarray(o_o)).max() <= 2.0 ** -11 * vmax
    np.testing.assert_allclose(lse, np.asarray(lse_o), atol=1e-5)


def test_full_range_mantissas_outside_window():
    """Full-range 12-bit mantissas force q_exp + k_exp = -18, outside the
    window: the reference's score scale is then off by ulps, which the
    bound of one P step still covers."""
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES["chunked_prefill_gqa"]
    rng = np.random.default_rng(5)
    qm = _mantissas(rng, 12, (B, Sq, KV, G, hd), sigma=600)
    km = _mantissas(rng, 12, (B, Sk, KV, hd), sigma=600)
    vm = _mantissas(rng, 12, (B, Sk, KV, hd), sigma=600)
    exps = (-9, -9, -9)
    assert not _exact_exp2(-18)
    (o, lse), (o_ref, lse_ref) = _run(qm, km, vm, off, 12, 12, causal,
                                      window, exps)
    vmax = np.abs(vm).max() * 2.0 ** -9
    assert np.abs(o - o_ref).max() <= 2.0 ** -11 * vmax
    np.testing.assert_allclose(lse, lse_ref, rtol=1e-6, atol=1e-5)


def test_int_attention_matches_reference_end_to_end():
    """``int_ops.int_attention`` on float q/k/v (quantize + fused kernel)
    against the JAX op on the pallas backend, GQA decode over a cache."""
    rng = np.random.default_rng(3)
    B, Sk, KV, G, hd = 2, 140, 2, 2, 32
    q = rng.standard_normal((B, 1, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    off = np.array([90, 139], np.int32)
    jcfg = dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                               stochastic_grad=False)
    o_ref = jint_ops.int_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(off), None,
                                   jcfg, jcfg, True, None)
    with torch.no_grad():
        o = int_ops.int_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(off),
                                  None, QuantConfig.int8(),
                                  QuantConfig.int8(), True, None)
    vmax = np.abs(v).max()
    assert np.abs(o.numpy() - np.asarray(o_ref)).max() <= 2.0 ** -9 * vmax
