"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels build
on first use); without a card each skips.  This file imports no JAX, so it
runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: integer outputs and the matmul (same int32 sums, same ordered
f32 combine) exactly; RMS-norm within 2 ulp (rstd) and 4 ulp (y), for
PyTorch's own sqrt / reciprocal; attention within 1e-5 of max|o| and 1e-4
on lse — the same expf on both sides, only the row-sum order of l differs.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dfx  # noqa: E402
from repro_torch.kernels import bfp_matmul as bm  # noqa: E402
from repro_torch.kernels import dfx_quant  # noqa: E402
from repro_torch.kernels import int_attention as ia  # noqa: E402
from repro_torch.kernels import int_norm  # noqa: E402

ULP = 2.0 ** -23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the chip)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 12, 16])
def test_dfx_quantize(dev, bits):
    gen = torch.Generator(device=dev).manual_seed(bits)
    x = torch.randn((333, 517), generator=gen, device=dev)
    u = torch.rand((333, 517), generator=gen, device=dev)
    exp = dfx.scale_exponent(x) - (bits - 1)
    for src, uu in ((x, u), (x.t(), u.t())):      # and a non-contiguous view
        for kw in (dict(), dict(u=uu), dict(limb_planes=True),
                   dict(u=uu, limb_planes=True)):
            got = dfx_quant.dfx_quantize(src, exp, bits=bits, **kw)
            ref = dfx_quant.dfx_quantize_plain(src, exp, bits=bits, **kw)
            assert torch.equal(got, ref), kw


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 3072), (77, 130, 61),
                                   (256, 2816, 1024)])
def test_bfp_matmul(dev, shape):
    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(M)
    e = torch.tensor(-19, dtype=torch.int32, device=dev)
    for lx in (1, 2, 3):
        for lw in (1, 2, 3):
            xm = torch.randint(-64, 65, (lx, M, K), generator=gen,
                               device=dev, dtype=torch.int8)
            wm = torch.randint(-64, 65, (lw, N, K), generator=gen,
                               device=dev, dtype=torch.int8)
            for w in (wm.transpose(1, 2), wm.transpose(1, 2).contiguous()):
                assert torch.equal(bm.bfp_matmul(xm, w, e),
                                   bm.bfp_matmul_plain(xm, w, e))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lim", [(torch.int8, 127), (torch.int16, 2047),
                                       (torch.int16, 32767)])
def test_int_rmsnorm_fwd(dev, dtype, lim):
    gen = torch.Generator(device=dev).manual_seed(lim)
    for R, D in ((4, 1024), (257, 1000), (1, 7)):
        xm = torch.randint(-lim, lim + 1, (R, D), generator=gen,
                           device=dev).to(dtype)
        gamma = torch.randn((D,), generator=gen, device=dev)
        e = torch.tensor(-9, dtype=torch.int32, device=dev)
        y, r = int_norm.int_rmsnorm_fwd(xm, e, gamma)
        y0, r0 = int_norm.int_rmsnorm_fwd_plain(xm, e, gamma)
        torch.testing.assert_close(r, r0, rtol=2 * ULP, atol=0)
        torch.testing.assert_close(y, y0, rtol=4 * ULP, atol=1e-30)


ATTN = {
    # name: (B, Sq, Sk, KV, G, hd, offsets, causal, window)
    "decode": (4, 1, 256, 16, 1, 64, [64, 65, 66, 255], True, None),
    "chunked_prefill_gqa": (2, 20, 300, 2, 2, 16, [100, 37], True, None),
    "window": (1, 17, 260, 1, 2, 24, [200], True, 40),
    "bidirectional": (2, 9, 9, 1, 3, 8, [0, 0], False, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTN))
@pytest.mark.parametrize("lqk,lpv,pb", [(1, 1, 8), (2, 2, 12), (3, 2, 12)])
def test_int_attn_fwd(dev, case, lqk, lpv, pb):
    B, Sq, Sk, KV, G, hd, off, causal, window = ATTN[case]
    gen = torch.Generator(device=dev).manual_seed(lqk * 10 + lpv)

    def planes(L, *shape):
        return torch.randint(-64, 65, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    qm, km = planes(lqk, B, Sq, KV, G, hd), planes(lqk, B, Sk, KV, hd)
    vm = planes(lpv, B, Sk, KV, hd)
    qo = torch.tensor(off, dtype=torch.int32, device=dev)
    exps = torch.tensor([-11, -10, -8], dtype=torch.int32, device=dev)
    kw = dict(p_bits=pb, causal=causal, window=window, sc=1.0 / hd ** 0.5)
    o, lse = ia.int_attn_fwd(qm, km, vm, qo, exps, **kw)
    o0, lse0 = ia.int_attn_fwd_plain(qm, km, vm, qo, exps, **kw)
    assert (o - o0).abs().max() <= 1e-5 * o0.abs().max()
    assert (lse - lse0).abs().max() <= 1e-4


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain versions (no build, no card)."""
    x = torch.randn(5, 6)
    exp = dfx.scale_exponent(x) - 7
    assert torch.equal(dfx_quant.dfx_quantize(x, exp, bits=8),
                       dfx_quant.dfx_quantize_plain(x, exp, bits=8))
