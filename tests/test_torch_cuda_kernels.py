"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels build
on first use); without a card each skips.  This file imports no JAX, so it
runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: integer outputs and the matmuls, NN, NT and TN and their
batched (MoE expert-axis) twins (same int32 sums, same ordered f32
combine) exactly, the grouped quantize too; RMS-norm within 2 ulp (rstd) and 4
ulp (y), for PyTorch's own sqrt / reciprocal; layer-norm forward within 2
ulp of mu and 4 ulp of rstd and y within 8 ulp of its row's max|y| plus
rstd's difference times the row's max|xn·γ|; layer-norm backward dβ
exactly, dx within 64 ulp of its row's max|dx| and dγ within 64 ulp of the
column's Σ|gq·xn| (f32 sums in another order), and the same for the
RMS-norm backward; attention within 1e-5 of max|o| and 1e-4 on lse — the
same expf on both sides (the plain version sums l in the kernel's order);
the attention backward's dq, dk and dv within 1e-4 of their max|ref| (the
same expf and the same ordered f32 sums on both sides).  The kept-int
bodies (``integer_rsqrt`` / ``integer_exp``): the norms' rstd and mu bit
for bit, the attention forward as the FP32 body, the attention backward
(and its head-dim-256 body) bit for bit at the int8 preset's limbs.  The
attention kernels at any head dim (their direct bodies past the staged
ones' shared memory): the forward as above, the backward bit for bit.
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
@pytest.mark.parametrize("shape", [(4096, 768, 3072), (77, 130, 61),
                                   (32, 768, 4), (5, 768, 2)])
def test_bfp_matmul_nt_tn(dev, shape):
    """NT (dX = G·Wᵀ) and TN (dW = Xᵀ·G) at the BERT shapes (M tokens,
    K features, N outputs), ragged ones too."""
    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(M + N)
    e = torch.tensor(-21, dtype=torch.int32, device=dev)

    def planes(L, *s):
        return torch.randint(-64, 65, (L,) + s, generator=gen, device=dev,
                             dtype=torch.int8)
    for la, lb in ((1, 1), (2, 1), (1, 2), (3, 3)):
        gm, wm = planes(la, M, N), planes(lb, K, N)
        assert torch.equal(bm.bfp_matmul_nt(gm, wm, e),
                           bm.bfp_matmul_nt_plain(gm, wm, e))
        xm, g2 = planes(la, M, K), planes(lb, M, N)
        assert torch.equal(bm.bfp_matmul_tn(xm, g2, e),
                           bm.bfp_matmul_tn_plain(xm, g2, e))


@pytest.mark.cuda
@pytest.mark.parametrize("xt,xlim,gt,glim", [
    (torch.int16, 2047, torch.int8, 127), (torch.int8, 127, torch.int8, 127),
    (torch.int16, 32767, torch.int16, 32767)])
def test_int_layernorm(dev, xt, xlim, gt, glim):
    gen = torch.Generator(device=dev).manual_seed(xlim + glim)
    for R, D in ((4096, 768), (37, 1000), (1, 7)):
        xm = torch.randint(-xlim, xlim + 1, (R, D), generator=gen,
                           device=dev).to(xt)
        xm[0] = xm[0, 0]                          # variance clamped at 0
        gm = torch.randint(-glim, glim + 1, (R, D), generator=gen,
                           device=dev).to(gt)
        gamma = 1 + 0.2 * torch.randn((D,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((D,), generator=gen, device=dev)
        xe = torch.tensor(-10, dtype=torch.int32, device=dev)
        ge = torch.tensor(-20, dtype=torch.int32, device=dev)
        y, mu, r = int_norm.int_layernorm_fwd(xm, xe, gamma, beta)
        y0, mu0, r0 = int_norm.int_layernorm_fwd_plain(xm, xe, gamma, beta)
        torch.testing.assert_close(mu, mu0, rtol=2 * ULP, atol=1e-30)
        torch.testing.assert_close(r, r0, rtol=4 * ULP, atol=0)
        xn = ((xm.float() * 2.0 ** -10 - mu0) * r0 * gamma).abs()
        bound = (8 * ULP * y0.abs().amax(-1, keepdim=True)
                 + ((r - r0).abs() / r0) * xn.amax(-1, keepdim=True))
        assert ((y - y0).abs() <= bound + 1e-30).all()
        dx, dg, db = int_norm.int_layernorm_bwd(xm, gm, xe, ge, gamma, mu0,
                                                r0)
        dx0, dg0, db0 = int_norm.int_layernorm_bwd_plain(xm, gm, xe, ge,
                                                         gamma, mu0, r0)
        assert torch.equal(db, db0)
        row = dx0.abs().amax(-1, keepdim=True)
        assert ((dx - dx0).abs() <= 64 * ULP * row + 1e-30).all()
        col = (gm.float() * 2.0 ** -20
               * (xm.float() * 2.0 ** -10 - mu0) * r0).abs().sum(0)
        assert ((dg - dg0).abs() <= 64 * ULP * col + 1e-30).all()


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


@pytest.mark.cuda
@pytest.mark.parametrize("xt,xlim,gt,glim", [
    (torch.int16, 2047, torch.int8, 127), (torch.int8, 127, torch.int8, 127),
    (torch.int16, 32767, torch.int16, 32767)])
def test_int_rmsnorm_bwd(dev, xt, xlim, gt, glim):
    gen = torch.Generator(device=dev).manual_seed(xlim + 3 * glim)
    for R, D in ((2048, 1024), (37, 1000), (1, 7)):
        xm = torch.randint(-xlim, xlim + 1, (R, D), generator=gen,
                           device=dev).to(xt)
        gm = torch.randint(-glim, glim + 1, (R, D), generator=gen,
                           device=dev).to(gt)
        gamma = 1 + 0.2 * torch.randn((D,), generator=gen, device=dev)
        xe = torch.tensor(-10, dtype=torch.int32, device=dev)
        ge = torch.tensor(-20, dtype=torch.int32, device=dev)
        _, r0 = int_norm.int_rmsnorm_fwd_plain(xm, xe, gamma)
        dx, dg = int_norm.int_rmsnorm_bwd(xm, gm, xe, ge, gamma, r0)
        dx0, dg0 = int_norm.int_rmsnorm_bwd_plain(xm, gm, xe, ge, gamma, r0)
        row = dx0.abs().amax(-1, keepdim=True)
        assert ((dx - dx0).abs() <= 64 * ULP * row + 1e-30).all()
        col = (gm.float() * 2.0 ** -20 * xm.float() * 2.0 ** -10
               * r0).abs().sum(0)
        assert ((dg - dg0).abs() <= 64 * ULP * col + 1e-30).all()


ATTN_BWD = {
    # name: (B, Sq, Sk, KV, G, hd, offsets, causal, window)
    "bert_cls": (2, 128, 128, 12, 1, 64, [0, 0], False, None),
    "qwen_train": (1, 256, 256, 4, 1, 64, [0], True, None),
    "smollm_gqa3": (2, 130, 130, 3, 3, 64, [0, 0], True, None),
    "ragged_window": (2, 20, 150, 2, 2, 16, [100, 37], True, 40),
    "qwen_train_hd128": (1, 256, 256, 4, 1, 128, [0], True, None),
    "ragged_gqa2": (2, 200, 200, 2, 2, 64, [0, 0], True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTN_BWD))
@pytest.mark.parametrize("lqk,lpv,lg,ds_bits,pb", [
    (2, 2, 1, 8, 12), (1, 1, 1, 8, 8), (3, 3, 3, 16, 16), (2, 2, 2, 12, 12)])
def test_int_attn_bwd(dev, case, lqk, lpv, lg, ds_bits, pb):
    B, Sq, Sk, KV, G, hd, off, causal, window = ATTN_BWD[case]
    gen = torch.Generator(device=dev).manual_seed(lqk * 100 + lg * 10 + pb)

    def planes(L, *shape):
        return torch.randint(-64, 65, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    qm, km = planes(lqk, B, Sq, KV, G, hd), planes(lqk, B, Sk, KV, hd)
    vm, gm = planes(lpv, B, Sk, KV, hd), planes(lg, B, Sq, KV, G, hd)
    qo = torch.tensor(off, dtype=torch.int32, device=dev)
    exps = torch.tensor([-11, -10, -8, -12, -13], dtype=torch.int32,
                        device=dev)
    sc = 1.0 / hd ** 0.5
    _, lse = ia.int_attn_fwd_plain(qm, km, vm, qo, exps[:3], p_bits=pb,
                                   causal=causal, window=window, sc=sc)
    delta = 0.05 * torch.randn((B, Sq, KV, G), generator=gen, device=dev)
    kw = dict(p_bits=pb, ds_bits=ds_bits, causal=causal, window=window,
              sc=sc)
    dq = ia.int_attn_bwd_dq(qm, km, vm, gm, lse, delta, qo, exps, **kw)
    dk, dv = ia.int_attn_bwd_dkv(qm, km, vm, gm, lse, delta, qo, exps, **kw)
    kw.pop("p_bits")
    dq0 = ia.int_attn_bwd_dq_plain(qm, km, vm, gm, lse, delta, qo, exps,
                                   **kw)
    dk0, dv0 = ia.int_attn_bwd_dkv_plain(qm, km, vm, gm, lse, delta, qo,
                                         exps, p_bits=pb, **kw)
    for got, ref in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert ref.abs().max() > 0
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
        if (lqk, lpv, lg, ds_bits, pb) == (2, 2, 1, 8, 12):  # int8 preset
            assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 12, 16])
def test_dfx_quantize_grouped(dev, bits):
    """(E, M, N) stacks at per-slice exponents, slice 2 all zero (an expert
    that receives no token); the MoE shapes' E = 60 with a ragged slice."""
    gen = torch.Generator(device=dev).manual_seed(bits)
    for E, M, N in ((5, 77, 130), (60, 16, 2048), (1, 3, 5)):
        x = torch.randn((E, M, N), generator=gen, device=dev)
        x *= 2.0 ** torch.arange(E, device=dev)[:, None, None] / 8
        if E > 2:
            x[2] = 0
        u = torch.rand((E, M, N), generator=gen, device=dev)
        exp = dfx.slice_exponents(x) - (bits - 1)
        for kw in (dict(), dict(u=u), dict(limb_planes=True),
                   dict(u=u, limb_planes=True)):
            got = dfx_quant.dfx_quantize_grouped(x, exp, bits=bits, **kw)
            ref = dfx_quant.dfx_quantize_grouped_plain(x, exp, bits=bits,
                                                       **kw)
            assert torch.equal(got, ref), (E, M, N, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(60, 16, 2048, 1408), (4, 77, 130, 61),
                                   (3, 5, 768, 4), (1, 256, 1408, 2048)])
def test_bfp_matmul_batched(dev, shape):
    """Batched NN, NT (dX) and TN (dW) over plane-major (L, E, ...) planes
    with one exponent per expert, at MoE decode and training shapes and
    ragged ones."""
    E, M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(E + M)
    e = torch.arange(E, dtype=torch.int32, device=dev) - 21

    def planes(L, *s):
        return torch.randint(-64, 65, (L,) + s, generator=gen, device=dev,
                             dtype=torch.int8)
    for la, lb in ((1, 1), (2, 1), (1, 2), (3, 3)):
        xm, wm = planes(la, E, M, K), planes(lb, E, K, N)
        assert torch.equal(bm.bfp_matmul_batched(xm, wm, e),
                           bm.bfp_matmul_batched_plain(xm, wm, e))
        gm = planes(la, E, M, N)
        assert torch.equal(bm.bfp_matmul_batched_nt(gm, wm, e),
                           bm.bfp_matmul_batched_nt_plain(gm, wm, e))
        assert torch.equal(bm.bfp_matmul_batched_tn(xm, gm[:lb], e),
                           bm.bfp_matmul_batched_tn_plain(xm, gm[:lb], e))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_int_norm_integer_rsqrt(dev, kind):
    """The kept-int body (``integer_rsqrt``): the same moments, then the
    Q.14 Newton rsqrt, so rstd and mu are bit for bit the plain version's
    and y within 4 ulp of its row's max|y|."""
    gen = torch.Generator(device=dev).manual_seed(len(kind))
    for R, D in ((4096, 768), (2048, 1024), (37, 1000), (1, 7)):
        xm = torch.randint(-2047, 2048, (R, D), generator=gen,
                           device=dev).to(torch.int16)
        xm[0] = xm[0, 0]
        gamma = 1 + 0.2 * torch.randn((D,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((D,), generator=gen, device=dev)
        xe = torch.tensor(-10, dtype=torch.int32, device=dev)
        if kind == "layernorm":
            got = int_norm.int_layernorm_fwd(xm, xe, gamma, beta,
                                             integer_rsqrt=True)
            ref = int_norm.int_layernorm_fwd_plain(xm, xe, gamma, beta,
                                                   integer_rsqrt=True)
        else:
            got = int_norm.int_rmsnorm_fwd(xm, xe, gamma, integer_rsqrt=True)
            ref = int_norm.int_rmsnorm_fwd_plain(xm, xe, gamma,
                                                 integer_rsqrt=True)
        for a, b in zip(got[1:], ref[1:]):
            assert torch.equal(a, b)
        row = ref[0].abs().amax(-1, keepdim=True)
        assert ((got[0] - ref[0]).abs() <= 4 * ULP * row + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTN) + ["train_causal"])
def test_int_attn_fwd_integer_exp(dev, case):
    """The kept-int body (``integer_exp``): i_exp, the skipped key blocks'
    i_exp(0) scaling and the i_recip epilogue; within the FP32 body's
    tolerances (1e-5 of max|o|, 1e-4 on lse)."""
    B, Sq, Sk, KV, G, hd, off, causal, window = ATTN.get(
        case, (2, 256, 256, 4, 1, 64, [0, 0], True, None))
    gen = torch.Generator(device=dev).manual_seed(len(case))

    def planes(L, *shape):
        return torch.randint(-64, 65, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    qm, km = planes(2, B, Sq, KV, G, hd), planes(2, B, Sk, KV, hd)
    vm = planes(2, B, Sk, KV, hd)
    qo = torch.tensor(off, dtype=torch.int32, device=dev)
    exps = torch.tensor([-11, -10, -8], dtype=torch.int32, device=dev)
    kw = dict(p_bits=12, causal=causal, window=window, sc=1.0 / hd ** 0.5,
              integer_exp=True)
    o, lse = ia.int_attn_fwd(qm, km, vm, qo, exps, **kw)
    o0, lse0 = ia.int_attn_fwd_plain(qm, km, vm, qo, exps, **kw)
    assert (o - o0).abs().max() <= 1e-5 * o0.abs().max()
    assert (lse - lse0).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case,integer_exp", [
    (c, True) for c in sorted(ATTN_BWD)] + [("hd256_gqa2", True),
                                           ("hd256_gqa2", False)])
def test_int_attn_bwd_integer_exp_and_hd256(dev, case, integer_exp):
    """The kept-int body of dq / dkv, and the 8-chunk body (head dim 256),
    at the int8 preset's limb counts: bit for bit."""
    B, Sq, Sk, KV, G, hd, off, causal, window = ATTN_BWD.get(
        case, (2, 200, 200, 2, 2, 256, [0, 0], True, None))
    gen = torch.Generator(device=dev).manual_seed(len(case))

    def planes(L, *shape):
        return torch.randint(-64, 65, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    qm, km = planes(2, B, Sq, KV, G, hd), planes(2, B, Sk, KV, hd)
    vm, gm = planes(2, B, Sk, KV, hd), planes(1, B, Sq, KV, G, hd)
    qo = torch.tensor(off, dtype=torch.int32, device=dev)
    exps = torch.tensor([-11, -10, -8, -12, -13], dtype=torch.int32,
                        device=dev)
    sc = 1.0 / hd ** 0.5
    _, lse = ia.int_attn_fwd_plain(qm, km, vm, qo, exps[:3], p_bits=12,
                                   causal=causal, window=window, sc=sc,
                                   integer_exp=integer_exp)
    delta = 0.05 * torch.randn((B, Sq, KV, G), generator=gen, device=dev)
    kw = dict(ds_bits=8, causal=causal, window=window, sc=sc,
              integer_exp=integer_exp)
    dq = ia.int_attn_bwd_dq(qm, km, vm, gm, lse, delta, qo, exps,
                            p_bits=12, **kw)
    dk, dv = ia.int_attn_bwd_dkv(qm, km, vm, gm, lse, delta, qo, exps,
                                 p_bits=12, **kw)
    dq0 = ia.int_attn_bwd_dq_plain(qm, km, vm, gm, lse, delta, qo, exps,
                                   **kw)
    dk0, dv0 = ia.int_attn_bwd_dkv_plain(qm, km, vm, gm, lse, delta, qo,
                                         exps, p_bits=12, **kw)
    for got, ref in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert ref.abs().max() > 0
        assert torch.equal(got, ref)


ATTN_MMA = {
    # name: (B, Sq, Sk, KV, G, hd, offsets, causal, window, planes q/k, v)
    "train_shape": (2, 256, 256, 4, 1, 64, [0, 0], True, None, 2, 2),
    "smollm_gqa3": (2, 256, 256, 3, 3, 64, [0, 0], True, None, 2, 2),
    "ragged_window": (2, 20, 150, 2, 2, 16, [100, 37], True, 40, 2, 2),
    "hd128": (1, 256, 256, 4, 1, 128, [0], True, None, 2, 2),
    "hd256_3limbs": (1, 64, 200, 2, 1, 256, [136], True, None, 3, 3),
    "hd384": (1, 64, 200, 2, 2, 384, [136], True, None, 2, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTN_MMA))
@pytest.mark.parametrize("integer_exp", [False, True])
def test_int_attn_fwd_mma(dev, case, integer_exp):
    """The tensor-core forward (the staged body; the direct one at head
    dim 384 and at head dim 256 with 3 limbs), both exp bodies: within 1e-5
    of max|o| and 1e-4 on lse, as the tests above."""
    B, Sq, Sk, KV, G, hd, off, causal, window, lqk, lv = ATTN_MMA[case]
    gen = torch.Generator(device=dev).manual_seed(len(case) + integer_exp)

    def planes(L, *shape):
        return torch.randint(-64, 65, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    qm, km = planes(lqk, B, Sq, KV, G, hd), planes(lqk, B, Sk, KV, hd)
    vm = planes(lv, B, Sk, KV, hd)
    qo = torch.tensor(off, dtype=torch.int32, device=dev)
    exps = torch.tensor([-11, -10, -8], dtype=torch.int32, device=dev)
    kw = dict(p_bits=12 if lv == 2 else 16, causal=causal, window=window,
              sc=1.0 / hd ** 0.5, integer_exp=integer_exp)
    o, lse = ia.int_attn_fwd(qm, km, vm, qo, exps, **kw)
    o0, lse0 = ia.int_attn_fwd_plain(qm, km, vm, qo, exps, **kw)
    assert o0.abs().max() > 0
    assert (o - o0).abs().max() <= 1e-5 * o0.abs().max()
    assert (lse - lse0).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("hd,lqk,lpv,lg,ds_bits,pb", [
    (288, 2, 2, 1, 8, 12), (384, 2, 2, 1, 8, 12), (384, 2, 2, 2, 12, 12),
    (256, 3, 3, 3, 16, 16), (200, 3, 3, 3, 16, 16)])
def test_int_attn_bwd_any_head_dim(dev, hd, lqk, lpv, lg, ds_bits, pb):
    """dq / dkv past the staged bodies' shared memory (the direct body: hd
    > 256, or 3-limb operands at 128 < hd <= 256): bit for bit, GQA and a
    ragged causal edge."""
    B, Sq, Sk, KV, G, off = 2, 72, 150, 1, 2, [78, 0]
    gen = torch.Generator(device=dev).manual_seed(hd + lg)

    def planes(L, *shape):
        return torch.randint(-64, 65, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    qm, km = planes(lqk, B, Sq, KV, G, hd), planes(lqk, B, Sk, KV, hd)
    vm, gm = planes(lpv, B, Sk, KV, hd), planes(lg, B, Sq, KV, G, hd)
    qo = torch.tensor(off, dtype=torch.int32, device=dev)
    exps = torch.tensor([-11, -10, -8, -12, -13], dtype=torch.int32,
                        device=dev)
    sc = 1.0 / hd ** 0.5
    _, lse = ia.int_attn_fwd_plain(qm, km, vm, qo, exps[:3], p_bits=pb,
                                   causal=True, window=None, sc=sc)
    delta = 0.05 * torch.randn((B, Sq, KV, G), generator=gen, device=dev)
    kw = dict(ds_bits=ds_bits, causal=True, window=None, sc=sc)
    dq = ia.int_attn_bwd_dq(qm, km, vm, gm, lse, delta, qo, exps,
                            p_bits=pb, **kw)
    dk, dv = ia.int_attn_bwd_dkv(qm, km, vm, gm, lse, delta, qo, exps,
                                 p_bits=pb, **kw)
    dq0 = ia.int_attn_bwd_dq_plain(qm, km, vm, gm, lse, delta, qo, exps,
                                   **kw)
    dk0, dv0 = ia.int_attn_bwd_dkv_plain(qm, km, vm, gm, lse, delta, qo,
                                         exps, p_bits=pb, **kw)
    for got, ref in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert ref.abs().max() > 0
        assert torch.equal(got, ref)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain versions (no build, no card)."""
    x = torch.randn(5, 6)
    exp = dfx.scale_exponent(x) - 7
    assert torch.equal(dfx_quant.dfx_quantize(x, exp, bits=8),
                       dfx_quant.dfx_quantize_plain(x, exp, bits=8))
