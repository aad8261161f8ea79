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
The wgmma matmul body (one CUDA body behind all six matmul
wrappers) bit for bit at the qwen1.5-0.5b training shapes, every limb pair
in every layout (NN with W N- or K-major, NT, TN, and batched at E = 60 x
16 rows and E = 1), decode-sized and tile-straddling row counts, ragged K
(not a multiple of 16, nor of 4: the threads' staging instead of TMA) and
N (not a multiple of 8), full-range planes, and int32 sums that wrap past 2^31
(no saturation).
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


#: the matmul layouts: NN (W N-major, a linear layer; K-major, the tied
#: head), NT (dX) and TN (dW); a case (M, K, N) is out (M, N) contracting K
MM_LAYOUTS = ("nn", "nn_wk", "nt", "tn")


def _mm_planes(gen, dev, L, *shape, full=False):
    """L int8 limb planes: digits in [-64, 64], or full range — ±127 for one
    plane, digits in [-64, 63] under a final carry plane in [-64, 64] — with
    the extremes present."""
    if not full:
        return torch.randint(-64, 65, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    if L == 1:
        p = torch.randint(-127, 128, (1,) + shape, generator=gen, device=dev)
        p[0, :1], p[0, -1:] = 127, -127
    else:
        p = torch.randint(-64, 64, (L,) + shape, generator=gen, device=dev)
        p[-1] = torch.randint(-64, 65, shape, generator=gen, device=dev)
        p[:, :1], p[:, -1:] = 63, -64
        p[-1, :1], p[-1, -1:] = 64, -64
    return p.to(torch.int8)


def _mm_case(dev, layout, M, K, N, lx, lw, seed, full=False):
    """(kernel, plain) outputs of one wrapper call: out (M, N), contraction
    K, lx planes of the left operand and lw of the right."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    e = torch.tensor(-23, dtype=torch.int32, device=dev)

    def pl(L, *s):
        return _mm_planes(gen, dev, L, *s, full=full)
    if layout == "nn":
        a, b = pl(lx, M, K), pl(lw, K, N)
        fn, plain = bm.bfp_matmul, bm.bfp_matmul_plain
    elif layout == "nn_wk":
        a, b = pl(lx, M, K), pl(lw, N, K).transpose(1, 2)
        fn, plain = bm.bfp_matmul, bm.bfp_matmul_plain
    elif layout == "nt":
        a, b = pl(lx, M, K), pl(lw, N, K)
        fn, plain = bm.bfp_matmul_nt, bm.bfp_matmul_nt_plain
    else:
        a, b = pl(lx, K, M), pl(lw, K, N)
        fn, plain = bm.bfp_matmul_tn, bm.bfp_matmul_tn_plain
    got, ref = fn(a, b, e), plain(a, b, e)
    assert got.shape == (M, N) and ref.abs().max() > 0
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("layout,lx,lw", [("nn", 2, 1), ("nt", 1, 1),
                                          ("tn", 2, 1), ("nn_wk", 2, 1)])
def test_bfp_matmul_qwen_training_shapes(dev, layout, lx, lw):
    """qwen1.5-0.5b's MLP products at batch 8 x seq 256: the up-projection
    2048 x 1024 x 2816 (a12 x w8), its dX 2048 x 2816 -> 1024 (g8 x w8) and
    its dW 1024 x 2048 -> 2816 (a12 x g8)."""
    M, K, N = {"nt": (2048, 2816, 1024),
               "tn": (1024, 2048, 2816)}.get(layout, (2048, 1024, 2816))
    assert torch.equal(*_mm_case(dev, layout, M, K, N, lx, lw, seed=1))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MM_LAYOUTS)
@pytest.mark.parametrize("lx,lw", [(a, b) for a in (1, 2, 3)
                                   for b in (1, 2, 3)])
def test_bfp_matmul_every_limb_pair(dev, layout, lx, lw):
    """Each of the nine instantiations per layout (tile width 128, 64 or 32
    by the pair count), at an aligned shape and a ragged one."""
    for M, K, N in ((200, 384, 320), (65, 130, 61)):
        assert torch.equal(*_mm_case(dev, layout, M, K, N, lx, lw,
                                     seed=10 * lx + lw))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MM_LAYOUTS)
@pytest.mark.parametrize("M", [1, 4, 16, 17, 63, 65, 129])
def test_bfp_matmul_rows(dev, layout, M):
    """Row counts around the tile: one consumer warpgroup (M <= 64), two,
    and partial tiles of each."""
    assert torch.equal(*_mm_case(dev, layout, M, 1024, 1408, 2, 1, seed=M))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MM_LAYOUTS)
@pytest.mark.parametrize("K,N", [(40, 200), (61, 77), (130, 203), (2, 5),
                                 (1000, 1004)])
def test_bfp_matmul_ragged(dev, layout, K, N):
    """K not a multiple of 16 (no TMA) nor of 4 (byte loads), N not a
    multiple of 8 (a partial MMA column block, odd rows)."""
    assert torch.equal(*_mm_case(dev, layout, 96, K, N, 2, 1, seed=K + N))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MM_LAYOUTS)
@pytest.mark.parametrize("lx,lw", [(1, 1), (2, 1), (3, 3)])
def test_bfp_matmul_full_range(dev, layout, lx, lw):
    """Full-range planes: ±127 mantissas, ±64 carries."""
    assert torch.equal(*_mm_case(dev, layout, 130, 3072, 768, lx, lw,
                                 seed=lx + lw, full=True))


@pytest.mark.cuda
def test_bfp_matmul_int32_wraps(dev):
    """Past 2^31 the int32 sums wrap (no saturation): 140,000 terms of
    127 x 127 in the tied head's layout, whose dX contracts 152,064."""
    K = 140_000
    x = torch.full((1, 4, K), 127, dtype=torch.int8, device=dev)
    w = torch.full((1, 8, K), 127, dtype=torch.int8, device=dev)
    e = torch.tensor(-30, dtype=torch.int32, device=dev)
    got = bm.bfp_matmul(x, w.transpose(1, 2), e)
    acc = (K * 127 * 127 + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert acc < 0
    assert torch.equal(got, torch.full((4, 8), float(acc) * 2.0 ** -30,
                                       device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("E,M", [(60, 16), (1, 256)])
@pytest.mark.parametrize("lx,lw", [(a, b) for a in (1, 2, 3)
                                   for b in (1, 2, 3)])
def test_bfp_matmul_batched_every_limb_pair(dev, E, M, lx, lw):
    """Batched NN, NT and TN at every limb pair: the MoE decode (60 experts
    x 16 rows) and one expert of 256 rows, per-expert exponents."""
    K, N = 2048, 1408
    gen = torch.Generator(device=dev).manual_seed(E * lx + lw)
    e = torch.arange(E, dtype=torch.int32, device=dev) - 30
    xm, wm = _mm_planes(gen, dev, lx, E, M, K), _mm_planes(gen, dev, lw, E, K, N)
    gm = _mm_planes(gen, dev, lx, E, M, N)
    gt = _mm_planes(gen, dev, lw, E, M, N)
    assert torch.equal(bm.bfp_matmul_batched(xm, wm, e),
                       bm.bfp_matmul_batched_plain(xm, wm, e))
    assert torch.equal(bm.bfp_matmul_batched_nt(gm, wm, e),
                       bm.bfp_matmul_batched_nt_plain(gm, wm, e))
    assert torch.equal(bm.bfp_matmul_batched_tn(xm, gt, e),
                       bm.bfp_matmul_batched_tn_plain(xm, gt, e))


#: backward shapes (R, D, unaligned): the main paths' (bert-base 4096 x
#: 768 and its span step 4608 x 768; qwen 2048 x 1024, qwen2-moe 2048 x
#: 2048, smollm 2048 x 576), D not a multiple of the 8-column unit, one
#: row, no rows, and views whose base is one element off the allocation's
#: (at D = 7, and at a main-path width, which then takes the any-shape body)
NORM_BWD_LN = ((4096, 768, False), (4608, 768, False), (37, 1000, False),
               (1, 7, False), (0, 7, False), (8, 7, True), (6, 768, True))
NORM_BWD_RMS = ((2048, 1024, False), (2048, 2048, False), (2048, 576, False),
                (37, 1000, False), (1, 7, False), (0, 7, False), (8, 7, True),
                (6, 1024, True))


def _mantissas(gen, dev, R, D, lim, dtype, unaligned):
    """(R, D) mantissas in [-lim, lim]; ``unaligned``: a view whose base
    sits one element past its allocation's."""
    m = torch.randint(-lim, lim + 1, (R * D + unaligned,), generator=gen,
                      device=dev).to(dtype)
    return m[int(unaligned):].view(R, D)


def _twice(fn, *args):
    """The kernel's outputs, after checking that a second call on the same
    inputs gives the same bits."""
    a, b = fn(*args), fn(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("xt,xlim,gt,glim", [
    (torch.int16, 2047, torch.int8, 127), (torch.int8, 127, torch.int8, 127),
    (torch.int16, 32767, torch.int16, 32767),
    (torch.int8, 127, torch.int16, 32767)])
def test_int_layernorm(dev, xt, xlim, gt, glim):
    gen = torch.Generator(device=dev).manual_seed(xlim + glim)
    for R, D, unaligned in NORM_BWD_LN:
        xm = _mantissas(gen, dev, R, D, xlim, xt, unaligned)
        if R:
            xm[0] = xm[0, 0]                      # variance clamped at 0
        gm = _mantissas(gen, dev, R, D, glim, gt, unaligned)
        gamma = 1 + 0.2 * torch.randn((D,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((D,), generator=gen, device=dev)
        xe = torch.tensor(-10, dtype=torch.int32, device=dev)
        ge = torch.tensor(-20, dtype=torch.int32, device=dev)
        y0, mu0, r0 = int_norm.int_layernorm_fwd_plain(xm, xe, gamma, beta)
        if R:
            y, mu, r = int_norm.int_layernorm_fwd(xm, xe, gamma, beta)
            torch.testing.assert_close(mu, mu0, rtol=2 * ULP, atol=1e-30)
            torch.testing.assert_close(r, r0, rtol=4 * ULP, atol=0)
            xn = ((xm.float() * 2.0 ** -10 - mu0) * r0 * gamma).abs()
            bound = (8 * ULP * y0.abs().amax(-1, keepdim=True)
                     + ((r - r0).abs() / r0) * xn.amax(-1, keepdim=True))
            assert ((y - y0).abs() <= bound + 1e-30).all()
        dx, dg, db = _twice(int_norm.int_layernorm_bwd, xm, gm, xe, ge, gamma,
                            mu0, r0)
        dx0, dg0, db0 = int_norm.int_layernorm_bwd_plain(xm, gm, xe, ge,
                                                         gamma, mu0, r0)
        assert torch.equal(db, db0)
        row = dx0.abs().amax(-1, keepdim=True) if R else dx0
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
    (torch.int16, 32767, torch.int16, 32767),
    (torch.int8, 127, torch.int16, 32767)])
def test_int_rmsnorm_bwd(dev, xt, xlim, gt, glim):
    gen = torch.Generator(device=dev).manual_seed(xlim + 3 * glim)
    for R, D, unaligned in NORM_BWD_RMS:
        xm = _mantissas(gen, dev, R, D, xlim, xt, unaligned)
        gm = _mantissas(gen, dev, R, D, glim, gt, unaligned)
        gamma = 1 + 0.2 * torch.randn((D,), generator=gen, device=dev)
        xe = torch.tensor(-10, dtype=torch.int32, device=dev)
        ge = torch.tensor(-20, dtype=torch.int32, device=dev)
        _, r0 = int_norm.int_rmsnorm_fwd_plain(xm, xe, gamma)
        dx, dg = _twice(int_norm.int_rmsnorm_bwd, xm, gm, xe, ge, gamma, r0)
        dx0, dg0 = int_norm.int_rmsnorm_bwd_plain(xm, gm, xe, ge, gamma, r0)
        row = dx0.abs().amax(-1, keepdim=True) if R else dx0
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
@pytest.mark.parametrize("bits", [8, 16])
def test_dfx_quantize_grouped_past_grid_y(dev, bits):
    """E = 70,000 slices, more than ``gridDim.y`` takes (65,535): a block
    walks several slices (the quantized moments of a 151,936-row
    embedding), each at its own exponent, slice 65,600 all zero."""
    gen = torch.Generator(device=dev).manual_seed(bits)
    E, M, N = 70_000, 1, 96
    x = torch.randn((E, M, N), generator=gen, device=dev)
    x *= 2.0 ** (torch.arange(E, device=dev) % 24 - 12)[:, None, None]
    x[65_600] = 0
    u = torch.rand((E, M, N), generator=gen, device=dev)
    exp = dfx.slice_exponents(x) - (bits - 1)
    for kw in (dict(), dict(u=u, limb_planes=True)):
        got = dfx_quant.dfx_quantize_grouped(x, exp, bits=bits, **kw)
        ref = dfx_quant.dfx_quantize_grouped_plain(x, exp, bits=bits, **kw)
        assert torch.equal(got, ref), kw


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
