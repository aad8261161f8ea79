#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (each raises on failure; nothing is caught):

1. Print the card (``nvidia-smi`` name and power limit); build the CUDA
   kernels from ``src/repro_torch/csrc`` and print the build seconds and
   the ``ptxas`` register / shared-memory report.
2. For each ported kernel, at the shapes its main path gives it (the
   qwen1.5-0.5b serving path for the forward kernels, the bert-base
   fine-tuning step — batch 32 x seq 128 — for the backward matmuls and
   the layer-norm kernels, and for the quantize and NN matmul kernels
   also the step's gradient quantize and w1 forward; the qwen1.5-0.5b
   training step — batch 8 x seq 256 — for the RMS-norm backward, and it,
   bert-base cls, smollm-135m's GQA and a ragged windowed case for the
   attention backward): run the kernel and its plain PyTorch version
   on the card from the same seeded inputs and hold them together (integer
   outputs and the matmuls exactly, other f32 outputs within the stated
   tolerance); time kernel, plain version and a one-call PyTorch yardstick
   with CUDA events (median); compute the card's lower bound from the
   bytes and the operations this call needs.
3. On reduced configurations (2 layers), from the same weights, the card
   against the port's CPU path: qwen1.5-0.5b's served logits; one BERT
   training step under the paper's integer scope (round to nearest), its
   loss and every parameter's gradient, for the cls and span heads, and
   for cls under the plain int8 preset; one ``lm_loss`` step of
   qwen1.5-0.5b and of smollm-135m under int8.
4. Serve qwen1.5-0.5b at full width (24 layers, d_model 1024, vocab
   151936), int8 (w8·a12), random weights from a seeded generator: 4 slots,
   max_seq 256, 8 requests of 64-token prompts, 16 new tokens each, through
   ``ContinuousBatcher.run_until_drained``.  Every launch counter is set to
   0 just before and read just after; every kernel of the path must have
   launched.  Prints tokens/s, peak memory and the launches of one decode
   step.
5. Fine-tune bert-base at full width (12 layers, d_model 768, d_ff 3072,
   vocab 30522) through ``train.finetune.finetune`` under the paper's
   integer scope (int8 linear / layer-norm / embedding, attention FP32)
   with stochastic gradient rounding from a seeded CUDA generator, AdamW at
   lr 1e-4: 10 steps of the cls proxy (batch 32 x seq 128) and 4 of the
   span proxy (batch 12 x seq 384), launch counters set to 0 just before
   each run and read just after; every kernel of the path must have
   launched and every loss be finite.  Prints the losses (and the FP32
   preset's from the same init), the median time of the steps after the
   first (step 0 also holds the set-up), tokens/s over those steps, peak
   memory, the launches of one step and a profiled step's device-busy
   share.  Also cls under the plain int8 preset (integer attention forward
   and backward), its losses printed beside the paper-scope and FP32 ones.
6. Train qwen1.5-0.5b at full width through the port's training launcher
   (``launch.train``): int8, batch 8 x seq 256, 6 AdamW steps at lr 1e-4,
   launch counters set to 0 just before and read just after; every kernel
   of the path must have launched (RMS-norm and attention backward
   included), every loss be finite and the first near ln 151936.  Prints
   the median step time of steps 1.., tokens/s, peak memory, the launches
   of one step, a profiled step's device-busy share and the FP32 losses
   from the same init.
7. Print the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is available or when
the script is not inside a checkout of the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 tensor
#: ops/s, float32 ops/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn()`` in ms: the summed duration of the kernels and
    copies it runs (torch.profiler), per call — the host time between
    launches, which ``cuda_ms`` includes for small kernels, left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def timings(kernel, plain, library=None) -> dict:
    """CUDA-event medians and profiler device times of the kernel's wrapper
    call, its plain version and the library yardstick."""
    return dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library) if library else None,
                device_ms=device_ms(kernel), plain_device_ms=device_ms(plain),
                library_device_ms=device_ms(library) if library else None)


def bound_ms(n_bytes: float, n_ops: float, f32_ops: float = 0.0) -> tuple:
    """Least time the card could take: max(bytes / HBM rate, int8 ops /
    int8 tensor rate + f32 ops / f32 rate), and which of the two bounds
    it."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = (n_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_quantize(torch, dev, gen, V, D, tokens, F):
    """dfx_quantize at the path's largest call: the whole embedding table
    (V, D) f32 -> int8 mantissas, re-quantized on every serving step.  Also
    held exactly at the fine-tuning step's largest gradient quantize: w1's
    upstream gradient (tokens x F) f32 at 8 bits, rounded stochastically
    (``u`` from the CUDA generator) into limb planes; that call is timed
    too (``grad_*`` keys)."""
    from repro_torch.core import dfx
    from repro_torch.kernels import dfx_quant
    table = torch.randn((V, D), generator=gen, device=dev) * 0.02
    exp = dfx.scale_exponent(table) - 7
    grad = torch.randn((tokens, F), generator=gen, device=dev) * 1e-6
    u_grad = torch.rand((tokens, F), generator=gen, device=dev)
    act = torch.randn((256, 2816), generator=gen, device=dev)
    cases = [(table, 8, False, None),            # int_embedding table
             (table, 8, True, None),             # tied head's planes
             (act, 12, True, None),              # a12 activation planes
             (act, 12, False, torch.rand((256, 2816), generator=gen,
                                         device=dev)),
             (grad, 8, True, u_grad)]            # g8 gradient planes, SR
    err = 0.0
    for x, bits, limbs, u in cases:
        e = dfx.scale_exponent(x) - (bits - 1)
        got = dfx_quant.dfx_quantize(x, e, bits=bits, u=u, limb_planes=limbs)
        ref = dfx_quant.dfx_quantize_plain(x, e, bits=bits, u=u,
                                           limb_planes=limbs)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"dfx_quantize differs from its plain version at "
                f"{tuple(x.shape)} bits={bits} limb_planes={limbs} "
                f"stochastic={u is not None}")
        err = max(err, (got.float() - ref.float()).abs().max().item())
    ge = dfx.scale_exponent(grad) - 7
    grad_q = dfx_quant.dfx_quantize(grad, ge, bits=8, u=u_grad,
                                    limb_planes=True)
    grad_ms = device_ms(lambda: dfx_quant.dfx_quantize(
        grad, ge, bits=8, u=u_grad, limb_planes=True))
    grad_b, _ = bound_ms(nbytes(grad, u_grad, grad_q), 0)
    out = torch.empty((V, D), dtype=torch.int8, device=dev)
    # yardstick: PyTorch's per-tensor int8 quantize at the same power-of-two
    # scale (round half to even; it clamps at -128 where the kernel clamps
    # at -127)
    scale = float(dfx.pow2(exp))
    t = timings(lambda: dfx_quant.dfx_quantize(table, exp, bits=8),
                lambda: dfx_quant.dfx_quantize_plain(table, exp, bits=8),
                lambda: torch.quantize_per_tensor(table, scale, 0,
                                                  torch.qint8))
    b, by = bound_ms(nbytes(table, out), 0)
    print(f"  dfx_quantize gradient ({tokens},{F}) f32 -> 8-bit planes, "
          f"stochastic: device {grad_ms:.4f} ms, bound {grad_b:.4f} ms "
          "(bytes)")
    return dict(name="dfx_quantize", route="cuda",
                source="src/repro_torch/csrc/dfx_quant.cu",
                replaces="src/repro/kernels/dfx_quant.py:115",
                shape=f"x ({V},{D}) f32 -> int8, tolerance exact (also held "
                      f"exactly: ({tokens},{F}) f32 gradient -> 8-bit planes "
                      "with u); library: torch.quantize_per_tensor to qint8",
                max_abs_err=err, bound_ms=b, bound_by=by,
                grad_device_ms=grad_ms, grad_bound_ms=grad_b, **t)


def _planes(torch, gen, dev, L, *shape):
    return torch.randint(-64, 64, (L,) + shape, generator=gen, device=dev,
                         dtype=torch.int8)


def check_matmul(torch, dev, gen, cfg, V, bert, tokens):
    """bfp_matmul at the path's shapes: the decode head (4 x 1024 x 152064,
    W K-major), a decode and a prefill linear, and the bert-base
    fine-tuning step's w1 forward (tokens x 768 x 3072, 2x1 limbs); timed
    at the prefill MLP up-projection (256 x 1024 x 2816, 2x1 limbs), the
    head and w1."""
    from repro_torch.kernels import bfp_matmul as bm
    D, F = cfg.d_model, cfg.d_ff
    exp = torch.tensor(-19, dtype=torch.int32, device=dev)
    head_w = _planes(torch, gen, dev, 1, V, D).transpose(1, 2)
    cases = [(_planes(torch, gen, dev, 2, 4, D), head_w),
             (_planes(torch, gen, dev, 2, 4, D), _planes(torch, gen, dev, 1, D, 3 * D)),
             (_planes(torch, gen, dev, 2, 256, F), _planes(torch, gen, dev, 1, F, D)),
             (_planes(torch, gen, dev, 2, 256, D), _planes(torch, gen, dev, 1, D, F)),
             (_planes(torch, gen, dev, 2, tokens, bert.d_model),
              _planes(torch, gen, dev, 1, bert.d_model, bert.d_ff))]
    err = 0.0
    for xm, wm in cases:
        got, ref = bm.bfp_matmul(xm, wm, exp), bm.bfp_matmul_plain(xm, wm, exp)
        if not torch.equal(got, ref):
            raise AssertionError(f"bfp_matmul differs from its plain version "
                                 f"at {tuple(xm.shape)} x {tuple(wm.shape)}: "
                                 f"{(got - ref).abs().max().item()}")
        err = max(err, (got - ref).abs().max().item())
    xm, wm = cases[3]
    M, K, N = xm.shape[1], xm.shape[2], wm.shape[2]
    out = torch.empty((M, N), device=dev)
    x0, w0 = xm[0].contiguous(), wm[0].contiguous()
    t = timings(lambda: bm.bfp_matmul(xm, wm, exp),
                lambda: bm.bfp_matmul_plain(xm, wm, exp),
                lambda: torch._int_mm(x0, w0))
    b, by = bound_ms(nbytes(xm, wm, out), 2 * M * K * N * xm.shape[0])
    hx, hw = cases[0]
    head_ms = cuda_ms(lambda: bm.bfp_matmul(hx, hw, exp))
    head_dev = device_ms(lambda: bm.bfp_matmul(hx, hw, exp))
    head_b, head_by = bound_ms(nbytes(hx, hw) + 4 * 4 * V, 2 * 4 * D * V * 2)
    print(f"  bfp_matmul decode head 4x{D}x{V} (2x1 limbs, W K-major): "
          f"{head_ms:.4f} ms (device {head_dev:.4f}), bound {head_b:.4f} ms "
          f"({head_by})")
    wx, ww = cases[4]
    w1_dev = device_ms(lambda: bm.bfp_matmul(wx, ww, exp))
    w1_b, w1_by = bound_ms(nbytes(wx, ww) + 4 * tokens * bert.d_ff,
                           2 * tokens * bert.d_model * bert.d_ff * 2)
    print(f"  bfp_matmul bert-base w1 forward {tokens}x{bert.d_model}x"
          f"{bert.d_ff} (2x1 limbs): device {w1_dev:.4f} ms, bound "
          f"{w1_b:.4f} ms ({w1_by})")
    return dict(name="bfp_matmul", route="cuda",
                source="src/repro_torch/csrc/bfp_matmul.cu",
                replaces="src/repro/kernels/bfp_matmul.py:147",
                shape=f"({M},{K})x({K},{N}), 2x1 limbs, tolerance exact (also "
                      f"held exactly: decode head, a decode linear, w1 "
                      f"forward ({tokens},{bert.d_model})x({bert.d_model},"
                      f"{bert.d_ff})); library: torch._int_mm of one limb "
                      "pair",
                max_abs_err=err, bound_ms=b, bound_by=by, head_ms=head_ms,
                head_device_ms=head_dev, head_bound_ms=head_b,
                w1_device_ms=w1_dev, w1_bound_ms=w1_b, **t)


def check_rmsnorm(torch, dev, gen, D):
    """int_rmsnorm_fwd at prefill: 256 rows (4 slots x 64 tokens) of int16
    mantissas at a12."""
    import torch.nn.functional as F
    from repro_torch.core import dfx
    from repro_torch.kernels import int_norm
    R = 256
    xm = torch.randint(-2047, 2048, (R, D), generator=gen, device=dev,
                       dtype=torch.int16)
    exp = torch.tensor(-9, dtype=torch.int32, device=dev)
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    y, rstd = int_norm.int_rmsnorm_fwd(xm, exp, gamma)
    y0, rstd0 = int_norm.int_rmsnorm_fwd_plain(xm, exp, gamma)
    rel = max(((y - y0).abs().max() / y0.abs().max()).item(),
              ((rstd - rstd0).abs().max() / rstd0.abs().max()).item())
    if rel > 1e-6:
        raise AssertionError(f"int_rmsnorm_fwd differs: rel {rel}")
    xv = xm.float() * dfx.pow2(exp)
    t = timings(lambda: int_norm.int_rmsnorm_fwd(xm, exp, gamma),
                lambda: int_norm.int_rmsnorm_fwd_plain(xm, exp, gamma),
                lambda: F.rms_norm(xv, (D,), gamma, 1e-6))
    b, by = bound_ms(nbytes(xm, gamma, y, rstd), 0)
    return dict(name="int_rmsnorm_fwd", route="cuda",
                source="src/repro_torch/csrc/int_norm.cu",
                replaces="src/repro/kernels/int_norm.py:246",
                shape=f"({R},{D}) int16, tolerance 1e-6 relative",
                max_abs_err=(y - y0).abs().max().item(), bound_ms=b,
                bound_by=by, **t)


def check_attention(torch, dev, gen, cfg):
    """int_attn_fwd at decode (4 slots, one query each at positions 64..67,
    over the 256-deep cache) and at prefill (64 queries from position 0);
    timed at decode."""
    import torch.nn.functional as F
    from repro_torch.core import dfx
    from repro_torch.kernels import int_attention as ia
    B, KV, G, hd, Smax = 4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.head_dim, 256
    exps = torch.tensor([-9, -9, -8], dtype=torch.int32, device=dev)
    sc = 1.0 / hd ** 0.5
    k = _planes(torch, gen, dev, 2, B, Smax, KV, hd)
    v = _planes(torch, gen, dev, 2, B, Smax, KV, hd)
    err = 0.0
    timed = None
    for Sq, off in ((1, [64, 65, 66, 67]), (64, [0, 0, 0, 0])):
        q = _planes(torch, gen, dev, 2, B, Sq, KV, G, hd)
        qo = torch.tensor(off, dtype=torch.int32, device=dev)
        o, lse = ia.int_attn_fwd(q, k, v, qo, exps, p_bits=12, causal=True,
                                 window=None, sc=sc)
        o0, lse0 = ia.int_attn_fwd_plain(q, k, v, qo, exps, p_bits=12,
                                         causal=True, window=None, sc=sc)
        rel = ((o - o0).abs().max() / o0.abs().max()).item()
        dl = (lse - lse0).abs().max().item()
        if rel > 1e-5 or dl > 1e-4:
            raise AssertionError(f"int_attn_fwd differs at Sq={Sq}: o rel "
                                 f"{rel}, lse abs {dl}")
        err = max(err, (o - o0).abs().max().item())
        if timed is None:
            timed = (q, qo, o, lse)
    q, qo, o, lse = timed
    # yardstick: SDPA on the dequantized f32 values with the same mask
    qd = (q[0].float() + 128 * q[1].float()) * dfx.pow2(exps[0])
    kd = (k[0].float() + 128 * k[1].float()) * dfx.pow2(exps[1])
    vd = (v[0].float() + 128 * v[1].float()) * dfx.pow2(exps[2])
    qs = qd.reshape(B, 1, KV * G, hd).transpose(1, 2)
    ks = kd.repeat_interleave(G, dim=2).transpose(1, 2)
    vs = vd.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (torch.arange(Smax, device=dev) <= qo[:, None])[:, None, None, :]
    kw = dict(p_bits=12, causal=True, window=None, sc=sc)
    t = timings(lambda: ia.int_attn_fwd(q, k, v, qo, exps, **kw),
                lambda: ia.int_attn_fwd_plain(q, k, v, qo, exps, **kw),
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       attn_mask=mask))
    # bytes and int8 ops the data needs: keys 0..q_off[b] of each row
    need = sum(int(x) + 1 for x in qo.cpu())
    n_bytes = (nbytes(q, qo, exps, o, lse)
               + (k.shape[0] + v.shape[0]) * need * KV * hd)
    n_ops = 2 * 2 * need * KV * G * hd * 4       # QK and PV, 2x2 limb pairs
    b, by = bound_ms(n_bytes, n_ops)
    return dict(name="int_attn_fwd", route="cuda",
                source="src/repro_torch/csrc/int_attention.cu",
                replaces="src/repro/kernels/int_attention.py:217",
                shape=f"decode q ({B},1,{KV},{G},{hd}) over k/v ({B},{Smax},"
                      f"{KV},{hd}), 2 limbs; tolerance o 1e-5 relative, lse "
                      "1e-4 absolute",
                max_abs_err=err, bound_ms=b, bound_by=by, **t)


def check_matmul_bwd(torch, dev, gen, cfg, tokens):
    """bfp_matmul_nt and bfp_matmul_tn at the bert-base fine-tuning step's
    shapes (``tokens`` = batch 32 x seq 128): w1's dX, G (4096x3072) ·
    W (768x3072)ᵀ with 1x1 limbs (g8, w8), and w1's dW, X (4096x768)ᵀ ·
    G (4096x3072) with 2x1 limbs (a12, g8); also the ragged products of
    the classifier head (N = 4) and the pooler (M = batch).  Timed at w1."""
    from repro_torch.kernels import bfp_matmul as bm
    D, F, B = cfg.d_model, cfg.d_ff, 32
    e = torch.tensor(-27, dtype=torch.int32, device=dev)
    g, w = _planes(torch, gen, dev, 1, tokens, F), _planes(torch, gen, dev, 1, D, F)
    x = _planes(torch, gen, dev, 2, tokens, D)
    gh, wh = _planes(torch, gen, dev, 1, B, 4), _planes(torch, gen, dev, 1, D, 4)
    xp = _planes(torch, gen, dev, 2, B, D)
    out = []
    for name, fn, plain, cases, lib_args in (
            ("bfp_matmul_nt", bm.bfp_matmul_nt, bm.bfp_matmul_nt_plain,
             [(g, w), (gh, wh), (xp[:1], _planes(torch, gen, dev, 1, D, D))],
             (g[0], w[0].t().contiguous())),
            ("bfp_matmul_tn", bm.bfp_matmul_tn, bm.bfp_matmul_tn_plain,
             [(x, g), (xp, gh), (xp, xp[:1])],
             (x[0].t().contiguous(), g[0]))):
        err = 0.0
        for a, b in cases:
            got, ref = fn(a, b, e), plain(a, b, e)
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"{name} differs from its plain version at "
                    f"{tuple(a.shape)} x {tuple(b.shape)}: "
                    f"{(got - ref).abs().max().item()}")
            err = max(err, (got - ref).abs().max().item())
        a, b = cases[0]
        res = fn(a, b, e)
        t = timings(lambda: fn(a, b, e), lambda: plain(a, b, e),
                    lambda: torch._int_mm(*lib_args))
        n_ops = 2 * tokens * D * F * a.shape[0] * b.shape[0]
        bd, by = bound_ms(nbytes(a, b, e, res), n_ops)
        what = ("dX: G (%d,%d) . W (%d,%d)^T, 1x1 limbs" % (tokens, F, D, F)
                if name == "bfp_matmul_nt" else
                "dW: X (%d,%d)^T . G (%d,%d), 2x1 limbs" % (tokens, D, tokens, F))
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/bfp_matmul.cu",
            replaces=("src/repro/kernels/bfp_matmul.py:176"
                      if name == "bfp_matmul_nt" else
                      "src/repro/kernels/bfp_matmul.py:210"),
            shape=f"{what}, tolerance exact; library: torch._int_mm of one "
                  "limb pair (operands made contiguous beforehand)",
            max_abs_err=err, bound_ms=bd, bound_by=by, **t))
    return out


def check_layernorm(torch, dev, gen, D, R):
    """int_layernorm_fwd / _bwd at the bert-base fine-tuning step's shape:
    R = 4096 rows (batch 32 x seq 128) of D = 768 int16 mantissas (a12),
    int8 gradient mantissas (g8).

    Tolerances: mu and rstd within 4 ulp and y within 1e-6 of max|y| (the
    plain version's division by D may be a reciprocal multiply on the
    card); dβ exactly (exact int sums); dx within 64 ulp of max|dx| and
    dγ within 64 ulp of the column's Σ|gq·xn| (f32 sums in another
    order)."""
    import torch.nn.functional as F
    from repro_torch.core import dfx
    from repro_torch.kernels import int_norm
    ulp = 2.0 ** -23
    xm = torch.randint(-2047, 2048, (R, D), generator=gen, device=dev,
                       dtype=torch.int16)
    gm = torch.randint(-127, 128, (R, D), generator=gen, device=dev,
                       dtype=torch.int8)
    xe = torch.tensor(-9, dtype=torch.int32, device=dev)
    ge = torch.tensor(-27, dtype=torch.int32, device=dev)
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    beta = 0.1 * torch.randn((D,), generator=gen, device=dev)
    y, mu, rstd = int_norm.int_layernorm_fwd(xm, xe, gamma, beta)
    y0, mu0, rstd0 = int_norm.int_layernorm_fwd_plain(xm, xe, gamma, beta)
    rel = max(((mu - mu0).abs() / mu0.abs().clamp(min=1e-30)).max().item(),
              ((rstd - rstd0).abs() / rstd0).max().item())
    ey = ((y - y0).abs().max() / y0.abs().max()).item()
    if rel > 4 * ulp or ey > 1e-6:
        raise AssertionError(f"int_layernorm_fwd differs: stats rel {rel}, "
                             f"y rel {ey}")
    dx, dg, db = int_norm.int_layernorm_bwd(xm, gm, xe, ge, gamma, mu0,
                                            rstd0)
    dx0, dg0, db0 = int_norm.int_layernorm_bwd_plain(xm, gm, xe, ge, gamma,
                                                     mu0, rstd0)
    xn = (xm.float() * dfx.pow2(xe) - mu0) * rstd0
    col = (gm.float() * dfx.pow2(ge) * xn).abs().sum(0)
    if (not torch.equal(db, db0)
            or (dx - dx0).abs().max() > 64 * ulp * dx0.abs().max()
            or ((dg - dg0).abs() > 64 * ulp * col).any()):
        raise AssertionError(
            f"int_layernorm_bwd differs: dx {(dx - dx0).abs().max().item()}"
            f", dgamma {(dg - dg0).abs().max().item()}, dbeta exact "
            f"{torch.equal(db, db0)}")
    xv = xm.float() * dfx.pow2(xe)
    gq = gm.float() * dfx.pow2(ge)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(xv, [D], gamma, beta,
                                                       1e-5)
    fwd = dict(name="int_layernorm_fwd", route="cuda",
               source="src/repro_torch/csrc/int_norm.cu",
               replaces="src/repro/kernels/int_norm.py:113",
               shape=f"({R},{D}) int16 -> y, mu, rstd; tolerance stats 4 ulp,"
                     " y 1e-6 of max; library: F.layer_norm on the f32 "
                     "values",
               max_abs_err=(y - y0).abs().max().item(),
               **timings(lambda: int_norm.int_layernorm_fwd(xm, xe, gamma,
                                                            beta),
                         lambda: int_norm.int_layernorm_fwd_plain(
                             xm, xe, gamma, beta),
                         lambda: F.layer_norm(xv, (D,), gamma, beta, 1e-5)))
    # per element: 4 digit-sum / moment int ops, then sub, 2 mul, mul, add
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        nbytes(xm, xe, gamma, beta, y, mu, rstd), 0, 9 * R * D)
    bwd = dict(name="int_layernorm_bwd", route="cuda",
               source="src/repro_torch/csrc/int_norm.cu",
               replaces="src/repro/kernels/int_norm.py:181",
               shape=f"({R},{D}) int16 x, int8 g -> dx, dgamma, dbeta; "
                     "tolerance dbeta exact, dx 64 ulp of max, dgamma 64 ulp "
                     "of the column's sum of |gq xn|; library: "
                     "aten.native_layer_norm_backward on the f32 values",
               max_abs_err=max((dx - dx0).abs().max().item(),
                               (dg - dg0).abs().max().item()),
               **timings(lambda: int_norm.int_layernorm_bwd(
                   xm, gm, xe, ge, gamma, mu0, rstd0),
                   lambda: int_norm.int_layernorm_bwd_plain(
                       xm, gm, xe, ge, gamma, mu0, rstd0),
                   lambda: torch.ops.aten.native_layer_norm_backward(
                       gq, xv, [D], lmean, lrstd, gamma, beta,
                       [True, True, True])))
    # per element: xn (3), gq, gg, two row sums (3), dx (4), dgamma (2)
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(
        nbytes(xm, gm, xe, ge, gamma, mu0, rstd0, dx, dg, db), 0,
        14 * R * D)
    return [fwd, bwd]


def check_rmsnorm_bwd(torch, dev, gen, R, D):
    """int_rmsnorm_bwd at the qwen1.5-0.5b training step's shape: R = 2048
    rows (batch 8 x seq 256) of D = 1024 int16 mantissas (a12), int8
    gradient mantissas (g8).  Tolerances: dx within 64 ulp of its row's
    max|dx|, dγ within 64 ulp of the column's Σ|gq·xn| (f32 sums in
    another order)."""
    import torch.nn.functional as F
    from repro_torch.core import dfx
    from repro_torch.kernels import int_norm
    ulp = 2.0 ** -23
    xm = torch.randint(-2047, 2048, (R, D), generator=gen, device=dev,
                       dtype=torch.int16)
    gm = torch.randint(-127, 128, (R, D), generator=gen, device=dev,
                       dtype=torch.int8)
    xe = torch.tensor(-9, dtype=torch.int32, device=dev)
    ge = torch.tensor(-27, dtype=torch.int32, device=dev)
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    _, rstd = int_norm.int_rmsnorm_fwd(xm, xe, gamma)
    dx, dg = int_norm.int_rmsnorm_bwd(xm, gm, xe, ge, gamma, rstd)
    dx0, dg0 = int_norm.int_rmsnorm_bwd_plain(xm, gm, xe, ge, gamma, rstd)
    xv = xm.float() * dfx.pow2(xe)
    gq = gm.float() * dfx.pow2(ge)
    col = (gq * xv * rstd).abs().sum(0)
    row = dx0.abs().amax(-1, keepdim=True)
    if (((dx - dx0).abs() > 64 * ulp * row).any()
            or ((dg - dg0).abs() > 64 * ulp * col).any()):
        raise AssertionError(
            f"int_rmsnorm_bwd differs: dx {(dx - dx0).abs().max().item()}, "
            f"dgamma {(dg - dg0).abs().max().item()}")
    # yardstick: the backward of F.rms_norm on the f32 values (autograd,
    # the graph built once and its backward timed)
    xr = xv.clone().requires_grad_(True)
    gr = gamma.clone().requires_grad_(True)
    yr = F.rms_norm(xr, (D,), gr, 1e-6)
    t = timings(lambda: int_norm.int_rmsnorm_bwd(xm, gm, xe, ge, gamma,
                                                  rstd),
                lambda: int_norm.int_rmsnorm_bwd_plain(xm, gm, xe, ge,
                                                       gamma, rstd),
                lambda: torch.autograd.grad(yr, (xr, gr), gq,
                                            retain_graph=True))
    # per element: xn (2), gq, gg, the row sum (2), dx (3), dgamma (2)
    b, by = bound_ms(nbytes(xm, gm, xe, ge, gamma, rstd, dx, dg), 0,
                     11 * R * D)
    return dict(name="int_rmsnorm_bwd", route="cuda",
                source="src/repro_torch/csrc/int_norm.cu",
                replaces="src/repro/kernels/int_norm.py:298",
                shape=f"({R},{D}) int16 x, int8 g -> dx, dgamma; tolerance "
                      "dx 64 ulp of its row's max, dgamma 64 ulp of the "
                      "column's sum of |gq xn|; library: F.rms_norm backward"
                      " (autograd) on the f32 values",
                max_abs_err=max((dx - dx0).abs().max().item(),
                                (dg - dg0).abs().max().item()),
                bound_ms=b, bound_by=by, **t)


#: attention backward shapes held on the card: name -> (B, Sq, Sk, KV, G,
#: hd, offsets, causal, window)
ATTN_BWD_SHAPES = {
    "bert-base cls": (32, 128, 128, 12, 1, 64, 0, False, None),
    "qwen1.5-0.5b train": (8, 256, 256, 16, 1, 64, 0, True, None),
    "smollm-135m gqa": (8, 256, 256, 3, 3, 64, 0, True, None),
    "ragged + window": (2, 20, 150, 2, 2, 16, [100, 37], True, 40),
}


def _attn_bwd_inputs(torch, dev, gen, shape):
    """int8-preset operands: q/k/v 2 planes (a12), g 1 plane (g8), dS 8 bits,
    P 12 bits; lse from the forward kernel, delta = rowsum(g·o) and dS's
    exponent from the dequantized values, as ``int_attention`` makes
    them; exponents [q, k, v, g, dS]."""
    from repro_torch.core import int_ops
    from repro_torch.kernels import int_attention as ia
    B, Sq, Sk, KV, G, hd, off, causal, window = shape
    q = _planes(torch, gen, dev, 2, B, Sq, KV, G, hd)
    k = _planes(torch, gen, dev, 2, B, Sk, KV, hd)
    v = _planes(torch, gen, dev, 2, B, Sk, KV, hd)
    g = _planes(torch, gen, dev, 1, B, Sq, KV, G, hd)
    qo = torch.tensor(off if isinstance(off, list) else [off] * B,
                      dtype=torch.int32, device=dev)
    qe, ke, ve, ge = -12, -12, -9, -20
    o, lse = ia.int_attn_fwd(
        q, k, v, qo, torch.tensor([qe, ke, ve], dtype=torch.int32,
                                  device=dev),
        p_bits=12, causal=causal, window=window, sc=1.0 / hd ** 0.5)
    gd = g[0].float() * 2.0 ** ge
    vd = (v[0].float() + 128 * v[1].float()) * 2.0 ** ve
    delta = (gd * o).sum(-1)
    dse = int_ops._ds_exp(int_ops._max_row_norm(gd),
                          int_ops._max_row_norm(vd), 8)
    exps = torch.tensor([qe, ke, ve, ge, int(dse)], dtype=torch.int32,
                        device=dev)
    return q, k, v, g, lse, delta, qo, exps


def check_attention_bwd(torch, dev, gen):
    """int_attn_bwd_dq and int_attn_bwd_dkv against their plain versions at
    ATTN_BWD_SHAPES (int8 preset), timed at the qwen1.5-0.5b training
    shape.  Tolerance: dq, dk and dv within 1e-4 of max|ref| (the same
    expf and the same ordered f32 sums on both sides; the count of
    elements that differ at all is printed).  Bound: the bytes of the
    planes, rows and outputs, or the int8 operations of the limb-pair
    products over the (query, key) pairs the mask lets through, whichever
    is larger."""
    import torch.nn.functional as F
    from repro_torch.kernels import int_attention as ia
    errs = {"int_attn_bwd_dq": 0.0, "int_attn_bwd_dkv": 0.0}
    timed = None
    for label, shape in ATTN_BWD_SHAPES.items():
        B, Sq, Sk, KV, G, hd, off, causal, window = shape
        q, k, v, g, lse, delta, qo, exps = _attn_bwd_inputs(torch, dev, gen,
                                                            shape)
        kw = dict(ds_bits=8, causal=causal, window=window,
                  sc=1.0 / hd ** 0.5)
        dq = ia.int_attn_bwd_dq(q, k, v, g, lse, delta, qo, exps,
                                p_bits=12, **kw)
        dk, dv = ia.int_attn_bwd_dkv(q, k, v, g, lse, delta, qo, exps,
                                     p_bits=12, **kw)
        dq0 = ia.int_attn_bwd_dq_plain(q, k, v, g, lse, delta, qo, exps,
                                       **kw)
        dk0, dv0 = ia.int_attn_bwd_dkv_plain(q, k, v, g, lse, delta, qo,
                                             exps, p_bits=12, **kw)
        line = []
        for name, got, ref in (("dq", dq, dq0), ("dk", dk, dk0),
                               ("dv", dv, dv0)):
            scale = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            if not scale > 0 or err > 1e-4 * scale:
                raise AssertionError(f"int_attn_bwd {name} differs at "
                                     f"{label}: {err} of max {scale}")
            key = "int_attn_bwd_dq" if name == "dq" else "int_attn_bwd_dkv"
            errs[key] = max(errs[key], err)
            line.append(f"{name} max|err| {err:.3e} of max {scale:.3e}, "
                        f"{int((got != ref).sum())} elements differ")
        print(f"  attention backward at {label} {shape[:6]}: "
              + "; ".join(line))
        if label == "qwen1.5-0.5b train":
            timed = (shape, q, k, v, g, lse, delta, qo, exps, kw, dq, dk, dv)
    shape, q, k, v, g, lse, delta, qo, exps, kw, dq, dk, dv = timed
    B, Sq, Sk, KV, G, hd, off, causal, window = shape
    # yardstick: SDPA's backward in f32 through autograd at the same shape
    # (the graph built once, its backward timed; it computes dq, dk and dv)
    H = KV * G
    qs, ks, vs = (torch.randn((B, H, S, hd), generator=gen, device=dev)
                  .requires_grad_(True) for S in (Sq, Sk, Sk))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    gout = torch.randn_like(out)

    def library():
        return torch.autograd.grad(out, (qs, ks, vs), gout,
                                   retain_graph=True)
    lib_t = dict(library_ms=cuda_ms(library),
                 library_device_ms=device_ms(library))
    pairs = B * KV * G * Sq * (Sq + 1) // 2 if causal else B * KV * G * Sq * Sk
    rows = nbytes(lse, delta)
    out_k = []
    for name, fn, plain, outs, limb_pairs in (
            ("int_attn_bwd_dq",
             lambda: ia.int_attn_bwd_dq(q, k, v, g, lse, delta, qo, exps,
                                        p_bits=12, **kw),
             lambda: ia.int_attn_bwd_dq_plain(q, k, v, g, lse, delta, qo,
                                              exps, **kw),
             (dq,), 4 + 2 + 2),
            ("int_attn_bwd_dkv",
             lambda: ia.int_attn_bwd_dkv(q, k, v, g, lse, delta, qo, exps,
                                         p_bits=12, **kw),
             lambda: ia.int_attn_bwd_dkv_plain(q, k, v, g, lse, delta, qo,
                                               exps, p_bits=12, **kw),
             (dk, dv), 4 + 2 + 2 + 2)):
        t = {**timings(fn, plain), **lib_t}
        # s (2x2 limb pairs), dp (1x2), and dq (1x2) or dk (1x2) + dv (2x1)
        b, by = bound_ms(nbytes(q, k, v, g, qo, exps, *outs) + rows,
                         2 * hd * pairs * limb_pairs)
        out_k.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/int_attention_bwd.cu",
            replaces=("src/repro/kernels/int_attention.py:328"
                      if name == "int_attn_bwd_dq" else
                      "src/repro/kernels/int_attention.py:441"),
            shape=f"qwen1.5-0.5b training: q/g ({B},{Sq},{KV},{G},{hd}), "
                  f"k/v ({B},{Sk},{KV},{hd}), 2 planes (g 1), causal, dS 8 "
                  "bits, P 12 bits; also held at "
                  + ", ".join(k_ for k_ in ATTN_BWD_SHAPES
                              if k_ != "qwen1.5-0.5b train")
                  + "; tolerance 1e-4 of max|ref|; library: SDPA backward "
                  "(f32, autograd, dq + dk + dv)",
            max_abs_err=errs[name], bound_ms=b, bound_by=by, **t))
    return out_k


def check_small_model(torch, dev):
    """Reduced qwen1.5-0.5b (2 layers): prefill + 3 decode steps on the card
    (CUDA kernels) against the port's CPU path (plain versions)."""
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=gen)
    dec = torch.randint(0, cfg.vocab, (3, 2, 1), generator=gen)
    worst = 0.0
    outs = {}
    for device in ("cpu", dev):
        p = _to(params, device)
        cache = lm.init_cache(cfg, 2, 64, device=device)
        rows = []
        with torch.no_grad():
            logits, cache = lm.lm_prefill_cache(p, toks.to(device), cache,
                                                cfg, QuantConfig.int8())
            rows.append(logits.cpu())
            for i in range(3):
                logits, cache = lm.lm_decode_step(p, dec[i].to(device), cache,
                                                  cfg, QuantConfig.int8())
                rows.append(logits.cpu())
        outs[str(device)] = rows
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite logits on the card")
        worst = max(worst, ((a - b).abs().max() / a.abs().max()).item())
    print(f"  reduced qwen1.5-0.5b, card vs CPU logits: max |diff| / max|ref| "
          f"= {worst:.3e} (tolerance 5e-3)")
    if worst > 5e-3:
        raise AssertionError("card logits disagree with the CPU path")


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def _grad_agreement(torch, g0: dict, g1: dict):
    """Worst |card - CPU| / max|CPU| over the gradients, and where."""
    worst, at = 0.0, ""
    for name, ref in g0.items():
        got = g1[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"non-finite gradient {name} on the card")
        scale = ref.abs().max().item()
        d = (got - ref).abs().max().item() / scale if scale else \
            (got - ref).abs().max().item()
        if d > worst:
            worst, at = d, name
    return worst, at


def check_small_bert(torch, dev):
    """Reduced bert-base (2 layers, d_model 128): one training step, rounding
    to nearest, on the card (CUDA kernels) against the port's CPU path
    (plain versions) from the same weights and batch: cls and span under
    the paper's integer scope, and cls under the plain int8 preset
    (integer attention forward and backward).

    Tolerances: the loss within 1e-5 relative; every parameter's gradient
    within 2e-3 of its largest magnitude, the bound the CPU tests hold the
    port to against the JAX reference.  The FP32 kept ops (softmax, GELU,
    the attention einsums, the layer-norm's f32 sums) round differently on
    the two devices, which can move an 8-bit gradient mantissa at a
    rounding boundary by one step; a faulty integer kernel moves whole
    gradients."""
    import dataclasses
    from repro_torch.configs import bert_base
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import paper_models as pm
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as topt
    cfg = bert_base.CONFIG.reduced()
    rn = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    ocfg = topt.OptimizerConfig(lr=1e-3, weight_decay=0.0)
    for task, label, qcfg, sampler, loss_fn in (
            ("cls", "paper scope", tf.paper_scope(rn),
             tf.make_cls_task(vocab=cfg.vocab, seq=32), pm.bert_cls_loss),
            ("span", "paper scope", tf.paper_scope(rn),
             tf.make_span_task(vocab=cfg.vocab, seq=48), pm.bert_span_loss),
            ("cls", "int8", rn, tf.make_cls_task(vocab=cfg.vocab, seq=32),
             pm.bert_cls_loss)):
        params = pm.bert_init(torch.Generator().manual_seed(1), cfg,
                              num_labels=4, span_head=task == "span",
                              device="cpu")
        batch = sampler(4, 0)
        res = {}
        for device in ("cpu", dev):
            p = _to(params, device)
            _, _, loss, grads, _ = tf.train_step(
                p, topt.init(p), tf.to_device(batch, device), cfg, qcfg,
                loss_fn, ocfg, None)
            res[str(device)] = (float(loss), {n: g.cpu()
                                              for n, g in _leaves(grads)})
        (l0, g0), (l1, g1) = res["cpu"], res[str(dev)]
        dl = abs(l1 - l0) / abs(l0)
        worst, at = _grad_agreement(torch, g0, g1)
        print(f"  reduced bert-base {task} step ({label}), card vs CPU: loss "
              f"{l1:.6f} vs {l0:.6f} (rel {dl:.2e}, tolerance 1e-5); worst "
              f"gradient {worst:.2e} of its max at {at} (tolerance 2e-3) "
              f"over {len(g0)} parameters")
        if dl > 1e-5 or worst > 2e-3:
            raise AssertionError("card training step disagrees with the CPU "
                                 "path")


class _Recorder:
    """While active, records each integer layer call of the model (its
    inputs, detached, and the upstream gradient its output receives)."""

    NAMES = ("int_rmsnorm", "int_linear", "int_attention")

    def __init__(self, torch):
        from repro_torch.core import int_ops
        self.torch, self.int_ops, self.calls = torch, int_ops, []
        self.orig = {n: getattr(int_ops, n) for n in self.NAMES}

    def _wrap(self, name):
        torch, fn = self.torch, self.orig[name]

        def call(*args, **kw):
            entry = {"name": name, "kw": kw, "g": None, "args": [
                a.detach().clone() if isinstance(a, torch.Tensor) else a
                for a in args]}
            out = fn(*args, **kw)
            self.calls.append(entry)
            if out.requires_grad:
                out.register_hook(
                    lambda g, e=entry: e.__setitem__("g", g.detach().clone()))
            return out
        return call

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.int_ops, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.int_ops, n, f)

    def replay(self, entry, device):
        """The layer's output and input gradients on ``device`` from the
        recorded inputs and upstream gradient."""
        torch = self.torch
        args = [(a.to(device).requires_grad_(a.is_floating_point())
                 if isinstance(a, torch.Tensor) else a)
                for a in entry["args"]]
        y = self.orig[entry["name"]](*args, **entry["kw"])
        ts = [a for a in args if isinstance(a, torch.Tensor)
              and a.requires_grad]
        gs = torch.autograd.grad(y, ts, entry["g"].to(device))
        return y.detach().cpu(), [g.cpu() for g in gs]


def check_small_lm_train(torch, dev):
    """Reduced qwen1.5-0.5b and smollm-135m (2 layers, d_model 128, 4 query
    heads over 2 kv heads): one ``lm_loss`` step under int8, rounding to
    nearest, on the card and on the port's CPU path from the same weights
    and batch.

    The whole step: the loss within 1e-5 relative and every gradient
    finite; the gradients' agreement is printed, not bounded.  The FP32
    kept ops (RoPE's cos / sin, the softmax's exp, SiLU) round differently
    on the two devices; an ulp there moves an a12 or g8 mantissa now and
    then, and the 8-bit dS of attention's backward, quantized against the
    reference's loose norm bound (mostly 0 and ±1), turns that into
    gradients of the q / k projections that differ by tens of per cent
    between two equally valid runs (measured 19% of the max for wq).  So
    each integer layer is held on its own: every call of the CPU step is
    replayed on both devices from its recorded inputs and upstream
    gradient, and its output (within 2^-11 of max, one P step of the
    attention forward) and input gradients (within 2e-3 of max, as
    check_small_bert) must agree."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import trainer
    rn = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    for arch in ("qwen1.5-0.5b", "smollm-135m"):
        cfg = registry.get_config(arch).reduced()
        params = lm.lm_init(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
        batch = next(SyntheticLM(DataConfig(batch_size=4, seq_len=64,
                                            vocab=cfg.vocab)))
        res = {}
        rec = _Recorder(torch)
        for device in ("cpu", dev):
            with rec:
                loss, _, grads = trainer.loss_and_grads(
                    lm.lm_loss, _to(params, device),
                    tf.to_device(batch, device), cfg, rn, None)
            res[str(device)] = (float(loss), {n: g.cpu()
                                              for n, g in _leaves(grads)})
        (l0, g0), (l1, g1) = res["cpu"], res[str(dev)]
        dl = abs(l1 - l0) / abs(l0)
        worst, at = _grad_agreement(torch, g0, g1)
        calls = rec.calls[:len(rec.calls) // 2]          # the CPU step's
        worst_y = worst_g = 0.0
        for entry in calls:
            (y0, gs0), (y1, gs1) = (rec.replay(entry, "cpu"),
                                    rec.replay(entry, dev))
            worst_y = max(worst_y, ((y1 - y0).abs().max()
                                    / y0.abs().max()).item())
            for a, b in zip(gs0, gs1):
                if not torch.isfinite(b).all():
                    raise AssertionError(f"non-finite {entry['name']} "
                                         "gradient on the card")
                scale = a.abs().max().item()
                worst_g = max(worst_g, (b - a).abs().max().item()
                              / (scale if scale else 1.0))
        print(f"  reduced {arch} lm_loss step (int8), card vs CPU: loss "
              f"{l1:.6f} vs {l0:.6f} (rel {dl:.2e}, tolerance 1e-5); whole-"
              f"step gradients finite, worst {worst:.2e} of its max at {at}"
              f"; {len(calls)} integer layer calls replayed from the same "
              f"inputs: outputs within {worst_y:.2e} of max (tolerance "
              f"2^-11), input gradients within {worst_g:.2e} (tolerance "
              "2e-3)")
        if dl > 1e-5 or worst_y > 2.0 ** -11 or worst_g > 2e-3:
            raise AssertionError("card LM training step disagrees with the "
                                 "CPU path")


def profile_step(torch, fn, what: str) -> float:
    """torch.profiler over one call of ``fn``: wall time, summed device time
    (the device's busy share) and the device time by kernel or op.
    Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                 # host ops; their kernels are listed
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    print(f"  profiled {what}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%) in {launches} "
          "device kernels / copies; top device time:")
    for dev_us, count, key in rows[:14]:
        print(f"    {dev_us / 1e3:8.3f} ms  {count:5d}x  {key[:110]}")
    return busy_ms / wall_ms


def finetune_phase(torch, dev, wrappers, int8_wrappers) -> tuple:
    """Fine-tune bert-base at full width through ``finetune`` (phase 5):
    cls and span under the paper's scope (``wrappers`` must all launch),
    cls also under the plain int8 preset (``int8_wrappers``, integer
    attention included) and FP32.  Returns each wrapper's launches over the
    two paper-scope runs, and over the int8 run."""
    from repro_torch.configs import bert_base
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as topt
    arch = bert_base.CONFIG
    total = dict.fromkeys(wrappers, 0)
    for task, steps, batch, seq in (("cls", 10, 32, 128),
                                    ("span", 4, 12, 384)):
        ft = tf.FtConfig(steps=steps, batch=batch, seq=seq, eval_n=batch,
                         lr=1e-4)
        stamps, counts = [], []

        def on_step(i, loss):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts.append({n: w.launches for n, w in wrappers.items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t_start = time.perf_counter()
        metric, losses = tf.finetune(task, tf.paper_scope(), ft, device=dev,
                                     arch=arch, return_losses=True,
                                     on_step=on_step)
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(map(lambda v: v == v and abs(v) != float("inf"),
                       losses)):
            raise AssertionError(f"non-finite {task} loss: {losses}")
        for n, c in launches.items():
            if c <= 0:
                raise AssertionError(f"kernel {n} was not launched on the "
                                     f"{task} fine-tuning path")
            total[n] += c
        # steps 1.. are timed between on_step calls; step 0 also holds the
        # set-up (full-width init, optimizer state) and first-call costs
        first_ms = 1e3 * (stamps[0] - t_start)
        step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        med = statistics.median(step_ms)
        tok_s = batch * seq * len(step_ms) / sum(step_ms) * 1e3
        last = {n: counts[-1][n] - counts[-2][n] for n in wrappers}
        _, losses32 = tf.finetune(task, QuantConfig.fp32(), ft, device=dev,
                                  arch=arch, return_losses=True)
        print(f"  {task}: batch {batch} x seq {seq}, {steps} steps; paper-"
              f"scope losses {[round(v, 5) for v in losses]}; FP32 losses "
              f"from the same init {[round(v, 5) for v in losses32]}; eval "
              f"metric {metric:.1f}% on {batch} samples")
        if task == "cls":
            # the plain int8 preset: attention's QK^T and PV integer too
            for w in int8_wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t8 = time.perf_counter()
            _, losses8 = tf.finetune(task, QuantConfig.int8(), ft,
                                     device=dev, arch=arch,
                                     return_losses=True)
            torch.cuda.synchronize()
            t8 = time.perf_counter() - t8
            int8_launches = {n: w.launches for n, w in int8_wrappers.items()}
            if not all(v == v and abs(v) != float("inf") for v in losses8):
                raise AssertionError(f"non-finite int8 {task} loss: "
                                     f"{losses8}")
            for n, c in int8_launches.items():
                if c <= 0:
                    raise AssertionError(f"kernel {n} was not launched on "
                                         "the int8 fine-tuning path")
            print(f"  {task} under the plain int8 preset (integer "
                  f"attention): losses {[round(v, 5) for v in losses8]} "
                  f"({steps} steps, set-up included {t8:.2f} s); launches "
                  f"{int8_launches}")
        print(f"  {task}: set-up + step 0 {first_ms:.2f} ms; steps 1-"
              f"{steps - 1} ms {[round(v, 2) for v in step_ms]}; median "
              f"{med:.2f} ms; {tok_s:.1f} tokens/s over those steps; peak "
              f"memory {peak:.2f} GiB; launches in the run {launches}; in "
              f"one step {last}")
        if task == "cls":
            gen = torch.Generator(device=dev).manual_seed(1)
            cfg, params, sampler, loss_fn, lr = tf._task_setup(
                task, gen, ft, arch, dev)
            ocfg = topt.OptimizerConfig(lr=lr, weight_decay=0.0)
            state = {"p": params, "o": topt.init(params)}
            b = tf.to_device(sampler(batch, 0), dev)

            def one_step():
                state["p"], state["o"], _, _, _ = tf.train_step(
                    state["p"], state["o"], b, cfg, tf.paper_scope(),
                    loss_fn, ocfg, gen)
            one_step()
            profile_step(torch, one_step, f"bert-base {task} training step")
    return total, int8_launches


def train_phase(torch, dev, wrappers, steps: int = 6,
                lr: float = 1e-4) -> dict:
    """Train qwen1.5-0.5b at full width (24 layers, d_model 1024, vocab
    151936) through the port's training launcher (phase 6): int8, batch 8
    x seq 256, ``steps`` AdamW steps at ``lr`` (the launcher's default is
    the reference's 1e-3), random weights and stochastic gradient rounding
    from one seeded CUDA generator.  The launch counters are set to 0 just
    before the int8 run and read just after; every kernel of the path must
    have launched, every loss be finite and the first near ln 151936.  Then
    the same steps under FP32 from the same init, and one profiled int8
    step.  Returns the int8 run's launches."""
    import math
    from repro_torch.launch import train as lt
    argv = ["--arch", "qwen1.5-0.5b", "--batch", "8", "--seq", "256",
            "--steps", str(steps), "--lr", str(lr), "--log-every",
            str(steps), "--device", str(dev)]
    stamps, counts = [], []

    def on_step(i, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        counts.append({n: w.launches for n, w in wrappers.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t_start = time.perf_counter()
    losses = lt.main(argv + ["--quant", "int8"], on_step=on_step)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite qwen training loss: {losses}")
    if abs(losses[0] - math.log(151936)) > 1.5:
        raise AssertionError(f"first loss {losses[0]} is not near ln 151936")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} was not launched on the "
                                 "training path")
    tokens = 8 * 256
    first_ms = 1e3 * (stamps[0] - t_start)
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    med = statistics.median(step_ms)
    tok_s = tokens * len(step_ms) / sum(step_ms) * 1e3
    last = {n: counts[-1][n] - counts[-2][n] for n in wrappers}
    losses32 = lt.main(argv + ["--quant", "fp32"])
    print(f"  lr {lr}; int8 losses {[round(v, 5) for v in losses]}; FP32 "
          f"losses from the same init {[round(v, 5) for v in losses32]}")
    print(f"  set-up + step 0 {first_ms:.2f} ms; steps 1-{steps - 1} ms "
          f"{[round(v, 2) for v in step_ms]}; median {med:.2f} ms; "
          f"{tok_s:.1f} tokens/s over those steps; peak memory {peak:.2f} "
          f"GiB; launches in the run {launches}; in one step {last}")
    run = lt.build(lt.parse_args(argv + ["--quant", "int8"]))
    run.step()
    profile_step(torch, run.step, "qwen1.5-0.5b training step (int8)")
    return launches


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import bert_base, registry
    from repro_torch.kernels import _lib, bfp_matmul, dfx_quant, int_attention, int_norm
    from repro_torch.models import lm
    from repro_torch.serve.engine import ContinuousBatcher, Engine, ServeConfig

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(f"[1] card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _lib.build()
    build_s = time.perf_counter() - t0
    print(f"[1] built the CUDA kernels in {build_s:.1f} s")
    for line in _lib.ptxas_report().splitlines():
        if "Used" in line or "spill" in line:
            print("    ptxas:", line.strip())
    print(card)

    cfg = registry.get_config("qwen1.5-0.5b")
    V = lm.padded_vocab(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    print("[2] kernels against their plain versions, full-width shapes")
    bert, tokens = bert_base.CONFIG, 32 * 128
    kernels = [check_quantize(torch, dev, gen, V, cfg.d_model, tokens,
                              bert.d_ff),
               check_matmul(torch, dev, gen, cfg, V, bert, tokens),
               check_rmsnorm(torch, dev, gen, cfg.d_model),
               check_attention(torch, dev, gen, cfg)]
    kernels += check_matmul_bwd(torch, dev, gen, bert, tokens)
    kernels += check_layernorm(torch, dev, gen, bert.d_model, tokens)
    kernels.append(check_rmsnorm_bwd(torch, dev, gen, 8 * 256, cfg.d_model))
    kernels += check_attention_bwd(torch, dev, gen)
    for k in kernels:
        print(f"  {k['name']}: max_abs_err {k['max_abs_err']:.3e}; call "
              f"{k['ms']:.4f} ms, device {k['device_ms']:.4f} ms; plain "
              f"{k['plain_ms']:.4f} / {k['plain_device_ms']:.4f}; library "
              f"{k['library_ms']} / {k['library_device_ms']}; bound "
              f"{k['bound_ms']:.4f} by {k['bound_by']} [{k['shape']}]")

    print("[3] reduced models, card vs CPU path")
    check_small_model(torch, dev)
    check_small_bert(torch, dev)
    check_small_lm_train(torch, dev)

    print("[4] serve qwen1.5-0.5b, full width, int8")
    wrappers = {"dfx_quantize": dfx_quant.dfx_quantize,
                "bfp_matmul": bfp_matmul.bfp_matmul,
                "int_rmsnorm_fwd": int_norm.int_rmsnorm_fwd,
                "int_attn_fwd": int_attention.int_attn_fwd}
    t0 = time.perf_counter()
    params = lm.lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    engine = Engine(params, cfg, registry.get_quant("int8"),
                    ServeConfig(max_seq=256, batch_slots=4), device=dev)
    batcher = ContinuousBatcher(engine)
    rng = torch.Generator().manual_seed(0)
    n_req, prompt_len, new = 8, 64, 16
    for _ in range(n_req):
        batcher.submit(torch.randint(0, cfg.vocab, (prompt_len,),
                                     generator=rng).numpy(), new)
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    results = batcher.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if sorted(results) != list(range(n_req)) or batcher.failed:
        raise AssertionError(f"requests did not finish: {batcher.failed}")
    if any(len(r) != new for r in results.values()):
        raise AssertionError("a request produced the wrong token count")
    if not torch.isfinite(batcher._logits[:, -1, :cfg.vocab]).all():
        raise AssertionError("non-finite logits")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} was not launched on the path")
    tokens = n_req * new
    print(f"  served {n_req} requests ({prompt_len}-token prompts, {new} new "
          f"tokens each) in {dt:.3f} s: {tokens / dt:.1f} generated tok/s, "
          f"{n_req * (prompt_len + new) / dt:.1f} processed tok/s; peak "
          f"memory {peak:.2f} GiB; launches {launches}")
    # launches and time of one decode step of the 4-slot batch
    def decode_step():
        engine._decode(engine.params, batcher.last_tok,
                       {k: v.clone() for k, v in batcher.cache.items()})
    for w in wrappers.values():
        w.launches = 0
    decode_step()
    per_step = {n: w.launches for n, w in wrappers.items()}
    step_ms = cuda_ms(decode_step, reps=5, warmup=1)
    print(f"  one decode step (4 slots): {step_ms:.2f} ms; launches per "
          f"step {per_step}")
    prefill_ms = cuda_ms(lambda: engine._prefill(
        engine.params, torch.zeros((4, prompt_len), dtype=torch.int32,
                                   device=dev),
        {k: v.clone() for k, v in batcher.cache.items()}), reps=3, warmup=1)
    print(f"  one {prompt_len}-token prefill (4-slot batch): "
          f"{prefill_ms:.2f} ms")
    profile_step(torch, lambda: engine._decode(
        engine.params, batcher.last_tok,
        {k: v.clone() for k, v in batcher.cache.items()}), "decode step")
    print("[5] fine-tune bert-base, full width, paper scope (int8 linear / "
          "layer-norm / embedding), stochastic gradient rounding")
    paper = {"dfx_quantize": dfx_quant.dfx_quantize,
             "bfp_matmul": bfp_matmul.bfp_matmul,
             "bfp_matmul_nt": bfp_matmul.bfp_matmul_nt,
             "bfp_matmul_tn": bfp_matmul.bfp_matmul_tn,
             "int_layernorm_fwd": int_norm.int_layernorm_fwd,
             "int_layernorm_bwd": int_norm.int_layernorm_bwd}
    attn = {"int_attn_fwd": int_attention.int_attn_fwd,
            "int_attn_bwd_dq": int_attention.int_attn_bwd_dq,
            "int_attn_bwd_dkv": int_attention.int_attn_bwd_dkv}
    ft_launches, ft8_launches = finetune_phase(torch, dev, paper,
                                               {**paper, **attn})
    print("[6] train qwen1.5-0.5b, full width, int8, batch 8 x seq 256, "
          "through launch.train")
    tr_launches = train_phase(torch, dev, {
        "dfx_quantize": dfx_quant.dfx_quantize,
        "bfp_matmul": bfp_matmul.bfp_matmul,
        "bfp_matmul_nt": bfp_matmul.bfp_matmul_nt,
        "bfp_matmul_tn": bfp_matmul.bfp_matmul_tn,
        "int_rmsnorm_fwd": int_norm.int_rmsnorm_fwd,
        "int_rmsnorm_bwd": int_norm.int_rmsnorm_bwd, **attn})
    for k in kernels:
        by_path = {"serve": launches.get(k["name"], 0),
                   "finetune": ft_launches.get(k["name"], 0),
                   "finetune_int8": ft8_launches.get(k["name"], 0),
                   "train": tr_launches.get(k["name"], 0)}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
