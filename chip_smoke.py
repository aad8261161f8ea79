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
   also the step's gradient quantize and w1 forward, and the span step —
   batch 12 x seq 384 — for the layer-norm backward too; the qwen1.5-0.5b
   training step — batch 8 x seq 256 — for the RMS-norm backward, also at
   qwen2-moe-a2.7b's d_model 2048, each norm backward called twice on the
   same inputs (bit for bit) and its device kernels per call printed; it,
   bert-base cls, smollm-135m's GQA, a ragged windowed case,
   qwen2-moe-a2.7b's head dim 128, head dim 256 (the widest staged body)
   and head dim 384 (the direct body) for the attention backward (timed
   at the qwen1.5-0.5b and qwen2-moe-a2.7b training shapes and at head
   dims 256 and 384), and for the attention forward decode, prefill, the
   qwen1.5-0.5b training shape, smollm-135m's GQA, a ragged windowed
   case, head dim 128, and head dim 256 at 3 limbs and 384 (the direct
   body; timed at decode, the training shape, head dims 128 and 384, with
   each instantiation's registers and spills); the qwen1.5-0.5b training
   step's matmuls — the MLP's NN / NT / TN at 2048 x 1024 x 2816, the tied
   head's logits, dX over the vocabulary and dE — and int16's 3x3 limbs at
   bert-base's w1 shape; the
   qwen2-moe-a2.7b paths — E = 60 experts, 256 capacity rows each in
   training, 16 at decode — for the grouped quantize and the batched NN /
   NT / TN matmuls; the norm forwards also at the qwen1.5-0.5b training
   step, qwen2-moe-a2.7b's width, decode and the span step, each body
   held bit for bit against the any-shape body, and at D = 1000 and on
   int8 mantissas, one device kernel per call): run the kernel and its
   plain PyTorch version on the
   card from the same seeded inputs and hold them together (integer
   outputs, the matmuls and the attention backward exactly, other f32
   outputs within the stated tolerance); time kernel, plain version and a
   PyTorch yardstick (one call; for a matmul one ``torch._int_mm`` per
   limb pair the kernel computes, 60 of them per pair for a batched one)
   with CUDA events (median); compute the card's lower bound from the
   bytes and the operations this call needs.  Each matmul row also prints
   its int8 TOP/s, its share of the bound and ``torch._int_mm`` with B
   column-major beside the row-major yardstick (the factor held against
   the faster).  The five kernels with a
   ``kept_ops="integer"`` body (the norm forwards' ``integer_rsqrt``, the
   attention forward's and backward's ``integer_exp``) are held and
   timed with it too, against their plain versions with the same flag
   (``int_*`` keys), beside their FP32 body in the same run.  Also the
   library yardsticks of the decode tied head, bert-base's w1 forward and
   the MoE decode product.
3. On reduced configurations (2 layers), from the same weights, the card
   against the port's CPU path: qwen1.5-0.5b's served logits; one BERT
   training step under the paper's integer scope (round to nearest), its
   loss and every parameter's gradient, for the cls and span heads, and
   for cls under the plain int8 preset; one ``lm_loss`` step of
   qwen1.5-0.5b and of smollm-135m under int8; qwen2-moe-a2.7b's served
   logits and one ``lm_loss`` step, with the tokens routed to another
   expert set on the two devices counted and set aside.  Under int8 +
   ``kept_ops="integer"``: the BERT cls step, the qwen1.5-0.5b step and
   the MoE step, whose router gradient must be zero on both devices.
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
6b. ``kept_ops="integer"`` at full width (``kept_int_phase``): bert-base
   cls (phase 5's int8 run) and qwen1.5-0.5b training (phase 6's) under
   int8 and int8 + kept-int from the same seeds; each kernel's launches
   per step must equal the int8 run's.  Prints losses beside int8 and
   FP32, median step ms, tokens/s, peak memory, busy share and the
   element-wise launches the iapprox activations add.
7. Serve qwen2-moe-a2.7b at full width and depth (24 layers, d_model
   2048, 60 experts top-4 of d_ff 1408, a shared expert of 5632, vocab
   151936; FP32 weights ~57 GB) under int8 with phase 4's request mix,
   after the earlier phases' tensors are freed: the grouped quantize and
   the batched NN matmul must have launched.  Prints what phase 4 prints.
8. Train qwen2-moe-a2.7b at full width with the depth cut to
   ``MOE_TRAIN_LAYERS`` (the deepest that leaves 10% of the card's memory
   spare; the AdamW update runs in place) through ``lm_loss`` +
   ``make_train_step``: int8, batch 8 x seq 256 (the capacity dispatch at
   256 rows per expert), 6 AdamW steps at lr 1e-4, stochastic gradient
   rounding from a seeded CUDA generator; all four MoE kernels must have
   launched, and the peak must leave 10% of the card's memory.  Prints
   what phase 6 prints.
9. Print the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is available or when
the script is not inside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import re
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


def device_ms(fn, reps: int = 10, windows: int = 6) -> float:
    """Device time of ``fn()`` in ms: the summed duration of the kernels and
    copies it runs (torch.profiler), per call — the host time between
    launches, which ``cuda_ms`` includes for small kernels, left out.

    The profiler now and then loses some or all of a window's device
    events (a window of ``reps`` calls then reads low, or 0).  So windows
    are repeated until one records as many device events as an earlier
    one, and that window's time is taken; no agreement within ``windows``
    windows raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []                        # (device events, device us) per window
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in events)
        us = sum(getattr(e, "self_device_time_total", 0) for e in events)
        if n and any(n == m for m, _ in seen):
            return us / reps / 1e3
        seen.append((n, us))
    raise RuntimeError("the profiler's device event counts disagreed in "
                       f"every window: (events, us) {seen}")


def device_kernels(fn, reps: int = 5, windows: int = 6) -> tuple:
    """(device kernels and copies per call of ``fn()``, their names) from
    torch.profiler; windows are repeated until two record the same count,
    as in ``device_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n and n in seen:
            return n / reps, sorted(_kernel_name(e.key) for e in events)
        seen.append(n)
    raise RuntimeError(f"the profiler's device event counts disagreed in "
                       f"every window: {seen}")


def norm_bwd_timings(torch, name, kernel, plain, library) -> dict:
    """A norm backward's ``timings`` after two checks: a second call on the
    same inputs gives the same bits, and the kernels it runs per call
    (printed; one cooperative launch)."""
    a, b = kernel(), kernel()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    n, names = device_kernels(kernel)
    print(f"  {name}: {n:g} device kernels per call {names}; two calls "
          "bit for bit")
    return dict(timings(kernel, plain, library), kernels_per_call=n)


def timings(kernel, plain, library=None) -> dict:
    """CUDA-event medians and profiler device times of the kernel's wrapper
    call, its plain version and the library yardstick."""
    return dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library) if library else None,
                device_ms=device_ms(kernel), plain_device_ms=device_ms(plain),
                library_device_ms=device_ms(library) if library else None)


def int_body(t: dict, **extra) -> dict:
    """A kernel's kept_ops="integer" body's timings (``timings`` of its
    wrapper and plain version, flag set) under ``int_`` keys."""
    return {f"int_{k}": v for k, v in {**t, **extra}.items()}


def body_line(name: str, k: dict, prefix: str = "") -> str:
    """One line: the integer body's device time beside the FP32 body's."""
    return (f"  {name} kept-int body{prefix and ' ' + prefix}: call "
            f"{k[prefix + 'int_ms']:.4f} ms, device "
            f"{k[prefix + 'int_device_ms']:.4f} ms; FP32 body call "
            f"{k[prefix + 'ms']:.4f} ms, device {k[prefix + 'device_ms']:.4f}"
            f" ms; plain (flag set) device "
            f"{k[prefix + 'int_plain_device_ms']:.4f} ms")


def bound_ms(n_bytes: float, n_ops: float, f32_ops: float = 0.0) -> tuple:
    """Least time the card could take: max(bytes / HBM rate, int8 ops /
    int8 tensor rate + f32 ops / f32 rate), and which of the two bounds
    it."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = (n_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _kernel_name(mangled: str) -> str:
    """'dq_kernel<2>' from an Itanium-mangled kernel name: the first
    length-prefixed identifier ending in '_kernel', with its integer and
    bool template arguments."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group())
        ident = mangled[j:j + int(m.group())]
        if ident.endswith("_kernel"):
            t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[j + len(ident):])
            args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
            return ident + (f"<{', '.join(args)}>" if args else "")
        i = j + max(len(ident), 1)
    return mangled


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def mm_row(label, call, n_ops, n_bytes, libs) -> dict:
    """One matmul row of phase 2: the wrapper call's device time beside its
    bound, its int8 TOP/s and share of the bound, and each ``torch._int_mm``
    yardstick's device time (``libs``: name -> call; ``int_mm`` with B
    row-major, ``int_mm_colmajor`` with B column-major, the layout
    cuBLASLt's int8 path prefers, operands made outside the timed region),
    the factor held against the faster."""
    d = device_ms(call)
    b, by = bound_ms(n_bytes, n_ops)
    lib = {k: device_ms(f) for k, f in libs.items()}
    best = min(lib.values()) if lib else None
    row = dict(label=label, device_ms=d, bound_ms=b, bound_by=by,
               tops=n_ops / d / 1e9, bound_share=b / d,
               factor=d / best if best else None,
               **{f"{k}_device_ms": v for k, v in lib.items()})
    print(f"  {label}: device {d:.4f} ms, {row['tops']:.0f} TOP/s, "
          f"{100 * b / d:.1f}% of its bound {b:.4f} ms ({by}); "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in lib.items())
          + (f"; factor {row['factor']:.2f} against the faster" if best
             else ""), flush=True)
    return row


def _colmajor(t):
    """The same matrix stored column-major (a copy made outside any timed
    region): cuBLASLt's preferred int8 B layout for torch._int_mm."""
    return t.t().contiguous().t()


def _held(name, got, ref, what):
    if got.shape != ref.shape or not bool((got == ref).all()):
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{what}: {(got - ref).abs().max().item()}")


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
    xs, w0 = [x.contiguous() for x in xm], wm[0].contiguous()
    w0c = _colmajor(w0)
    t = timings(lambda: bm.bfp_matmul(xm, wm, exp),
                lambda: bm.bfp_matmul_plain(xm, wm, exp),
                lambda: [torch._int_mm(x, w0) for x in xs])
    b, by = bound_ms(nbytes(xm, wm, out), 2 * M * K * N * xm.shape[0])
    hx, hw = cases[0]
    head_ms = cuda_ms(lambda: bm.bfp_matmul(hx, hw, exp))
    head_dev = device_ms(lambda: bm.bfp_matmul(hx, hw, exp))
    head_b, head_by = bound_ms(nbytes(hx, hw) + 4 * 4 * V, 2 * 4 * D * V * 2)
    # yardstick: torch._int_mm per limb pair; it needs more than 16 rows,
    # so the 4 decode rows are zero-padded to 17
    hxs = [torch.nn.functional.pad(x, (0, 0, 0, 13)).contiguous()
           for x in hx]
    hw0 = hw[0].contiguous()
    head_lib = device_ms(lambda: [torch._int_mm(x, hw0) for x in hxs])
    print(f"  bfp_matmul decode head 4x{D}x{V} (2x1 limbs, W K-major): "
          f"{head_ms:.4f} ms (device {head_dev:.4f}), bound {head_b:.4f} ms "
          f"({head_by}); library 2 x torch._int_mm (17 rows) device "
          f"{head_lib:.4f} ms")
    wx, ww = cases[4]
    w1_dev = device_ms(lambda: bm.bfp_matmul(wx, ww, exp))
    w1_b, w1_by = bound_ms(nbytes(wx, ww) + 4 * tokens * bert.d_ff,
                           2 * tokens * bert.d_model * bert.d_ff * 2)
    wxs, ww0 = [x.contiguous() for x in wx], ww[0].contiguous()
    ww0c = _colmajor(ww0)
    w1_lib = device_ms(lambda: [torch._int_mm(x, ww0) for x in wxs])
    print(f"  bfp_matmul bert-base w1 forward {tokens}x{bert.d_model}x"
          f"{bert.d_ff} (2x1 limbs): device {w1_dev:.4f} ms, bound "
          f"{w1_b:.4f} ms ({w1_by}); library 2 x torch._int_mm device "
          f"{w1_lib:.4f} ms")
    rows = [mm_row(f"3 prefill MLP {M}x{K}x{N} 2x1", lambda: bm.bfp_matmul(
                       xm, wm, exp), 2 * M * K * N * 2, nbytes(xm, wm, out),
                   {"int_mm": lambda: [torch._int_mm(x, w0) for x in xs],
                    "int_mm_colmajor": lambda: [torch._int_mm(x, w0c)
                                                for x in xs]}),
            mm_row(f"3b decode tied head 4x{D}x{V} (W K-major)",
                   lambda: bm.bfp_matmul(hx, hw, exp), 2 * 4 * D * V * 2,
                   nbytes(hx, hw) + 4 * 4 * V,
                   {"int_mm": lambda: [torch._int_mm(x, hw0) for x in hxs],
                    "int_mm_colmajor": lambda: [torch._int_mm(x, hw[0])
                                                for x in hxs]}),
            mm_row(f"3c bert-base w1 forward {tokens}x{bert.d_model}x"
                   f"{bert.d_ff} 2x1", lambda: bm.bfp_matmul(wx, ww, exp),
                   2 * tokens * bert.d_model * bert.d_ff * 2,
                   nbytes(wx, ww) + 4 * tokens * bert.d_ff,
                   {"int_mm": lambda: [torch._int_mm(x, ww0) for x in wxs],
                    "int_mm_colmajor": lambda: [torch._int_mm(x, ww0c)
                                                for x in wxs]})]
    rows += _matmul_train_rows(torch, dev, gen, cfg, V, bert, tokens, exp)
    return dict(name="bfp_matmul", route="cuda",
                source="src/repro_torch/csrc/bfp_matmul.cu",
                replaces="src/repro/kernels/bfp_matmul.py:147",
                shape=f"({M},{K})x({K},{N}), 2x1 limbs, tolerance exact (also "
                      f"held exactly: decode head, a decode linear, w1 "
                      f"forward ({tokens},{bert.d_model})x({bert.d_model},"
                      f"{bert.d_ff})); library: torch._int_mm per limb pair "
                      "(2 calls)",
                max_abs_err=err, bound_ms=b, bound_by=by, head_ms=head_ms,
                head_device_ms=head_dev, head_bound_ms=head_b,
                head_library_device_ms=head_lib, w1_device_ms=w1_dev,
                w1_bound_ms=w1_b, w1_library_device_ms=w1_lib, rows=rows,
                **t)


def _matmul_train_rows(torch, dev, gen, cfg, V, bert, tokens, exp):
    """bfp_matmul (NN) held exactly and timed at qwen1.5-0.5b's training
    shapes (batch 8 x seq 256): the MLP up-projection 2048 x 1024 x 2816
    (a12 x w8, 2x1 limbs), the tied head's logits 2048 x 1024 x V (W
    K-major) and its dX over V (g8 x w8, 1x1); and int16's 3x3 limbs at
    bert-base's w1 shape."""
    from repro_torch.kernels import bfp_matmul as bm
    D, F, T = cfg.d_model, cfg.d_ff, 8 * 256
    rows = []
    x, w = _planes(torch, gen, dev, 2, T, D), _planes(torch, gen, dev, 1, D, F)
    _held("bfp_matmul", bm.bfp_matmul(x, w, exp),
          bm.bfp_matmul_plain(x, w, exp), "the qwen MLP up-projection")
    w0 = w[0].contiguous()
    w0c = _colmajor(w0)
    rows.append(mm_row(
        f"qwen train NN {T}x{D}x{F} 2x1", lambda: bm.bfp_matmul(x, w, exp),
        2 * T * D * F * 2, nbytes(x, w) + 4 * T * F,
        {"int_mm": lambda: [torch._int_mm(xj, w0) for xj in x],
         "int_mm_colmajor": lambda: [torch._int_mm(xj, w0c) for xj in x]}))
    emb = _planes(torch, gen, dev, 1, V, D)         # the head's planes (V, D)
    hw = emb.transpose(1, 2)                         # (1, D, V), K-major
    _held("bfp_matmul", bm.bfp_matmul(x, hw, exp),
          bm.bfp_matmul_plain(x, hw, exp), "the tied head's logits")
    e_rows = emb[0].t().contiguous()
    rows.append(mm_row(
        f"tied head logits {T}x{D}x{V} 2x1 (W K-major)",
        lambda: bm.bfp_matmul(x, hw, exp), 2 * T * D * V * 2,
        nbytes(x, emb) + 4 * T * V,
        {"int_mm": lambda: [torch._int_mm(xj, e_rows) for xj in x],
         "int_mm_colmajor": lambda: [torch._int_mm(xj, emb[0].t())
                                     for xj in x]}))
    del e_rows
    g = _planes(torch, gen, dev, 1, T, V)
    _held("bfp_matmul", bm.bfp_matmul(g, emb, exp),
          bm.bfp_matmul_plain(g, emb, exp), "the tied head's dX over V")
    emb_c = _colmajor(emb[0])
    rows.append(mm_row(
        f"tied head dX {T}x{V}x{D} 1x1 (NN over V)",
        lambda: bm.bfp_matmul(g, emb, exp), 2 * T * V * D,
        nbytes(g, emb) + 4 * T * D,
        {"int_mm": lambda: torch._int_mm(g[0], emb[0]),
         "int_mm_colmajor": lambda: torch._int_mm(g[0], emb_c)}))
    del g, emb, emb_c, hw
    x3, w3 = (_planes(torch, gen, dev, 3, tokens, bert.d_model),
              _planes(torch, gen, dev, 3, bert.d_model, bert.d_ff))
    _held("bfp_matmul", bm.bfp_matmul(x3, w3, exp),
          bm.bfp_matmul_plain(x3, w3, exp), "int16 3x3 limbs")
    w3s = [wj.contiguous() for wj in w3]
    w3c = [_colmajor(wj) for wj in w3]
    rows.append(mm_row(
        f"int16 3x3 bert w1 {tokens}x{bert.d_model}x{bert.d_ff}",
        lambda: bm.bfp_matmul(x3, w3, exp),
        2 * tokens * bert.d_model * bert.d_ff * 9,
        nbytes(x3, w3) + 4 * tokens * bert.d_ff,
        {"int_mm": lambda: [torch._int_mm(xi, wj) for xi in x3 for wj in w3s],
         "int_mm_colmajor": lambda: [torch._int_mm(xi, wj) for xi in x3
                                     for wj in w3c]}))
    return rows


def norm_fwd_case(torch, dev, gen, ln: bool, R: int, D: int,
                  dtype=None) -> dict:
    """A norm forward (``ln``: int_layernorm_fwd, else int_rmsnorm_fwd) at
    (R, D) on int16 mantissas at a12 (or ``dtype`` int8, full range), both
    rsqrt bodies: the wrapper (the register body where the shape takes it)
    against the any-shape body bit for bit (y, mu, rstd; the any-shape body
    through the private launcher with wr = 0) and against the plain version
    (FP32 body: the statistics within 4 ulp, y within 1e-6 of max|y|;
    kept-int body: the statistics exact, y within 1e-6 of max|y|); one
    device kernel per wrapper call.  Returns its calls (``wrap``, ``plain``,
    ``any_shape``, ``library``), ``max_abs_err``, the bound and the
    kernel's name."""
    import torch.nn.functional as F
    from repro_torch.core import dfx
    from repro_torch.kernels import _lib, int_norm
    ulp = 2.0 ** -23
    dtype = dtype or torch.int16
    lim = 127 if dtype == torch.int8 else 2047
    xm = torch.randint(-lim, lim + 1, (R, D), generator=gen,
                       device=dev).to(dtype)
    xe = torch.tensor(-9, dtype=torch.int32, device=dev)
    gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    beta = 0.1 * torch.randn((D,), generator=gen, device=dev)
    lib, st = _lib.load(), _lib.stream_of(xm)
    if ln:
        def wrap(ir=False):
            return int_norm.int_layernorm_fwd(xm, xe, gamma, beta,
                                              integer_rsqrt=ir)

        def plain(ir=False):
            return int_norm.int_layernorm_fwd_plain(xm, xe, gamma, beta,
                                                    integer_rsqrt=ir)

        def any_shape(ir=False):
            return int_norm._launch_ln_fwd(lib, xm, xe, gamma, beta, 1e-5, ir,
                                           st, wr=0)
    else:
        def wrap(ir=False):
            return int_norm.int_rmsnorm_fwd(xm, xe, gamma, integer_rsqrt=ir)

        def plain(ir=False):
            return int_norm.int_rmsnorm_fwd_plain(xm, xe, gamma,
                                                  integer_rsqrt=ir)

        def any_shape(ir=False):
            return int_norm._launch(lib, xm, xe, gamma, 1e-6, ir, st, wr=0)
    name = "int_layernorm_fwd" if ln else "int_rmsnorm_fwd"
    what = f"{name} ({R},{D}) {str(dtype)[6:]}"
    err = 0.0
    for ir in (False, True):
        got, ref, rows = wrap(ir), plain(ir), any_shape(ir)
        if not all(torch.equal(a, b) for a, b in zip(got, rows)):
            raise AssertionError(f"{what} integer_rsqrt={ir}: the register "
                                 "body differs from the any-shape body")
        stats = [((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
                 for a, b in zip(got[1:], ref[1:])]
        ey = ((got[0] - ref[0]).abs().max() / ref[0].abs().max()).item()
        if max(stats) > (0 if ir else 4 * ulp) or ey > 1e-6:
            raise AssertionError(f"{what} integer_rsqrt={ir} differs from "
                                 f"its plain version: stats rel {stats}, y "
                                 f"rel {ey}")
        err = max(err, (got[0] - ref[0]).abs().max().item())
    n, names = device_kernels(wrap)
    if n != 1:
        raise AssertionError(f"{what}: {n:g} device kernels per call {names}")
    xv = xm.float() * dfx.pow2(xe)
    y, *st_out = got
    return dict(
        wrap=wrap, plain=plain, any_shape=any_shape, max_abs_err=err,
        library=((lambda: F.layer_norm(xv, (D,), gamma, beta, 1e-5)) if ln
                 else (lambda: F.rms_norm(xv, (D,), gamma, 1e-6))),
        # the layer-norm's f32 operations per element: 4 digit-sum /
        # moment int ops, then sub, 2 mul, mul, add
        bound=bound_ms(nbytes(xm, xe, gamma, y, *st_out) + (
            nbytes(beta) if ln else 0), 0, 9 * R * D if ln else 0),
        kernel=names[0])


def norm_fwd_row(label, case) -> dict:
    """One timed sub-row of a norm forward: both bodies' device ms beside
    the any-shape body's (the design before the register path), the
    library call's and the bound."""
    b, by = case["bound"]
    row = dict(label=label, device_ms=device_ms(case["wrap"]),
               int_device_ms=device_ms(lambda: case["wrap"](True)),
               any_shape_device_ms=device_ms(case["any_shape"]),
               library_device_ms=device_ms(case["library"]), bound_ms=b,
               bound_by=by, max_abs_err=case["max_abs_err"])
    print(f"  {label}: device {row['device_ms']:.4f} ms (kept-int "
          f"{row['int_device_ms']:.4f}), {100 * b / row['device_ms']:.1f}% of "
          f"its bound {b:.4f} ms ({by}); any-shape body "
          f"{row['any_shape_device_ms']:.4f}; library "
          f"{row['library_device_ms']:.4f} ms [{case['kernel'][:60]}]",
          flush=True)
    return row


def check_norm_fwd_shapes(torch, dev, gen, ln: bool, R: int, D: int,
                          rows: list) -> list:
    """Sub-rows of a norm forward (``rows``: (label, R, D)), and two
    checked-only cases at (R, D)'s rows: D = 1000 (the any-shape body) and
    int8 mantissas."""
    out = [norm_fwd_row(label, norm_fwd_case(torch, dev, gen, ln, r, d))
           for label, r, d in rows]
    norm_fwd_case(torch, dev, gen, ln, R, 1000)
    norm_fwd_case(torch, dev, gen, ln, R, D, torch.int8)
    print(f"  {'int_layernorm_fwd' if ln else 'int_rmsnorm_fwd'} ({R},1000) "
          f"and ({R},{D}) int8: held", flush=True)
    return out


def check_rmsnorm(torch, dev, gen, D, D_moe):
    """int_rmsnorm_fwd at prefill: 256 rows (4 slots x 64 tokens) of int16
    mantissas at a12; also (``rows``) qwen1.5-0.5b's training step (2048
    rows), qwen2-moe-a2.7b's width D_moe and decode (4 rows), each held as
    ``norm_fwd_case`` holds it and timed beside the any-shape body, and the
    any-shape D = 1000 and int8 mantissas held."""
    R = 256
    c = norm_fwd_case(torch, dev, gen, False, R, D)
    t = timings(c["wrap"], c["plain"], c["library"])
    ti = timings(lambda: c["wrap"](True), lambda: c["plain"](True))
    b, by = c["bound"]
    k = dict(name="int_rmsnorm_fwd", route="cuda",
             source="src/repro_torch/csrc/int_norm.cu",
             replaces="src/repro/kernels/int_norm.py:246",
             shape=f"({R},{D}) int16; tolerance rstd 4 ulp, y 1e-6 of max; "
                   "kept-int body (int_*): rstd exact, y 1e-6 of max; both "
                   "bodies bit for bit with the any-shape body; library: "
                   "F.rms_norm on the f32 values; rows: 2048 x D, 2048 x "
                   "D_moe, 4 x D",
             max_abs_err=c["max_abs_err"], bound_ms=b, bound_by=by,
             any_shape_device_ms=device_ms(c["any_shape"]), **t,
             **int_body(ti, bound_ms=b, bound_by=by))
    print(body_line("int_rmsnorm_fwd", k))
    k["rows"] = check_norm_fwd_shapes(
        torch, dev, gen, False, R, D,
        [(f"11b qwen1.5-0.5b training 2048x{D}", 2048, D),
         (f"11c qwen2-moe-a2.7b training 2048x{D_moe}", 2048, D_moe),
         (f"11d decode 4x{D}", 4, D)])
    return k


#: attention forward shapes held on the card: name -> (B, Sq, Sk, KV, G,
#: hd, offsets, causal, window, q/k planes, v planes); v planes 2 means P
#: at 12 bits, 3 at 16
ATTN_FWD_SHAPES = {
    "decode": (4, 1, 256, 16, 1, 64, [64, 65, 66, 67], True, None, 2, 2),
    "prefill": (4, 64, 256, 16, 1, 64, 0, True, None, 2, 2),
    "qwen1.5-0.5b train": (8, 256, 256, 16, 1, 64, 0, True, None, 2, 2),
    "smollm-135m gqa": (8, 256, 256, 3, 3, 64, 0, True, None, 2, 2),
    "ragged + window": (2, 20, 150, 2, 2, 16, [100, 37], True, 40, 2, 2),
    "qwen2-moe-a2.7b train (hd 128)": (8, 256, 256, 16, 1, 128, 0, True,
                                       None, 2, 2),
    "head dim 256, 3 limbs": (8, 256, 256, 4, 1, 256, 0, True, None, 3, 3),
    "head dim 384": (8, 256, 256, 4, 1, 384, 0, True, None, 2, 2),
}


def ptxas_entries(pattern: str = "") -> list:
    """(kernel, registers / shared memory line, spill line) of each
    instantiation in the build's ptxas report whose name matches."""
    from repro_torch.kernels import _lib
    out, name, spill = [], "?", ""
    for line in _lib.ptxas_report().splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and re.match(pattern, name):
            out.append((name, line.split(":", 1)[1].strip(), spill))
    return out


def _dequant(x, e):
    """Σ_j plane_j · 2^(7j) · 2^e in f32 (the value the planes encode)."""
    from repro_torch.core import dfx
    return sum(x[j].float() * 128.0 ** j for j in range(x.shape[0])) * \
        dfx.pow2(e)


def check_attention(torch, dev, gen, cfg):
    """int_attn_fwd against its plain version at ATTN_FWD_SHAPES (decode: 4
    slots, one query each at positions 64..67 over a 256-deep cache;
    prefill: 64 queries from position 0 over it; the training steps' calls,
    causal from position 0; a ragged windowed case; head dim 256 at 3
    limbs and head dim 384, the direct body), FP32 and kept-int bodies:
    o within 1e-5 of max|o| and lse within 1e-4 (the same expf and the same
    ordered f32 sums on both sides; the max abs errors are reported).
    Timed at decode, the qwen1.5-0.5b training shape (24 calls a step; both
    bodies), qwen2-moe-a2.7b's head dim 128 and head dim 384, each beside
    SDPA's f32 forward on the dequantized values with the same mask (its
    kv heads repeated for GQA).  Bound: the bytes of the planes and
    outputs, or the int8 operations of the limb-pair products over the
    (query, key) pairs the mask lets through, whichever is larger."""
    import torch.nn.functional as F
    from repro_torch.kernels import int_attention as ia
    exps = torch.tensor([-9, -9, -8], dtype=torch.int32, device=dev)
    err = {False: 0.0, True: 0.0}
    runs = {}
    for label, shape in ATTN_FWD_SHAPES.items():
        B, Sq, Sk, KV, G, hd, off, causal, window, lqk, lv = shape
        q = _planes(torch, gen, dev, lqk, B, Sq, KV, G, hd)
        k = _planes(torch, gen, dev, lqk, B, Sk, KV, hd)
        v = _planes(torch, gen, dev, lv, B, Sk, KV, hd)
        qo = torch.tensor(off if isinstance(off, list) else [off] * B,
                          dtype=torch.int32, device=dev)
        kw = dict(p_bits=12 if lv == 2 else 16, causal=causal, window=window,
                  sc=1.0 / hd ** 0.5)
        line = []
        for iexp in (False, True):
            o, lse = ia.int_attn_fwd(q, k, v, qo, exps, **kw,
                                     integer_exp=iexp)
            o0, lse0 = ia.int_attn_fwd_plain(q, k, v, qo, exps, **kw,
                                             integer_exp=iexp)
            e_o = (o - o0).abs().max().item()
            e_l = (lse - lse0).abs().max().item()
            scale = o0.abs().max().item()
            if not (scale > 0 and e_o <= 1e-5 * scale and e_l <= 1e-4):
                raise AssertionError(
                    f"int_attn_fwd (integer_exp={iexp}) differs at {label}: "
                    f"o max|err| {e_o} of max {scale}, lse {e_l}")
            err[iexp] = max(err[iexp], e_o)
            line.append(f"{'kept-int' if iexp else 'FP32'} o max|err| "
                        f"{e_o:.3e} of {scale:.3e}, lse {e_l:.3e}")
            if not iexp:
                runs[label] = (shape, q, k, v, qo, kw, o, lse)
        print(f"  attention forward at {label} {shape[:6]}, {lqk}/{lv} "
              "planes: " + "; ".join(line))
    for name, used, spill in ptxas_entries(r"fwd_"):
        print(f"  ptxas {name}: {used}; {spill}")

    def measure(label, kept_int=False):
        """Timings (kernel, plain, SDPA) and the bound at one shape; with
        ``kept_int`` also the integer body's (int_*)."""
        shape, q, k, v, qo, kw, o, lse = runs[label]
        B, Sq, Sk, KV, G, hd, off, causal, window, lqk, lv = shape
        qs = _dequant(q, exps[0]).reshape(B, Sq, KV * G, hd).transpose(1, 2)
        ks, vs = (_dequant(x, e).repeat_interleave(G, dim=2).transpose(1, 2)
                  for x, e in ((k, exps[1]), (v, exps[2])))
        qpos = qo[:, None] + torch.arange(Sq, device=dev)        # (B, Sq)
        kpos = torch.arange(Sk, device=dev)
        seen = kpos <= qpos[..., None] if causal else \
            torch.ones((B, Sq, Sk), dtype=torch.bool, device=dev)
        if window is not None:
            seen = seen & (kpos > qpos[..., None] - window)
        # the library's fastest form of the same mask: is_causal where the
        # mask is the plain causal one, else the boolean mask itself
        plain_causal = (causal and window is None and Sq == Sk
                        and not bool(qo.any()))
        mask = None if plain_causal else seen[:, None]

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  is_causal=plain_causal)
        t = timings(lambda: ia.int_attn_fwd(q, k, v, qo, exps, **kw),
                    lambda: ia.int_attn_fwd_plain(q, k, v, qo, exps, **kw),
                    library)
        # bytes and int8 ops these inputs need: each (query, key) pair the
        # mask lets through, every limb pair of QK^T and of PV
        pairs = int(seen.sum()) * KV * G
        need_keys = int(seen.any(1).sum()) * KV                  # K/V rows
        n_bytes = (nbytes(q, qo, exps, o, lse)
                   + (k.shape[0] + v.shape[0]) * need_keys * hd)
        b, by = bound_ms(n_bytes, 2 * pairs * hd * (lqk * lqk + lv * lv))
        t.update(bound_ms=b, bound_by=by)
        if kept_int:
            ki = dict(kw, integer_exp=True)
            t.update(int_body(timings(
                lambda: ia.int_attn_fwd(q, k, v, qo, exps, **ki),
                lambda: ia.int_attn_fwd_plain(q, k, v, qo, exps, **ki),
                library), bound_ms=b, bound_by=by))
        print(f"  int_attn_fwd at {label}: call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms; plain device "
              f"{t['plain_device_ms']:.4f}; SDPA forward (f32) device "
              f"{t['library_device_ms']:.4f}; bound {b:.4f} ms ({by})")
        return t

    t = measure("decode", kept_int=True)
    tt = measure("qwen1.5-0.5b train", kept_int=True)
    tm = measure("qwen2-moe-a2.7b train (hd 128)")
    tw = measure("head dim 384")
    B, Sq, Sk, KV, G, hd = ATTN_FWD_SHAPES["decode"][:6]
    out = dict(name="int_attn_fwd", route="cuda",
               source="src/repro_torch/csrc/int_attention.cu",
               replaces="src/repro/kernels/int_attention.py:217",
               shape=f"decode q ({B},{Sq},{KV},{G},{hd}) over k/v ({B},{Sk},"
                     f"{KV},{hd}), 2 limbs; also timed at the qwen1.5-0.5b "
                     "training shape (8,256) causal (train_*), qwen2-moe's "
                     "head dim 128 (moe_*) and head dim 384 (hd384_*, the "
                     "direct body); the kept-int body (int_*, train_int_*) "
                     "at decode and the training shape; both bodies held at "
                     + ", ".join(ATTN_FWD_SHAPES) + "; tolerance o 1e-5 "
                     "relative, lse 1e-4 absolute; library: SDPA forward "
                     "(f32)",
               max_abs_err=err[False], int_max_abs_err=err[True], **t,
               **{f"train_{k_}": v_ for k_, v_ in tt.items()},
               **{f"moe_{k_}": v_ for k_, v_ in tm.items()},
               **{f"hd384_{k_}": v_ for k_, v_ in tw.items()})
    print(body_line("int_attn_fwd", out))
    print(body_line("int_attn_fwd", out, "train_"))
    return out


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
             [(g[0], w[0].t().contiguous())]),
            ("bfp_matmul_tn", bm.bfp_matmul_tn, bm.bfp_matmul_tn_plain,
             [(x, g), (xp, gh), (xp, xp[:1])],
             [(xj.t().contiguous(), g[0]) for xj in x])):
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
                    lambda: [torch._int_mm(*ab) for ab in lib_args])
        n_ops = 2 * tokens * D * F * a.shape[0] * b.shape[0]
        bd, by = bound_ms(nbytes(a, b, e, res), n_ops)
        what = ("dX: G (%d,%d) . W (%d,%d)^T, 1x1 limbs" % (tokens, F, D, F)
                if name == "bfp_matmul_nt" else
                "dW: X (%d,%d)^T . G (%d,%d), 2x1 limbs" % (tokens, D, tokens, F))
        col = [(x, _colmajor(y)) for x, y in lib_args]
        rows = [mm_row(("4 " if name == "bfp_matmul_nt" else "5 ") + what,
                       lambda: fn(a, b, e), n_ops, nbytes(a, b, e, res),
                       {"int_mm": lambda: [torch._int_mm(*ab)
                                           for ab in lib_args],
                        "int_mm_colmajor": lambda: [torch._int_mm(*ab)
                                                    for ab in col]})]
        rows += _matmul_bwd_train_rows(torch, dev, gen, name, fn, plain, e)
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/bfp_matmul.cu",
            replaces=("src/repro/kernels/bfp_matmul.py:176"
                      if name == "bfp_matmul_nt" else
                      "src/repro/kernels/bfp_matmul.py:210"),
            shape=f"{what}, tolerance exact; library: torch._int_mm per "
                  "limb pair (operands made contiguous beforehand)",
            max_abs_err=err, bound_ms=bd, bound_by=by, rows=rows, **t))
    return out


def _matmul_bwd_train_rows(torch, dev, gen, name, fn, plain, e):
    """NT / TN held exactly and timed at qwen1.5-0.5b's training shapes
    (batch 8 x seq 256, d_model 1024, d_ff 2816): the MLP's dX, G (2048 x
    2816) . W (1024 x 2816)^T at 1x1, and its dW, X (2048 x 1024)^T . G
    (2048 x 2816) at 2x1; for TN also the tied head's dE, G (2048 x V)^T .
    X (2048 x 1024) at 1x2."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get_config("qwen1.5-0.5b")
    D, F, T, V = cfg.d_model, cfg.d_ff, 8 * 256, lm.padded_vocab(cfg)

    def pl(L, *shape):
        return _planes(torch, gen, dev, L, *shape)
    rows = []
    if name == "bfp_matmul_nt":
        g, w = pl(1, T, F), pl(1, D, F)
        _held(name, fn(g, w, e), plain(g, w, e), "the qwen MLP dX")
        wt = w[0].t().contiguous()
        rows.append(mm_row(
            f"qwen train NT {T}x{F} . ({D}x{F})^T 1x1", lambda: fn(g, w, e),
            2 * T * F * D, nbytes(g, w) + 4 * T * D,
            {"int_mm": lambda: torch._int_mm(g[0], wt),
             "int_mm_colmajor": lambda: torch._int_mm(g[0], w[0].t())}))
        return rows
    x, g = pl(2, T, D), pl(1, T, F)
    _held(name, fn(x, g, e), plain(x, g, e), "the qwen MLP dW")
    xt = [xj.t().contiguous() for xj in x]
    gc = _colmajor(g[0])
    rows.append(mm_row(
        f"qwen train TN ({T}x{D})^T . {T}x{F} 2x1", lambda: fn(x, g, e),
        2 * T * D * F * 2, nbytes(x, g) + 4 * D * F,
        {"int_mm": lambda: [torch._int_mm(xj, g[0]) for xj in xt],
         "int_mm_colmajor": lambda: [torch._int_mm(xj, gc) for xj in xt]}))
    gh = pl(1, T, V)
    _held(name, fn(gh, x, e), plain(gh, x, e), "the tied head's dE")
    ght = gh[0].t().contiguous()
    xc = [_colmajor(xj) for xj in x]
    rows.append(mm_row(
        f"tied head dE ({T}x{V})^T . {T}x{D} 1x2", lambda: fn(gh, x, e),
        2 * T * V * D * 2, nbytes(gh, x) + 4 * V * D,
        {"int_mm": lambda: [torch._int_mm(ght, xj) for xj in x],
         "int_mm_colmajor": lambda: [torch._int_mm(ght, xj) for xj in xc]}))
    return rows


def check_layernorm(torch, dev, gen, D, R):
    """int_layernorm_fwd / _bwd at the bert-base fine-tuning step's shape:
    R = 4096 rows (batch 32 x seq 128) of D = 768 int16 mantissas (a12),
    int8 gradient mantissas (g8); the backward also at the span step's
    4608 rows (``ln_bwd_case``), the forward there too (a sub-row) and
    held as ``norm_fwd_case`` holds it."""
    c = norm_fwd_case(torch, dev, gen, True, R, D)
    b, by = c["bound"]
    fwd = dict(name="int_layernorm_fwd", route="cuda",
               source="src/repro_torch/csrc/int_norm.cu",
               replaces="src/repro/kernels/int_norm.py:113",
               shape=f"({R},{D}) int16 -> y, mu, rstd; tolerance stats 4 ulp,"
                     " y 1e-6 of max; kept-int body (int_*): mu and rstd "
                     "exact, y 1e-6 of max; both bodies bit for bit with the "
                     "any-shape body; library: F.layer_norm on the f32 "
                     f"values; rows: the span step's {SPAN_ROWS} x {D}",
               max_abs_err=c["max_abs_err"], bound_ms=b, bound_by=by,
               any_shape_device_ms=device_ms(c["any_shape"]),
               **timings(c["wrap"], c["plain"], c["library"]))
    fwd.update(int_body(
        timings(lambda: c["wrap"](True), lambda: c["plain"](True)),
        bound_ms=b, bound_by=by))
    print(body_line("int_layernorm_fwd", fwd))
    fwd["rows"] = check_norm_fwd_shapes(
        torch, dev, gen, True, R, D,
        [(f"9b bert-base span {SPAN_ROWS}x{D}", SPAN_ROWS, D)])
    bwd = dict(name="int_layernorm_bwd", route="cuda",
               source="src/repro_torch/csrc/int_norm.cu",
               replaces="src/repro/kernels/int_norm.py:181",
               shape=f"({R},{D}) int16 x, int8 g -> dx, dgamma, dbeta; also "
                     f"the span step's ({SPAN_ROWS},{D}) (span_*); "
                     "tolerance dbeta exact, dx 64 ulp of max, dgamma 64 ulp "
                     "of the column's sum of |gq xn|; two calls bit for bit; "
                     "library: aten.native_layer_norm_backward on the f32 "
                     "values",
               **ln_bwd_case(torch, dev, gen, R, D),
               **{f"span_{k}": v for k, v in ln_bwd_case(
                   torch, dev, gen, SPAN_ROWS, D).items()})
    return [fwd, bwd]


#: bert-base's span fine-tuning step: batch 12 x seq 384 rows
SPAN_ROWS = 12 * 384


def ln_bwd_case(torch, dev, gen, R, D) -> dict:
    """int_layernorm_bwd on (R, D) int16 mantissas (a12) and int8 gradient
    mantissas (g8), the statistics from the plain forward: dbeta exactly,
    dx within 64 ulp of max|dx|, dgamma within 64 ulp of the column's
    Σ|gq·xn| (f32 sums in another order); timed beside its bound and
    aten.native_layer_norm_backward."""
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
    _, mu0, rstd0 = int_norm.int_layernorm_fwd_plain(xm, xe, gamma, beta)
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
            f"int_layernorm_bwd differs at ({R},{D}): dx "
            f"{(dx - dx0).abs().max().item()}, dgamma "
            f"{(dg - dg0).abs().max().item()}, dbeta exact "
            f"{torch.equal(db, db0)}")
    xv = xm.float() * dfx.pow2(xe)
    gq = gm.float() * dfx.pow2(ge)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(xv, [D], gamma, beta,
                                                       1e-5)
    t = norm_bwd_timings(
        torch, f"int_layernorm_bwd ({R},{D})",
        lambda: int_norm.int_layernorm_bwd(xm, gm, xe, ge, gamma, mu0,
                                           rstd0),
        lambda: int_norm.int_layernorm_bwd_plain(xm, gm, xe, ge, gamma, mu0,
                                                 rstd0),
        lambda: torch.ops.aten.native_layer_norm_backward(
            gq, xv, [D], lmean, lrstd, gamma, beta, [True, True, True]))
    # per element: xn (3), gq, gg, two row sums (3), dx (4), dgamma (2)
    b, by = bound_ms(nbytes(xm, gm, xe, ge, gamma, mu0, rstd0, dx, dg, db),
                     0, 14 * R * D)
    return dict(max_abs_err=max((dx - dx0).abs().max().item(),
                                (dg - dg0).abs().max().item()),
                bound_ms=b, bound_by=by, **t)


def check_rmsnorm_bwd(torch, dev, gen, R, D, D_moe):
    """int_rmsnorm_bwd at the qwen1.5-0.5b training step's shape: R = 2048
    rows (batch 8 x seq 256) of D = 1024 int16 mantissas (a12), int8
    gradient mantissas (g8); also at qwen2-moe-a2.7b's D_moe = 2048
    (``moe_*``)."""
    return dict(name="int_rmsnorm_bwd", route="cuda",
                source="src/repro_torch/csrc/int_norm.cu",
                replaces="src/repro/kernels/int_norm.py:298",
                shape=f"({R},{D}) int16 x, int8 g -> dx, dgamma; also "
                      f"qwen2-moe's ({R},{D_moe}) (moe_*); tolerance dx 64 "
                      "ulp of its row's max, dgamma 64 ulp of the column's "
                      "sum of |gq xn|; two calls bit for bit; library: "
                      "F.rms_norm backward (autograd) on the f32 values",
                **rms_bwd_case(torch, dev, gen, R, D),
                **{f"moe_{k}": v for k, v in rms_bwd_case(
                    torch, dev, gen, R, D_moe).items()})


def rms_bwd_case(torch, dev, gen, R, D) -> dict:
    """int_rmsnorm_bwd on (R, D) int16 / int8 mantissas, rstd from the
    kernel's forward.  Tolerances: dx within 64 ulp of its row's max|dx|,
    dγ within 64 ulp of the column's Σ|gq·xn| (f32 sums in another
    order); timed beside its bound and F.rms_norm's backward."""
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
            f"int_rmsnorm_bwd differs at ({R},{D}): dx "
            f"{(dx - dx0).abs().max().item()}, dgamma "
            f"{(dg - dg0).abs().max().item()}")
    # yardstick: the backward of F.rms_norm on the f32 values (autograd,
    # the graph built once and its backward timed)
    xr = xv.clone().requires_grad_(True)
    gr = gamma.clone().requires_grad_(True)
    yr = F.rms_norm(xr, (D,), gr, 1e-6)
    t = norm_bwd_timings(
        torch, f"int_rmsnorm_bwd ({R},{D})",
        lambda: int_norm.int_rmsnorm_bwd(xm, gm, xe, ge, gamma, rstd),
        lambda: int_norm.int_rmsnorm_bwd_plain(xm, gm, xe, ge, gamma, rstd),
        lambda: torch.autograd.grad(yr, (xr, gr), gq, retain_graph=True))
    # per element: xn (2), gq, gg, the row sum (2), dx (3), dgamma (2)
    b, by = bound_ms(nbytes(xm, gm, xe, ge, gamma, rstd, dx, dg), 0,
                     11 * R * D)
    return dict(max_abs_err=max((dx - dx0).abs().max().item(),
                                (dg - dg0).abs().max().item()),
                bound_ms=b, bound_by=by, **t)


#: attention backward shapes held on the card: name -> (B, Sq, Sk, KV, G,
#: hd, offsets, causal, window)
ATTN_BWD_SHAPES = {
    "bert-base cls": (32, 128, 128, 12, 1, 64, 0, False, None),
    "qwen1.5-0.5b train": (8, 256, 256, 16, 1, 64, 0, True, None),
    "smollm-135m gqa": (8, 256, 256, 3, 3, 64, 0, True, None),
    "ragged + window": (2, 20, 150, 2, 2, 16, [100, 37], True, 40),
    "qwen2-moe-a2.7b train": (8, 256, 256, 16, 1, 128, 0, True, None),
    "head dim 256 (widest body)": (8, 256, 256, 4, 1, 256, 0, True, None),
    "head dim 384": (8, 256, 256, 4, 1, 384, 0, True, None),
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
    ATTN_BWD_SHAPES (int8 preset), FP32 and kept-int bodies, timed at the
    qwen1.5-0.5b training shape (the kept-int body too: int_*) and,
    beside it, at qwen2-moe-a2.7b's (head dim 128; moe_*) and at head dim
    256 (the widest body; hd256_*).  Tolerance: exact (the same expf or
    i_exp, the same exact int32 limb-pair dots and the same ordered f32
    sums on both sides).  Library: SDPA's f32
    backward at the same shape (dq, dk and dv together).  Bound: the bytes
    of the planes, rows and outputs, or the int8 operations of the
    limb-pair products over the (query, key) pairs the mask lets through,
    whichever is larger."""
    import torch.nn.functional as F
    from repro_torch.kernels import int_attention as ia
    errs = {"int_attn_bwd_dq": 0.0, "int_attn_bwd_dkv": 0.0}
    timed = {}
    for label, shape in ATTN_BWD_SHAPES.items():
        B, Sq, Sk, KV, G, hd, off, causal, window = shape
        q, k, v, g, lse, delta, qo, exps = _attn_bwd_inputs(torch, dev, gen,
                                                            shape)
        for iexp in (False, True):
            kw = dict(ds_bits=8, causal=causal, window=window,
                      sc=1.0 / hd ** 0.5, integer_exp=iexp)
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
                if not scale > 0 or not torch.equal(got, ref):
                    raise AssertionError(
                        f"int_attn_bwd {name} (integer_exp={iexp}) differs "
                        f"at {label}: {int((got != ref).sum())} elements, "
                        f"max {err} of max {scale}")
                key = ("int_attn_bwd_dq" if name == "dq" else
                       "int_attn_bwd_dkv") + (" int" if iexp else "")
                errs[key] = max(errs.get(key, 0.0), err)
                line.append(f"{name} max|err| {err:.3e} of max {scale:.3e}, "
                            f"{int((got != ref).sum())} elements differ")
            print(f"  attention backward ({'kept-int' if iexp else 'FP32'} "
                  f"body) at {label} {shape[:6]}: " + "; ".join(line))
            if not iexp and label in ("qwen1.5-0.5b train",
                                      "qwen2-moe-a2.7b train",
                                      "head dim 256 (widest body)",
                                      "head dim 384"):
                timed[label] = (shape, q, k, v, g, lse, delta, qo, exps, kw,
                                dq, dk, dv)

    def measure(shape, q, k, v, g, lse, delta, qo, exps, kw, dq, dk, dv,
                kept_int=False):
        """{name: timings and bound} of both kernels at one shape, with
        SDPA's f32 backward (autograd, its graph built once) beside them;
        with ``kept_int`` also the kept-int bodies' timings (int_*)."""
        B, Sq, Sk, KV, G, hd, off, causal, window = shape
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
        pairs = (B * KV * G * Sq * (Sq + 1) // 2 if causal
                 else B * KV * G * Sq * Sk)
        rows = nbytes(lse, delta)
        res = {}
        for name, fn, plain, outs, limb_pairs in (
                ("int_attn_bwd_dq",
                 lambda: ia.int_attn_bwd_dq(q, k, v, g, lse, delta, qo, exps,
                                            p_bits=12, **kw),
                 lambda: ia.int_attn_bwd_dq_plain(q, k, v, g, lse, delta, qo,
                                                  exps, **kw),
                 (dq,), 4 + 2 + 2),
                ("int_attn_bwd_dkv",
                 lambda: ia.int_attn_bwd_dkv(q, k, v, g, lse, delta, qo,
                                             exps, p_bits=12, **kw),
                 lambda: ia.int_attn_bwd_dkv_plain(q, k, v, g, lse, delta,
                                                   qo, exps, p_bits=12, **kw),
                 (dk, dv), 4 + 2 + 2 + 2)):
            # s (2x2 limb pairs), dp (1x2), and dq (1x2) or dk (1x2) + dv
            # (2x1)
            b, by = bound_ms(nbytes(q, k, v, g, qo, exps, *outs) + rows,
                             2 * hd * pairs * limb_pairs)
            res[name] = {**timings(fn, plain), **lib_t, "bound_ms": b,
                         "bound_by": by}
        if kept_int:
            ki = dict(kw, integer_exp=True)
            res["int_attn_bwd_dq"].update(int_body(timings(
                lambda: ia.int_attn_bwd_dq(q, k, v, g, lse, delta, qo, exps,
                                           p_bits=12, **ki),
                lambda: ia.int_attn_bwd_dq_plain(q, k, v, g, lse, delta, qo,
                                                 exps, **ki)),
                bound_ms=res["int_attn_bwd_dq"]["bound_ms"],
                bound_by=res["int_attn_bwd_dq"]["bound_by"]))
            res["int_attn_bwd_dkv"].update(int_body(timings(
                lambda: ia.int_attn_bwd_dkv(q, k, v, g, lse, delta, qo,
                                            exps, p_bits=12, **ki),
                lambda: ia.int_attn_bwd_dkv_plain(q, k, v, g, lse, delta, qo,
                                                  exps, p_bits=12, **ki)),
                bound_ms=res["int_attn_bwd_dkv"]["bound_ms"],
                bound_by=res["int_attn_bwd_dkv"]["bound_by"]))
        return res

    main = measure(*timed["qwen1.5-0.5b train"], kept_int=True)
    moe = measure(*timed["qwen2-moe-a2.7b train"])
    wide = measure(*timed["head dim 256 (widest body)"])
    wide384 = measure(*timed["head dim 384"])
    shape = ATTN_BWD_SHAPES["qwen1.5-0.5b train"]
    B, Sq, Sk, KV, G, hd = shape[:6]
    out_k = []
    for name in ("int_attn_bwd_dq", "int_attn_bwd_dkv"):
        for what, m in (("qwen2-moe-a2.7b train (hd 128)", moe[name]),
                        ("head dim 256", wide[name]),
                        ("head dim 384 (direct body)", wide384[name])):
            print(f"  {name} at {what}: call {m['ms']:.4f} ms, device "
                  f"{m['device_ms']:.4f} ms; SDPA backward device "
                  f"{m['library_device_ms']:.4f}; bound {m['bound_ms']:.4f} "
                  f"ms ({m['bound_by']})")
        print(body_line(name, main[name]))
        out_k.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/int_attention_bwd.cu",
            replaces=("src/repro/kernels/int_attention.py:328"
                      if name == "int_attn_bwd_dq" else
                      "src/repro/kernels/int_attention.py:441"),
            shape=f"qwen1.5-0.5b training: q/g ({B},{Sq},{KV},{G},{hd}), "
                  f"k/v ({B},{Sk},{KV},{hd}), 2 planes (g 1), causal, dS 8 "
                  "bits, P 12 bits; the kept-int body timed there too "
                  "(int_*); also timed at qwen2-moe-a2.7b's head dim 128 "
                  "(moe_*), at head dim 256 (hd256_*) and at head dim 384 "
                  "(hd384_*, the direct body); both bodies held "
                  "at " + ", ".join(ATTN_BWD_SHAPES)
                  + "; tolerance exact; library: SDPA backward (f32, "
                  "autograd, dq + dk + dv)",
            max_abs_err=errs[name], int_max_abs_err=errs[name + " int"],
            **main[name],
            **{f"moe_{k_}": v_ for k_, v_ in moe[name].items()},
            **{f"hd256_{k_}": v_ for k_, v_ in wide[name].items()},
            **{f"hd384_{k_}": v_ for k_, v_ in wide384[name].items()}))
    return out_k


#: qwen2-moe-a2.7b training depth in phase 8 (of 24 layers): the deepest
#: that leaves 10% of the card's memory spare
MOE_TRAIN_LAYERS = 6

#: qwen2-moe-a2.7b training step's capacity rows per expert (batch 8 x seq
#: 256, top-4 of 60: ceil128(1.25 * 8192 / 60)) and its decode's (4 slots
#: x top-4, drop-free)
MOE_TRAIN_ROWS, MOE_DECODE_ROWS = 256, 16


def check_quantize_grouped(torch, dev, gen, moe):
    """dfx_quantize_grouped at the MoE path's shapes (qwen2-moe-a2.7b, E =
    60): timed at its largest call, one expert weight stack (60, 2048, 1408)
    f32 -> 8-bit planes, quantized before every product; also held exactly:
    the training step's expert input (60, 256, 2048) at a12 into 2 planes
    and as the logical int16 mantissa, one expert empty (an all-zero slice),
    its upstream gradient (60, 256, 1408) at g8 with ``u``, and the weight
    stack's logical int8 mantissa."""
    from repro_torch.core import dfx
    from repro_torch.kernels import dfx_quant as dq
    E, D, F, C = moe.moe_experts, moe.d_model, moe.d_ff, MOE_TRAIN_ROWS
    w = torch.randn((E, D, F), generator=gen, device=dev) * 0.02
    act = torch.randn((E, C, D), generator=gen, device=dev)
    act[5] = 0
    grad = torch.randn((E, C, F), generator=gen, device=dev) * 1e-6
    u = torch.rand((E, C, F), generator=gen, device=dev)
    err = 0.0
    for x, bits, limbs, uu in ((w, 8, True, None), (w, 8, False, None),
                               (act, 12, True, None), (act, 12, False, None),
                               (grad, 8, True, u)):
        e = dfx.slice_exponents(x) - (bits - 1)
        got = dq.dfx_quantize_grouped(x, e, bits=bits, u=uu,
                                      limb_planes=limbs)
        ref = dq.dfx_quantize_grouped_plain(x, e, bits=bits, u=uu,
                                            limb_planes=limbs)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"dfx_quantize_grouped differs from its plain version at "
                f"{tuple(x.shape)} bits={bits} limb_planes={limbs} "
                f"stochastic={uu is not None}")
        err = max(err, (got.float() - ref.float()).abs().max().item())
    we = dfx.slice_exponents(w) - 7
    out = dq.dfx_quantize_grouped(w, we, bits=8, limb_planes=True)
    # yardstick: PyTorch's per-channel int8 quantize along the expert axis
    # at the same power-of-two scales (it clamps at -128, the kernel at
    # -127)
    scales = dfx.pow2(we).double()
    zeros = torch.zeros(E, dtype=torch.int64, device=dev)
    t = timings(lambda: dq.dfx_quantize_grouped(w, we, bits=8,
                                                limb_planes=True),
                lambda: dq.dfx_quantize_grouped_plain(w, we, bits=8,
                                                      limb_planes=True),
                lambda: torch.quantize_per_channel(w, scales, zeros, 0,
                                                   torch.qint8))
    b, by = bound_ms(nbytes(w, we, out), 0)
    return dict(name="dfx_quantize_grouped", route="cuda",
                source="src/repro_torch/csrc/dfx_quant.cu",
                replaces="src/repro/kernels/dfx_quant.py:201",
                shape=f"expert weight stack ({E},{D},{F}) f32 -> one 8-bit "
                      f"plane, per-expert exponents; tolerance exact (also "
                      f"held exactly: ({E},{C},{D}) a12 planes and int16 "
                      f"with an empty expert, ({E},{C},{F}) g8 planes with "
                      "u); library: torch.quantize_per_channel to qint8 "
                      "along the expert axis",
                max_abs_err=err, bound_ms=b, bound_by=by, **t)


def check_matmul_batched(torch, dev, gen, moe):
    """bfp_matmul_batched{,_nt,_tn} at the MoE path's shapes (qwen2-moe-
    a2.7b: E = 60, d_model 2048, expert d_ff 1408), per-expert exponents:
    NN timed at the training step's wg_e forward (60 x 256 x 2048 x 1408,
    2x1 limbs) and its decode (16 rows per expert), also held at wd_e's
    forward; NT at wg_e's dX (1x1) and wd_e's; TN at wg_e's dW (2x1,
    contracting the 256 capacity rows) and wd_e's.  Library: 60 calls of
    torch._int_mm for each limb pair the kernel computes (operands made
    contiguous beforehand), summed."""
    from repro_torch.kernels import bfp_matmul as bm
    E, D, F, C = moe.moe_experts, moe.d_model, moe.d_ff, MOE_TRAIN_ROWS
    e = torch.arange(E, dtype=torch.int32, device=dev) - 40

    def pl(L, *shape):
        return _planes(torch, gen, dev, L, *shape)
    x, wg, g = pl(2, E, C, D), pl(1, E, D, F), pl(1, E, C, F)
    xd = pl(2, E, MOE_DECODE_ROWS, D)
    h, wd, gd = pl(2, E, C, F), pl(1, E, F, D), pl(1, E, C, D)
    xs = [xj.contiguous() for xj in x]
    w0, g0 = wg[0].contiguous(), g[0].contiguous()
    w0t = wg[0].transpose(1, 2).contiguous()
    xts = [xj.transpose(1, 2).contiguous() for xj in x]
    out = []
    w0c = [_colmajor(w0[i]) for i in range(E)]
    g0c = [_colmajor(g0[i]) for i in range(E)]
    for name, fn, plain, cases, lib, lib_col, line, contract in (
            ("bfp_matmul_batched", bm.bfp_matmul_batched,
             bm.bfp_matmul_batched_plain, [(x, wg), (xd, wg), (h, wd)],
             lambda: [torch._int_mm(xj[i], w0[i]) for xj in xs
                      for i in range(E)],
             lambda: [torch._int_mm(xj[i], w0c[i]) for xj in xs
                      for i in range(E)],
             "302", D),
            ("bfp_matmul_batched_nt", bm.bfp_matmul_batched_nt,
             bm.bfp_matmul_batched_nt_plain, [(g, wg), (gd, wd)],
             lambda: [torch._int_mm(g0[i], w0t[i]) for i in range(E)],
             lambda: [torch._int_mm(g0[i], w0[i].t()) for i in range(E)],
             "332", F),
            ("bfp_matmul_batched_tn", bm.bfp_matmul_batched_tn,
             bm.bfp_matmul_batched_tn_plain, [(x, g), (h, gd)],
             lambda: [torch._int_mm(xj[i], g0[i]) for xj in xts
                      for i in range(E)],
             lambda: [torch._int_mm(xj[i], g0c[i]) for xj in xts
                      for i in range(E)],
             "362", C)):
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
        t = timings(lambda: fn(a, b, e), lambda: plain(a, b, e), lib)
        n_ops = 2 * res.numel() * contract * a.shape[0] * b.shape[0]
        bd, by = bound_ms(nbytes(a, b, e, res), n_ops)
        label = {"bfp_matmul_batched": "6 batched NN, MoE train",
                 "bfp_matmul_batched_nt": "7 batched NT, MoE dX",
                 "bfp_matmul_batched_tn": "8 batched TN, MoE dW"}[name]
        k = dict(name=name, route="cuda",
                 source="src/repro_torch/csrc/bfp_matmul.cu",
                 replaces=f"src/repro/kernels/bfp_matmul.py:{line}",
                 max_abs_err=err, bound_ms=bd, bound_by=by,
                 rows=[mm_row(label, lambda: fn(a, b, e), n_ops,
                              nbytes(a, b, e, res),
                              {"int_mm": lib, "int_mm_colmajor": lib_col})],
                 **t)
        if name == "bfp_matmul_batched":
            k["shape"] = (f"wg_e forward ({E},{C},{D})x({E},{D},{F}), 2x1 "
                          f"limbs, tolerance exact (also held exactly: "
                          f"decode {MOE_DECODE_ROWS} rows per expert, wd_e "
                          f"({E},{C},{F})x({E},{F},{D})); library: 2 x {E} x "
                          "torch._int_mm (one per limb pair), summed")
            xd_ms = device_ms(lambda: fn(xd, wg, e))
            dres = fn(xd, wg, e)
            db, dby = bound_ms(nbytes(xd, wg, e, dres),
                               2 * dres.numel() * D * 2)
            # yardstick: torch._int_mm per expert and limb pair, the 16
            # decode rows zero-padded to 17 (it needs more than 16)
            xds = [torch.nn.functional.pad(xj, (0, 0, 0, 1)).contiguous()
                   for xj in xd]
            d_lib = device_ms(lambda: [torch._int_mm(xj[i], w0[i])
                                       for xj in xds for i in range(E)])
            k.update(decode_ms=cuda_ms(lambda: fn(xd, wg, e)),
                     decode_device_ms=xd_ms, decode_bound_ms=db,
                     decode_library_device_ms=d_lib)
            k["rows"].append(mm_row(
                f"6b batched NN, MoE decode ({E},{MOE_DECODE_ROWS},{D})x"
                f"({E},{D},{F}) 2x1", lambda: fn(xd, wg, e),
                2 * dres.numel() * D * 2, nbytes(xd, wg, e, dres),
                {"int_mm": lambda: [torch._int_mm(xj[i], w0[i])
                                    for xj in xds for i in range(E)],
                 "int_mm_colmajor": lambda: [torch._int_mm(xj[i], w0c[i])
                                             for xj in xds
                                             for i in range(E)]}))
            print(f"  bfp_matmul_batched decode ({E},{MOE_DECODE_ROWS},{D})"
                  f"x({E},{D},{F}), 2x1 limbs: device {xd_ms:.4f} ms, bound "
                  f"{db:.4f} ms ({dby}); library 2 x {E} x torch._int_mm "
                  f"(17 rows) device {d_lib:.4f} ms")
        elif name == "bfp_matmul_batched_nt":
            k["shape"] = (f"wg_e dX: G ({E},{C},{F}) . W ({E},{D},{F})^T, "
                          f"1x1 limbs, tolerance exact (also held: wd_e's "
                          f"dX); library: {E} x torch._int_mm, summed")
        else:
            k["shape"] = (f"wg_e dW: X ({E},{C},{D})^T . G ({E},{C},{F}), "
                          f"2x1 limbs, tolerance exact (also held: wd_e's "
                          f"dW); library: 2 x {E} x torch._int_mm (one per "
                          "limb pair), summed")
        out.append(k)
    return out


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
    (integer attention forward and backward) and under int8 with
    ``kept_ops="integer"`` (the kernels' integer bodies, the iapprox
    GELU and pooler tanh).

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
             pm.bert_cls_loss),
            ("cls", "int8 + kept-int", dataclasses.replace(
                rn, kept_ops="integer"),
             tf.make_cls_task(vocab=cfg.vocab, seq=32), pm.bert_cls_loss)):
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

    def __init__(self, torch, names=NAMES):
        from repro_torch.core import int_ops
        self.torch, self.int_ops, self.calls = torch, int_ops, []
        self.NAMES = names
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
    and batch; qwen also under int8 + ``kept_ops="integer"``.

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
    for arch, label, qcfg in (
            ("qwen1.5-0.5b", "int8", rn), ("smollm-135m", "int8", rn),
            ("qwen1.5-0.5b", "int8 + kept-int",
             dataclasses.replace(rn, kept_ops="integer"))):
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
                    tf.to_device(batch, device), cfg, qcfg, None)
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
        print(f"  reduced {arch} lm_loss step ({label}), card vs CPU: loss "
              f"{l1:.6f} vs {l0:.6f} (rel {dl:.2e}, tolerance 1e-5); whole-"
              f"step gradients finite, worst {worst:.2e} of its max at {at}"
              f"; {len(calls)} integer layer calls replayed from the same "
              f"inputs: outputs within {worst_y:.2e} of max (tolerance "
              f"2^-11), input gradients within {worst_g:.2e} (tolerance "
              "2e-3)")
        if dl > 1e-5 or worst_y > 2.0 ** -11 or worst_g > 2e-3:
            raise AssertionError("card LM training step disagrees with the "
                                 "CPU path")


class _Routes:
    """While active, records the experts each MoE router call chose for
    every token (``blocks.top_k``'s indices, sorted, on the host)."""

    def __init__(self):
        from repro_torch.models import blocks
        self.blocks, self.orig, self.sel = blocks, blocks.top_k, []

    def __enter__(self):
        def top_k(probs, k):
            vals, idx = self.orig(probs, k)
            self.sel.append(idx.detach().sort(-1).values.cpu())
            return vals, idx
        self.blocks.top_k = top_k
        return self

    def __exit__(self, *exc):
        self.blocks.top_k = self.orig


def _rerouted(torch, a: list, b: list, rows: int):
    """Tokens whose expert set differs between two runs' router calls
    (summed over the calls), and the batch rows holding one."""
    n, bad = 0, torch.zeros(rows, dtype=torch.bool)
    for x, y in zip(a, b):
        diff = (x != y).any(-1)
        n += int(diff.sum())
        bad |= diff.reshape(rows, -1).any(-1)
    return n, bad


def check_small_moe(torch, dev):
    """Reduced qwen2-moe-a2.7b (2 layers, d_model 128, 4 experts top-2, a
    shared expert of 128) on the card against the port's CPU path from the
    same weights: the served logits (prefill + 3 decode steps, 4 rows) and
    one ``lm_loss`` step under int8, rounding to nearest.

    Routing is discontinuous: the card's exp in the router softmax and the
    CPU's differ in the last ulp, and a token whose k-th and (k+1)-th
    probabilities lie within ulps can pick another expert on each, which
    moves its row by O(1).  So the re-routed tokens are counted and
    printed, the logits are held (within 5e-3 of max, as the dense model's)
    over the rows none of whose tokens re-routed, and the loss within 1e-5
    relative when no token re-routed (else within 1e-5 plus the re-routed
    share of the tokens).  Each integer layer call of the CPU step,
    ``int_batched_linear`` included, is replayed on both devices from its
    recorded inputs and upstream gradient: outputs within 2^-11 of max,
    input gradients within 2e-3 of max (as check_small_lm_train)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import trainer
    cfg = registry.get_config("qwen2-moe-a2.7b").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    B = 4
    toks = torch.randint(0, cfg.vocab, (B, 9), generator=gen)
    dec = torch.randint(0, cfg.vocab, (3, B, 1), generator=gen)
    outs, routes = {}, {}
    for device in ("cpu", dev):
        p = _to(params, device)
        cache = lm.init_cache(cfg, B, 64, device=device)
        rows = []
        with torch.no_grad(), _Routes() as r:
            logits, cache = lm.lm_prefill_cache(p, toks.to(device), cache,
                                                cfg, QuantConfig.int8())
            rows.append(logits.cpu())
            for i in range(3):
                logits, cache = lm.lm_decode_step(p, dec[i].to(device),
                                                  cache, cfg,
                                                  QuantConfig.int8())
                rows.append(logits.cpu())
        outs[str(device)], routes[str(device)] = rows, r.sel
    n_rr, bad = _rerouted(torch, routes["cpu"], routes[str(dev)], B)
    ok = ~bad
    if not ok.any():
        raise AssertionError("every served row re-routed a token")
    worst = 0.0
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite MoE logits on the card")
        worst = max(worst, ((a[ok] - b[ok]).abs().max()
                            / a[ok].abs().max()).item())
    print(f"  reduced qwen2-moe-a2.7b served, card vs CPU: {n_rr} token "
          f"routings of {sum(x.shape[0] for x in routes['cpu'])} differ "
          f"({int(bad.sum())} of {B} rows set aside); logits of the other "
          f"rows max |diff| / max|ref| = {worst:.3e} (tolerance 5e-3)")
    if worst > 5e-3:
        raise AssertionError("card MoE logits disagree with the CPU path")

    rn = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    batch = next(SyntheticLM(DataConfig(batch_size=4, seq_len=64,
                                        vocab=cfg.vocab)))
    res, routes = {}, {}
    rec = _Recorder(torch, _Recorder.NAMES + ("int_batched_linear",))
    for device in ("cpu", dev):
        with rec, _Routes() as r:
            loss, metrics, grads = trainer.loss_and_grads(
                lm.lm_loss, _to(params, device), tf.to_device(batch, device),
                cfg, rn, None)
        res[str(device)] = (float(loss), float(metrics["aux"]),
                            {n: g.cpu() for n, g in _leaves(grads)})
        routes[str(device)] = r.sel
    (l0, a0, g0), (l1, a1, g1) = res["cpu"], res[str(dev)]
    n_tok = 4 * 64
    n_rr, _ = _rerouted(torch, routes["cpu"], routes[str(dev)], 4)
    dl = abs(l1 - l0) / abs(l0)
    worst, at = _grad_agreement(torch, g0, g1)
    calls = rec.calls[:len(rec.calls) // 2]              # the CPU step's
    worst_y = worst_g = 0.0
    worst_at = ""
    for entry in calls:
        (y0, gs0), (y1, gs1) = (rec.replay(entry, "cpu"),
                                rec.replay(entry, dev))
        worst_y = max(worst_y, ((y1 - y0).abs().max()
                                / y0.abs().max()).item())
        for a, b in zip(gs0, gs1):
            if not torch.isfinite(b).all():
                raise AssertionError(f"non-finite {entry['name']} gradient "
                                     "on the card")
            scale = a.abs().max().item()
            d = (b - a).abs().max().item() / (scale if scale else 1.0)
            if d > worst_g:
                worst_g, worst_at = d, entry["name"]
    n_moe = sum(e["name"] == "int_batched_linear" for e in calls)
    print(f"  reduced qwen2-moe-a2.7b lm_loss step (int8), card vs CPU: "
          f"loss {l1:.6f} vs {l0:.6f} (rel {dl:.2e}), aux {a1:.6f} vs "
          f"{a0:.6f}; {n_rr} token routings of {n_tok * 2} differ; whole-"
          f"step gradients finite, worst {worst:.2e} of its max at {at}; "
          f"{len(calls)} integer layer calls ({n_moe} int_batched_linear) "
          f"replayed from the same inputs: outputs within {worst_y:.2e} of "
          f"max (tolerance 2^-11), input gradients within {worst_g:.2e} "
          f"(at {worst_at}; tolerance 2e-3)")
    if (dl > 1e-5 + n_rr / n_tok or worst_y > 2.0 ** -11
            or worst_g > 2e-3):
        raise AssertionError("card MoE training step disagrees with the "
                             "CPU path")


def check_small_moe_kept_int(torch, dev):
    """Reduced qwen2-moe-a2.7b (as check_small_moe): one ``lm_loss`` step
    under int8 + ``kept_ops="integer"``, rounding to nearest, card vs the
    port's CPU path.  The router's ``i_softmax`` passes no gradient (its
    integer casts, as the reference's), so the router weight's gradient
    must be all zeros on both devices, every other gradient finite.  The
    tokens routed to another expert set on the two devices are counted
    and set aside as in check_small_moe: the loss within 1e-5 relative
    plus the re-routed share of the tokens."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import trainer
    cfg = registry.get_config("qwen2-moe-a2.7b").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    qcfg = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False,
                               kept_ops="integer")
    batch = next(SyntheticLM(DataConfig(batch_size=4, seq_len=64,
                                        vocab=cfg.vocab)))
    res, routes = {}, {}
    for device in ("cpu", dev):
        with _Routes() as r:
            loss, _, grads = trainer.loss_and_grads(
                lm.lm_loss, _to(params, device), tf.to_device(batch, device),
                cfg, qcfg, None)
        res[str(device)] = (float(loss), {n: g.cpu()
                                          for n, g in _leaves(grads)})
        routes[str(device)] = r.sel
    (l0, g0), (l1, g1) = res["cpu"], res[str(dev)]
    n_tok = 4 * 64
    n_rr, _ = _rerouted(torch, routes["cpu"], routes[str(dev)], 4)
    dl = abs(l1 - l0) / abs(l0)
    router = "blocks.moe.router"
    nz = [int(torch.count_nonzero(g[router])) for g in (g0, g1)]
    for name, g in g1.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite kept-int MoE gradient {name}")
    print(f"  reduced qwen2-moe-a2.7b lm_loss step (int8 + kept-int), card "
          f"vs CPU: loss {l1:.6f} vs {l0:.6f} (rel {dl:.2e}); {n_rr} token "
          f"routings of {n_tok * 2} differ; router gradient nonzero entries "
          f"CPU {nz[0]}, card {nz[1]} of {g0[router].numel()} (must be 0); "
          "every gradient finite")
    if nz != [0, 0] or dl > 1e-5 + n_rr / n_tok:
        raise AssertionError("kept-int MoE step: router gradient not zero, "
                             "or the card's loss disagrees with the CPU's")


def profile_step(torch, fn, what: str) -> tuple:
    """torch.profiler over one call of ``fn``: wall time, summed device time
    (the device's busy share) and the device time by kernel or op.
    Returns the busy share and the count of device kernels and copies."""
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
    return busy_ms / wall_ms, launches


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


def _step_stats(torch, stamps: list, t_start: float, tokens: int) -> dict:
    """Set-up + step 0 ms, steps 1.. ms, their median and tokens/s."""
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return dict(first_ms=1e3 * (stamps[0] - t_start), step_ms=step_ms,
                median_ms=statistics.median(step_ms),
                tok_s=tokens * len(step_ms) / sum(step_ms) * 1e3)


def _per_step(counts: list) -> list:
    """Each step's launches by wrapper, from the counts after each step."""
    zero = dict.fromkeys(counts[0], 0)
    return [{n: c[n] - p[n] for n in c} for p, c in zip([zero] + counts,
                                                       counts)]


def kept_int_phase(torch, dev, bert_wrappers, lm_wrappers) -> tuple:
    """Phase 6b: ``kept_ops="integer"`` at full width, beside the same
    model's int8 run from the same seeds.

    bert-base cls through ``finetune`` (phase 5's int8 run: batch 32 x seq
    128, 10 steps, lr 1e-4, stochastic gradient rounding from the seeded
    CUDA generator) under int8 and int8 + kept-int (the kernels' integer
    bodies, iapprox GELU and pooler tanh); qwen1.5-0.5b training through
    ``lm_loss`` + ``make_train_step`` (phase 6's seeds, data and
    optimizer: batch 8 x seq 256, 6 steps, lr 1e-4; the launcher has no
    kept-ops flag, as the reference's has none) under int8 and int8 +
    kept-int (integer bodies, iapprox SiLU).  Launch counters set to 0 just
    before each run and read just after each step: every kernel of the
    path must have launched, and each step's launches of every kernel must
    equal the int8 run's (the reference pins keptint == int8 dispatch
    counts).  Prints losses beside the int8 and FP32 ones, median step ms,
    tokens/s, peak memory, one profiled step's busy share, and the device
    launches the iapprox activations add (plain element-wise PyTorch ops,
    no kernel wrapper): the profiled step's kernels and copies, kept-int
    minus int8.  Returns each kept-int run's wrapper launches."""
    import dataclasses
    import math
    from repro_torch.configs import bert_base, registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    int8 = QuantConfig.int8()
    kept = dataclasses.replace(int8, kept_ops="integer")
    fp32 = QuantConfig.fp32()
    out = {}

    def check(model, runs, wrappers):
        r8, rk = runs["int8"], runs["int8 + kept-int"]
        for n in wrappers:
            if rk["launches"][n] <= 0:
                raise AssertionError(f"kernel {n} was not launched on the "
                                     f"kept-int {model} path")
        if r8["per_step"] != rk["per_step"]:
            raise AssertionError(f"kept-int {model} launches per step "
                                 f"{rk['per_step']} != int8 "
                                 f"{r8['per_step']}")
        for label, r in runs.items():
            if not all(math.isfinite(v) for v in r["losses"]):
                raise AssertionError(f"non-finite {model} {label} loss")
        for label in ("int8", "int8 + kept-int"):
            r = runs[label]
            print(f"  {model} {label}: losses "
                  f"{[round(v, 5) for v in r['losses']]}; set-up + step 0 "
                  f"{r['first_ms']:.2f} ms; steps 1.. ms "
                  f"{[round(v, 2) for v in r['step_ms']]}; median "
                  f"{r['median_ms']:.2f} ms; {r['tok_s']:.1f} tokens/s; "
                  f"peak memory {r['peak']:.2f} GiB; busy share "
                  f"{100 * r['busy']:.1f}%, {r['kernels']} device kernels "
                  "and copies in the profiled step")
        print(f"  {model} FP32 losses from the same init "
              f"{[round(v, 5) for v in runs['FP32']['losses']]}")
        print(f"  {model} kept-int launches per step equal the int8 run's "
              f"at every step: {rk['per_step'][-1]}; the iapprox "
              f"activations add {rk['kernels'] - r8['kernels']} plain "
              "element-wise device launches per profiled step")

    # ---- bert-base cls
    arch = bert_base.CONFIG
    B, S, steps = 32, 128, 10
    ft = tf.FtConfig(steps=steps, batch=B, seq=S, eval_n=B, lr=1e-4)
    runs = {}
    for label, q in (("int8", int8), ("int8 + kept-int", kept),
                     ("FP32", fp32)):
        stamps, counts = [], []

        def on_step(i, loss):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts.append({n: w.launches for n, w in bert_wrappers.items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in bert_wrappers.values():
            w.launches = 0
        t_start = time.perf_counter()
        _, losses = tf.finetune("cls", q, ft, device=dev, arch=arch,
                                return_losses=True, on_step=on_step)
        torch.cuda.synchronize()
        r = dict(losses=losses, peak=torch.cuda.max_memory_allocated()
                 / 2**30, per_step=_per_step(counts),
                 launches={n: w.launches for n, w in bert_wrappers.items()},
                 **_step_stats(torch, stamps, t_start, B * S))
        if label != "FP32":
            gen = torch.Generator(device=dev).manual_seed(1)
            cfg, params, sampler, loss_fn, lr = tf._task_setup(
                "cls", gen, ft, arch, dev)
            ocfg = opt_lib.OptimizerConfig(lr=lr, weight_decay=0.0)
            state = {"p": params, "o": opt_lib.init(params)}
            b = tf.to_device(sampler(B, 0), dev)

            def one_step(q=q):
                state["p"], state["o"], _, _, _ = tf.train_step(
                    state["p"], state["o"], b, cfg, q, loss_fn, ocfg, gen)
            one_step()
            r["busy"], r["kernels"] = profile_step(
                torch, one_step, f"bert-base cls training step ({label})")
            del state
        runs[label] = r
    check("bert-base cls", runs, bert_wrappers)
    out["finetune_keptint"] = runs["int8 + kept-int"]["launches"]

    # ---- qwen1.5-0.5b training
    cfg = registry.get_config("qwen1.5-0.5b")
    B, S, steps = 8, 256, 6
    runs = {}
    for label, q in (("int8", int8), ("int8 + kept-int", kept),
                     ("FP32", fp32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        run = {"p": lm.lm_init(gen, cfg, device=dev)}
        run["o"] = opt_lib.init(run["p"])
        step = trainer.make_train_step(
            lm.lm_loss, cfg, q, opt_lib.OptimizerConfig(lr=1e-4,
                                                        total_steps=steps))
        data = SyntheticLM(DataConfig(batch_size=B, seq_len=S,
                                      vocab=cfg.vocab, seed=0))

        def one_step():
            batch = tf.to_device(next(data), dev)
            run["p"], run["o"], m = step(run["p"], run["o"], batch, gen)
            return float(m["loss"])
        for w in lm_wrappers.values():
            w.launches = 0
        losses, stamps, counts = [], [], []
        for _ in range(steps):
            losses.append(one_step())
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts.append({n: w.launches for n, w in lm_wrappers.items()})
        r = dict(losses=losses, peak=torch.cuda.max_memory_allocated()
                 / 2**30, per_step=_per_step(counts),
                 launches={n: w.launches for n, w in lm_wrappers.items()},
                 **_step_stats(torch, stamps, t_start, B * S))
        if label != "FP32":
            r["busy"], r["kernels"] = profile_step(
                torch, one_step, f"qwen1.5-0.5b training step ({label})")
        runs[label] = r
        del run, one_step
        gc.collect()
        torch.cuda.empty_cache()
    check("qwen1.5-0.5b train", runs, lm_wrappers)
    out["train_keptint"] = runs["int8 + kept-int"]["launches"]
    return out


def serve_phase(torch, dev, cfg, wrappers, n_req: int = 8,
                prompt_len: int = 64, new: int = 16) -> dict:
    """Serve ``cfg`` at full width, int8 (w8·a12), random weights from a
    seeded generator: 4 slots, max_seq 256, ``n_req`` requests of
    ``prompt_len``-token prompts, ``new`` new tokens each, through
    ``ContinuousBatcher.run_until_drained``.  The launch counters are set
    to 0 just before the run and read just after; every kernel in
    ``wrappers`` must have launched.  Prints tokens/s, peak memory, one
    decode step's time and launches, one prefill's time and a profiled
    decode step.  Returns the run's launches."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import ContinuousBatcher, Engine, ServeConfig
    t0 = time.perf_counter()
    params = lm.lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    engine = Engine(params, cfg, registry.get_quant("int8"),
                    ServeConfig(max_seq=256, batch_slots=4), device=dev)
    batcher = ContinuousBatcher(engine)
    rng = torch.Generator().manual_seed(0)
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
    return launches


def train_moe_phase(torch, dev, wrappers, layers: int = MOE_TRAIN_LAYERS,
                    steps: int = 6, lr: float = 1e-4) -> dict:
    """Train qwen2-moe-a2.7b at full width (d_model 2048, 60 experts top-4
    of d_ff 1408, the shared expert of 5632, vocab 151936, untied head)
    with the depth cut to ``layers``: int8, batch 8 x seq 256 of
    ``SyntheticLM`` (T·K = 8192 > 4096, so the capacity dispatch runs at
    256 rows per expert), ``steps`` AdamW steps at ``lr`` through
    ``lm_loss`` + ``make_train_step`` (what ``launch.train`` wires; the
    launcher has no depth flag, as the reference's has none), random
    weights and stochastic gradient rounding from one seeded CUDA
    generator.  The depth: the deepest that leaves 10% of the card's
    memory spare, with parameters, AdamW moments and gradients (16 bytes a
    parameter: the update runs in place) and the step's activations.  The
    launch counters are set to 0 just before the int8 run and read just
    after; every kernel in ``wrappers`` must have launched, every loss be
    finite and the first near ln 151936.  Then one profiled int8 step, and
    the same steps under FP32 from the same init.  Returns the int8 run's
    launches."""
    import dataclasses
    import math
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    from repro_torch.train.finetune import to_device
    cfg = dataclasses.replace(registry.get_config("qwen2-moe-a2.7b"),
                              n_layers=layers)
    B, S = 8, 256

    def start(quant):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.lm_init(gen, cfg, device=dev)
        step = trainer.make_train_step(
            lm.lm_loss, cfg, registry.get_quant(quant),
            opt_lib.OptimizerConfig(lr=lr, total_steps=steps))
        data = SyntheticLM(DataConfig(batch_size=B, seq_len=S,
                                      vocab=cfg.vocab, seed=0))
        run = {"p": params, "o": opt_lib.init(params)}
        del params

        def one_step():
            batch = to_device(next(data), dev)
            run["p"], run["o"], m = step(run["p"], run["o"], batch, gen)
            return float(m["loss"])
        return one_step, run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    one_step, run = start("int8")
    n_params = sum(p.numel() for _, p in _leaves(run["p"]))
    for w in wrappers.values():
        w.launches = 0
    losses, stamps, counts = [], [], []
    for _ in range(steps):
        losses.append(one_step())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        counts.append({n: w.launches for n, w in wrappers.items()})
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite MoE training loss: {losses}")
    if abs(losses[0] - math.log(151936)) > 1.5:
        raise AssertionError(f"first loss {losses[0]} is not near ln 151936")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} was not launched on the MoE "
                                 "training path")
    first_ms = 1e3 * (stamps[0] - t_start)
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    med = statistics.median(step_ms)
    tok_s = B * S * len(step_ms) / sum(step_ms) * 1e3
    last = {n: counts[-1][n] - counts[-2][n] for n in wrappers}
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    if peak > 0.9 * total:
        raise AssertionError(f"peak {peak:.2f} GiB leaves less than 10% of "
                             f"the card's {total:.2f} GiB")
    print(f"  {layers} layers, {n_params / 1e9:.3f} B parameters; set-up + "
          f"step 0 {first_ms:.2f} ms; steps 1-{steps - 1} ms "
          f"{[round(v, 2) for v in step_ms]}; median {med:.2f} ms; "
          f"{tok_s:.1f} tokens/s over those steps; peak memory {peak:.2f} "
          f"GiB of {total:.2f} GiB ({100 * peak / total:.1f}%); launches in "
          f"the run {launches}; in one step {last}")
    profile_step(torch, one_step, f"qwen2-moe-a2.7b training step ({layers}"
                 " layers, int8)")
    del one_step, run
    torch.cuda.empty_cache()
    one_step, run = start("fp32")
    losses32 = [one_step() for _ in range(steps)]
    del one_step, run
    torch.cuda.empty_cache()
    print(f"  lr {lr}; int8 losses {[round(v, 5) for v in losses]}; FP32 "
          f"losses from the same init {[round(v, 5) for v in losses32]}")
    return launches


def _to(tree, device):
    """A copy of the tree on ``device`` (a copy on the CPU too: a training
    step updates its parameters in place)."""
    return {k: _to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


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
    for name, used, spill in ptxas_entries():
        print(f"    ptxas: {name}: {used}; {spill}")
    print(card)

    cfg = registry.get_config("qwen1.5-0.5b")
    V = lm.padded_vocab(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    print("[2] kernels against their plain versions, full-width shapes")
    bert, tokens = bert_base.CONFIG, 32 * 128
    moe = registry.get_config("qwen2-moe-a2.7b")
    kernels = [check_quantize(torch, dev, gen, V, cfg.d_model, tokens,
                              bert.d_ff),
               check_matmul(torch, dev, gen, cfg, V, bert, tokens),
               check_rmsnorm(torch, dev, gen, cfg.d_model, moe.d_model),
               check_attention(torch, dev, gen, cfg)]
    kernels += check_matmul_bwd(torch, dev, gen, bert, tokens)
    kernels += check_layernorm(torch, dev, gen, bert.d_model, tokens)
    kernels.append(check_rmsnorm_bwd(torch, dev, gen, 8 * 256, cfg.d_model,
                                     moe.d_model))
    kernels += check_attention_bwd(torch, dev, gen)
    kernels.append(check_quantize_grouped(torch, dev, gen, moe))
    kernels += check_matmul_batched(torch, dev, gen, moe)
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
    check_small_moe(torch, dev)
    check_small_moe_kept_int(torch, dev)

    print("[4] serve qwen1.5-0.5b, full width, int8")
    wrappers = {"dfx_quantize": dfx_quant.dfx_quantize,
                "bfp_matmul": bfp_matmul.bfp_matmul,
                "int_rmsnorm_fwd": int_norm.int_rmsnorm_fwd,
                "int_attn_fwd": int_attention.int_attn_fwd}
    launches = serve_phase(torch, dev, cfg, wrappers)
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
    print("[6b] kept_ops=\"integer\" at full width beside int8: bert-base "
          "cls (batch 32 x seq 128, 10 steps) and qwen1.5-0.5b training "
          "(batch 8 x seq 256, 6 steps)")
    gc.collect()
    torch.cuda.empty_cache()
    kept = kept_int_phase(torch, dev, {**paper, **attn}, {
        "dfx_quantize": dfx_quant.dfx_quantize,
        "bfp_matmul": bfp_matmul.bfp_matmul,
        "bfp_matmul_nt": bfp_matmul.bfp_matmul_nt,
        "bfp_matmul_tn": bfp_matmul.bfp_matmul_tn,
        "int_rmsnorm_fwd": int_norm.int_rmsnorm_fwd,
        "int_rmsnorm_bwd": int_norm.int_rmsnorm_bwd, **attn})
    moe_fwd = {"dfx_quantize_grouped": dfx_quant.dfx_quantize_grouped,
               "bfp_matmul_batched": bfp_matmul.bfp_matmul_batched}
    gc.collect()
    torch.cuda.empty_cache()
    print("[7] serve qwen2-moe-a2.7b, full width and depth (24 layers, 60 "
          "experts top-4 + shared expert), int8; device memory allocated "
          f"before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    moe_serve = serve_phase(torch, dev, registry.get_config(
        "qwen2-moe-a2.7b"), {**wrappers, **moe_fwd})
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[8] train qwen2-moe-a2.7b, full width, {MOE_TRAIN_LAYERS} layers, "
          "int8, batch 8 x seq 256, lm_loss + make_train_step; device memory "
          f"allocated before: {torch.cuda.memory_allocated() / 2**30:.2f} "
          "GiB")
    moe_train = train_moe_phase(torch, dev, {
        "dfx_quantize": dfx_quant.dfx_quantize,
        "bfp_matmul": bfp_matmul.bfp_matmul,
        "bfp_matmul_nt": bfp_matmul.bfp_matmul_nt,
        "bfp_matmul_tn": bfp_matmul.bfp_matmul_tn,
        "int_rmsnorm_fwd": int_norm.int_rmsnorm_fwd,
        "int_rmsnorm_bwd": int_norm.int_rmsnorm_bwd, **attn, **moe_fwd,
        "bfp_matmul_batched_nt": bfp_matmul.bfp_matmul_batched_nt,
        "bfp_matmul_batched_tn": bfp_matmul.bfp_matmul_batched_tn})
    for k in kernels:
        by_path = {"serve": launches.get(k["name"], 0),
                   "finetune": ft_launches.get(k["name"], 0),
                   "finetune_int8": ft8_launches.get(k["name"], 0),
                   "train": tr_launches.get(k["name"], 0),
                   "serve_moe": moe_serve.get(k["name"], 0),
                   "train_moe": moe_train.get(k["name"], 0),
                   "finetune_keptint": kept["finetune_keptint"].get(
                       k["name"], 0),
                   "train_keptint": kept["train_keptint"].get(k["name"], 0)}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if "int_ms" in k:        # the kept-int paths run its integer body
            k["int_launches"] = (by_path["finetune_keptint"]
                                 + by_path["train_keptint"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
