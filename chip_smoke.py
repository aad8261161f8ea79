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
   expert set on the two devices counted and set aside; the sweep's
   presets: the BERT cls step at int16 and a reduced ViT's at int16 and
   int8 (round to nearest).  Under int8 +
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
   included; the per-layer remat on, as in every LM training run), every
   loss be finite and the first near ln 151936.  Prints
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
9. The paper's bit-width sweep (``train/finetune.py::sweep``,
   ``train/paper_tables.py``) at the presets fp32, int16, int12, int10 and
   int8 (the plain presets: integer attention, stochastic gradient
   rounding from a seeded CUDA generator).  Full width: bert-base cls
   (batch 32 x seq 128), bert-base span (12 x 384) and vit-base img (32 x
   197 tokens) through ``finetune``, lr 1e-4, 6 steps each, the launch
   counters set to 0 just before each run and read just after; every loss
   finite, every kernel of the path launched in every step at each
   integer preset, each wrapper's launches per step equal at int16, int12,
   int10 and int8, none under FP32.  Prints losses, the median of steps
   1-5, tokens/s, peak memory, launches per step and a profiled step's
   busy share at int16 and int8.  Then the reference's sizes (bert-tiny /
   vit-tiny, batch 16, eval on 128): Tables 1-3 and Fig. 4 at 120 steps,
   Fig. 5 at 150 with its assertion; each table's metric, its drop against
   FP32 and int8's average drop.  Phase 2 holds the sweep's attention
   calls (3 limb planes at hd 64, bert cls / span and vit shapes; vit at
   int8 too) and int16's 3x3 NT / TN matmuls (bert-base w1, vit-base w1's
   6304-row dW) too.
   Phase 2 also holds, and times beside bound and library, the kernel
   calls of phase 10 (``check_arch_shapes``, ``ARCH_ATTN``): the quantize
   of mistral-nemo-12b's 131072 x 5120 embedding and head, its logits'
   gradient and mistral-large-123b's wd; the grouped quantize of
   mixtral-8x7b's 8 x 4096 x 14336 expert stacks; nemo's untied head NN /
   NT (dX over 2^17 rows, its largest limb-pair sum against 2^31) / TN
   and large's wd NN (K = 28672); the batched NN / NT / TN at mixtral's
   8 experts x 1280 rows; the RMS-norm forward and backward at 2048 x
   {4096, 5120, 12288}; the attention forward, dq and dkv at mixtral's 1
   x 5120 tokens with its window of 4096 keys (G 4, hd 128) and at
   large's G = 12 (8 x 256), and the forward at decode past mixtral's
   window and at large's G = 12.  Phase 3 also runs mistral-nemo-12b and
   mistral-large-123b (served logits, one int8 ``lm_loss`` step with
   every layer call replayed) and mixtral-8x7b (as qwen2-moe-a2.7b, over
   prompts and sequences past its window of 64) at reduced configs that
   keep each arch's trait (``small_config``).
10. mistral-nemo-12b, mixtral-8x7b and mistral-large-123b at full width
   (``arch_phase``), int8, random weights from a seeded generator, each
   freed before the next.  Served with phase 4's request mix: nemo at
   full depth (40 layers, ~45.6 GiB of FP32 weights), mixtral and large at
   the deepest depths that leave 10% of the card's memory spare
   (``*_SERVE_LAYERS``).  Trained through ``lm_loss`` +
   ``make_train_step`` with the per-layer remat on and stochastic
   gradient rounding from a seeded CUDA generator, 4 AdamW steps at lr
   1e-4: mixtral at 2 layers and batch 8 x 512 (the capacity dispatch at
   1280 rows per expert), nemo at ``NEMO_TRAIN_LAYERS`` and large at 2,
   batch 8 x 256; every kernel of each path must have launched, every
   loss be finite and the first near ln(vocab) + d_model x 0.02^2 / 2,
   the peak leave 10% of the memory.  Prints what phases 4 and 8 print
   (the FP32 losses from the same init included).  Then nemo on the
   chunked FP32 attention path: 2 layers, 1 x 4096 tokens, 2 steps with
   remat on, then one step with remat off from the same init; both peaks
   printed, no kernel launched.
   Phase 2 also holds ``dfx_quantize_grouped`` at the state plane's
   shapes (``check_state_shapes``): qwen1.5-0.5b's embedding moment as
   152,064 slices of 1 x 1024 (its vocabulary padded to a multiple of
   256; round to nearest and stochastic, 1 and 3 planes) and its 24 MLP
   stacks of 1024 x 2816, both timed.
11. The state plane and the recovering training loop
   (``state_plane_phase``), through ``launch.train``: qwen1.5-0.5b at
   full width, int8, batch 8 x seq 256, 6 steps, with FP32 moments, int8
   QTensor moments and int8 moments + the int8 parameter image, each run
   launching every training kernel (the grouped quantize too with int8
   moments); prints losses, step ms, tokens/s, peak memory, resident
   moment bytes, launches per step and the bytes of a checkpoint.  Then
   smollm-135m at its full config, batch 8 x seq 128, int8 moments, the
   sentinel and a checkpoint every 2 steps: a clean run, a chaos run
   (preemption, moment bit-flip, corrupt checkpoint, straggler) that
   ends bit for bit at the clean run's parameters and moments, a
   NaN-injected run with one skipped step, and a sentinel forced to
   escalate (its rebuilt 16-bit attention scope on 3-plane kernels).
12. Print the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is available or when
the script is not inside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import math
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


#: sentinel kernels (``torch.cuda._sleep``'s spin kernel) launched at the
#: head of every profiler window and left out of its counts: after many
#: profiler sessions in one process the profiler drops the first device
#: events of a window (measured on the H100: 1-2 of them, the same number
#: in every window), which the sentinels take in place of the kernels
#: measured
HEAD_SENTINELS = 8


def _window_events(torch, prof) -> list:
    """A profiler window's device events without the head sentinels."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.key]


def _head_sentinels(torch):
    for _ in range(HEAD_SENTINELS):
        torch.cuda._sleep(1000)


def device_ms(fn, reps: int = 10, windows: int = 6) -> float:
    """Device time of ``fn()`` in ms: the summed duration of the kernels and
    copies it runs (torch.profiler), per call — the host time between
    launches, which ``cuda_ms`` includes for small kernels, left out.

    The profiler now and then loses some or all of a window's device
    events (a window of ``reps`` calls then reads low, or 0).  So windows
    are repeated until one records as many device events as an earlier
    one, and that window's time is taken; no agreement within ``windows``
    windows raises.  Each window starts with ``HEAD_SENTINELS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []                        # (device events, device us) per window
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _head_sentinels(torch)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _window_events(torch, prof)
        n = sum(e.count for e in events)
        us = sum(getattr(e, "self_device_time_total", 0) for e in events)
        if n and any(n == m for m, _ in seen):
            return us / reps / 1e3
        seen.append((n, us))
    raise RuntimeError("the profiler's device event counts disagreed in "
                       f"every window: (events, us) {seen}")


def device_kernels(fn, reps: int = 5, windows: int = 6) -> tuple:
    """(device kernels and copies per call of ``fn()``, their names) from
    torch.profiler; windows, each after ``HEAD_SENTINELS``, are repeated
    until two record the same count, as in ``device_ms``, a count that is
    a whole number of calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _head_sentinels(torch)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _window_events(torch, prof)
        n = sum(e.count for e in events)
        if n and n % reps == 0 and n in seen:
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


def timings(kernel, plain=None, library=None) -> dict:
    """CUDA-event medians and profiler device times of the kernel's wrapper
    call, its plain version and the library yardstick (None where not
    given: a plain version too slow to time at the shape)."""
    return dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain) if plain else None,
                library_ms=cuda_ms(library) if library else None,
                device_ms=device_ms(kernel),
                plain_device_ms=device_ms(plain) if plain else None,
                library_device_ms=device_ms(library) if library else None)


def _ms(x) -> str:
    return "not timed" if x is None else f"{x:.4f}"


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
    too (``grad_*`` keys).  The bit-width sweep's calls are held exactly
    as well (``check_sweep_quantize``)."""
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
    del act
    check_sweep_quantize(torch, dev, gen)
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


def check_sweep_quantize(torch, dev, gen):
    """dfx_quantize held exactly against its plain version at the calls of
    the sweep's int16, int12 and int10 steps: at each step's rows x d_model
    and x d_ff, an activation into limb planes (round to nearest), an
    upstream gradient into limb planes and as a logical mantissa
    (stochastic, ``u`` from the CUDA generator) and a norm's input as a
    logical mantissa; the weights (d x d, d x d_ff, d_ff x d) into planes
    and the embedding table as a logical mantissa.  The 16-bit gradient
    planes (3 planes, stochastic) at the cls step's rows x d_ff are timed
    beside their bound."""
    from repro_torch.configs.bert_base import CONFIG as bert
    from repro_torch.core import dfx
    from repro_torch.kernels import dfx_quant
    D, F, V = bert.d_model, bert.d_ff, bert.vocab
    rows = [b * t for _, _, b, t in SWEEP_CELLS]
    n = 0
    shapes = [(r, c) for r in rows for c in (D, F)]
    for shape in shapes + [(D, D), (D, F), (F, D), (V, D)]:
        x = torch.randn(shape, generator=gen, device=dev)
        g = x * 1e-6
        u = torch.rand(shape, generator=gen, device=dev)
        for bits in (16, 12, 10):
            if shape in shapes:
                cases = [(x, True, None), (g, True, u), (g, False, u),
                         (x, False, None)]
            else:
                cases = [(x, shape != (V, D), None)]
            for t, limbs, uu in cases:
                e = dfx.scale_exponent(t) - (bits - 1)
                got = dfx_quant.dfx_quantize(t, e, bits=bits, u=uu,
                                             limb_planes=limbs)
                _held("dfx_quantize", got, dfx_quant.dfx_quantize_plain(
                    t, e, bits=bits, u=uu, limb_planes=limbs),
                    f"{shape} bits={bits} limb_planes={limbs} "
                    f"stochastic={uu is not None}")
                n += 1
    g = torch.randn((rows[0], F), generator=gen, device=dev) * 1e-6
    u = torch.rand(g.shape, generator=gen, device=dev)
    e = dfx.scale_exponent(g) - 15
    out = dfx_quant.dfx_quantize(g, e, bits=16, u=u, limb_planes=True)
    ms = device_ms(lambda: dfx_quant.dfx_quantize(g, e, bits=16, u=u,
                                                  limb_planes=True))
    b, by = bound_ms(nbytes(g, u, out), 0)
    print(f"  dfx_quantize: the sweep's {n} int16 / int12 / int10 calls held "
          f"exactly at rows {rows} x ({D}, {F}), the weights and the "
          f"({V},{D}) table; 16-bit gradient "
          f"planes {tuple(g.shape)} -> {tuple(out.shape)}, stochastic: "
          f"device {ms:.4f} ms, bound {b:.4f} ms ({by})", flush=True)


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
                  dtype=None, bits: int = 12) -> dict:
    """A norm forward (``ln``: int_layernorm_fwd, else int_rmsnorm_fwd) at
    (R, D) on int16 mantissas at ``bits`` (or ``dtype`` int8, full range), both
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
    lim = 127 if dtype == torch.int8 else 2 ** (bits - 1) - 1
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
    what = f"{name} ({R},{D}) {str(dtype)[6:]} at {bits} bits"
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


#: phase 10's attention calls (PR 22), held and timed in phase 2: mixtral's
#: training shape with its window of 4096 keys biting (1 x 5120 tokens, 32
#: heads over 8 kv heads of 128) and mistral-large's 12 query heads per kv
#: head at 8 x 256
MIXTRAL_ATTN = "mixtral train, window 4096 (1 x 5120)"
LARGE_ATTN = "mistral-large G 12 (8 x 256)"
ARCH_ATTN = (MIXTRAL_ATTN, LARGE_ATTN)

#: attention forward shapes held on the card: name -> (B, Sq, Sk, KV, G,
#: hd, offsets, causal, window, act bits); q/k/v carry n_limbs(act bits)
#: planes and P is quantized at the act bits.  The ", int16" / ", int12" /
#: ... entries are the bit-width sweep's calls (phase 9), bidirectional
SWEEP_TIMED = ("bert-base cls, int16", "bert-base span, int16",
               "vit-base img, int16")
ATTN_FWD_SHAPES = {
    "decode": (4, 1, 256, 16, 1, 64, [64, 65, 66, 67], True, None, 12),
    "prefill": (4, 64, 256, 16, 1, 64, 0, True, None, 12),
    "qwen1.5-0.5b train": (8, 256, 256, 16, 1, 64, 0, True, None, 12),
    "smollm-135m gqa": (8, 256, 256, 3, 3, 64, 0, True, None, 12),
    "ragged + window": (2, 20, 150, 2, 2, 16, [100, 37], True, 40, 12),
    "qwen2-moe-a2.7b train (hd 128)": (8, 256, 256, 16, 1, 128, 0, True,
                                       None, 12),
    "head dim 256, 3 limbs": (8, 256, 256, 4, 1, 256, 0, True, None, 16),
    "head dim 384": (8, 256, 256, 4, 1, 384, 0, True, None, 12),
    "bert-base cls, int16": (32, 128, 128, 12, 1, 64, 0, False, None, 16),
    "bert-base span, int16": (12, 384, 384, 12, 1, 64, 0, False, None, 16),
    "vit-base img, int16": (32, 197, 197, 12, 1, 64, 0, False, None, 16),
    "vit-base img, int12 and int8": (32, 197, 197, 12, 1, 64, 0, False,
                                     None, 12),
    "vit-base img, int10": (32, 197, 197, 12, 1, 64, 0, False, None, 10),
    MIXTRAL_ATTN: (1, 5120, 5120, 8, 4, 128, 0, True, 4096, 12),
    LARGE_ATTN: (8, 256, 256, 8, 12, 128, 0, True, None, 12),
    "mixtral decode past the window": (4, 1, 5120, 8, 4, 128,
                                       [5119, 4600, 4096, 300], True, 4096,
                                       12),
    "mistral-large decode (G 12)": (4, 1, 256, 8, 12, 128, [64, 65, 66, 67],
                                    True, None, 12),
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
    limbs and head dim 384, the direct body; the bit-width sweep's calls
    at 3 and 2 planes, vit's 197 keys ending in a ragged key block), FP32
    and kept-int bodies: o within 1e-5 of max|o| and lse within 1e-4 (the
    same expf and the same ordered f32 sums on both sides; the max abs
    errors are reported).  The exponents keep the values' size at every
    plane count.  Timed at decode, the qwen1.5-0.5b training shape (24
    calls a step; both bodies), qwen2-moe-a2.7b's head dim 128, head dim
    384 and the sweep's int16 calls (``sweep_rows``), each beside
    SDPA's f32 forward on the dequantized values with the same mask (its
    kv heads repeated for GQA).  Bound: the bytes of the planes and
    outputs, or the int8 operations of the limb-pair products over the
    (query, key) pairs the mask lets through, whichever is larger."""
    import torch.nn.functional as F
    from repro_torch.kernels import int_attention as ia
    from repro_torch.kernels.dfx_quant import n_limbs
    err = {False: 0.0, True: 0.0}
    runs = {}
    for label, shape in ATTN_FWD_SHAPES.items():
        B, Sq, Sk, KV, G, hd, off, causal, window, bits = shape
        L = n_limbs(bits)
        q = _planes(torch, gen, dev, L, B, Sq, KV, G, hd)
        k = _planes(torch, gen, dev, L, B, Sk, KV, hd)
        v = _planes(torch, gen, dev, L, B, Sk, KV, hd)
        exps = torch.tensor([-9, -9, -8], dtype=torch.int32,
                            device=dev) - 7 * (L - 2)
        qo = torch.tensor(off if isinstance(off, list) else [off] * B,
                          dtype=torch.int32, device=dev)
        kw = dict(p_bits=bits, causal=causal, window=window,
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
                runs[label] = (shape, q, k, v, qo, exps, kw, o, lse, e_o)
        print(f"  attention forward at {label} {shape[:6]}, {L} planes, P "
              f"{bits} bits: " + "; ".join(line))
    for name, used, spill in ptxas_entries(r"fwd_"):
        print(f"  ptxas {name}: {used}; {spill}")

    def measure(label, kept_int=False, time_plain=True):
        """Timings (kernel, plain unless ``time_plain`` is False, SDPA) and
        the bound at one shape; with ``kept_int`` also the integer body's
        (int_*)."""
        shape, q, k, v, qo, exps, kw, o, lse, _ = runs[label]
        B, Sq, Sk, KV, G, hd, off, causal, window, bits = shape
        L = q.shape[0]
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
        # mask is the plain causal one, none where every key is seen, else
        # the boolean mask itself
        plain_causal = (causal and window is None and Sq == Sk
                        and not bool(qo.any()))
        mask = (None if plain_causal or not (causal or window)
                else seen[:, None])

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  is_causal=plain_causal)
        t = timings(lambda: ia.int_attn_fwd(q, k, v, qo, exps, **kw),
                    (lambda: ia.int_attn_fwd_plain(q, k, v, qo, exps, **kw))
                    if time_plain else None, library)
        # bytes and int8 ops these inputs need: each (query, key) pair the
        # mask lets through, every limb pair of QK^T and of PV
        pairs = int(seen.sum()) * KV * G
        need_keys = int(seen.any(1).sum()) * KV                  # K/V rows
        n_bytes = (nbytes(q, qo, exps, o, lse)
                   + (k.shape[0] + v.shape[0]) * need_keys * hd)
        b, by = bound_ms(n_bytes, 2 * pairs * hd * 2 * L * L)
        t.update(bound_ms=b, bound_by=by)
        if kept_int:
            ki = dict(kw, integer_exp=True)
            t.update(int_body(timings(
                lambda: ia.int_attn_fwd(q, k, v, qo, exps, **ki),
                lambda: ia.int_attn_fwd_plain(q, k, v, qo, exps, **ki),
                library), bound_ms=b, bound_by=by))
        print(f"  int_attn_fwd at {label}: call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms; plain device "
              f"{_ms(t['plain_device_ms'])}; SDPA forward (f32) device "
              f"{t['library_device_ms']:.4f}; bound {b:.4f} ms ({by})")
        return t

    t = measure("decode", kept_int=True)
    tt = measure("qwen1.5-0.5b train", kept_int=True)
    tm = measure("qwen2-moe-a2.7b train (hd 128)")
    tw = measure("head dim 384")
    sweep = [dict(label=lb, max_abs_err=runs[lb][-1], **measure(lb))
             for lb in SWEEP_TIMED]
    # the plain version walks mixtral's 5120 keys in blocks: held, not timed
    arch = [dict(label=lb, max_abs_err=runs[lb][-1],
                 **measure(lb, time_plain=lb != MIXTRAL_ATTN))
            for lb in ARCH_ATTN]
    B, Sq, Sk, KV, G, hd = ATTN_FWD_SHAPES["decode"][:6]
    out = dict(name="int_attn_fwd", route="cuda",
               source="src/repro_torch/csrc/int_attention.cu",
               replaces="src/repro/kernels/int_attention.py:217",
               shape=f"decode q ({B},{Sq},{KV},{G},{hd}) over k/v ({B},{Sk},"
                     f"{KV},{hd}), 2 limbs; also timed at the qwen1.5-0.5b "
                     "training shape (8,256) causal (train_*), qwen2-moe's "
                     "head dim 128 (moe_*) and head dim 384 (hd384_*, the "
                     "direct body), the sweep's int16 calls (sweep_rows) "
                     "and phase 10's mixtral and mistral-large calls "
                     "(arch_rows); "
                     "the kept-int body (int_*, train_int_*) "
                     "at decode and the training shape; both bodies held at "
                     + ", ".join(ATTN_FWD_SHAPES) + "; tolerance o 1e-5 "
                     "relative, lse 1e-4 absolute; library: SDPA forward "
                     "(f32)",
               max_abs_err=err[False], int_max_abs_err=err[True], **t,
               **{f"train_{k_}": v_ for k_, v_ in tt.items()},
               **{f"moe_{k_}": v_ for k_, v_ in tm.items()},
               **{f"hd384_{k_}": v_ for k_, v_ in tw.items()},
               sweep_rows=sweep, arch_rows=arch)
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
                     f"values; rows: the span step's {SPAN_ROWS} x {D}; held "
                     "at the sweep's x at 16, 12 and 10 bits too",
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
                     f"the span step's ({SPAN_ROWS},{D}) (span_*); held at "
                     "the sweep's x and g at 16, 12 and 10 bits too; "
                     "tolerance dbeta exact, dx 64 ulp of max, dgamma 64 ulp "
                     "of the column's sum of |gq xn|; two calls bit for bit; "
                     "library: aten.native_layer_norm_backward on the f32 "
                     "values",
               **ln_bwd_case(torch, dev, gen, R, D),
               **{f"span_{k}": v for k, v in ln_bwd_case(
                   torch, dev, gen, SPAN_ROWS, D).items()})
    # the bit-width sweep's calls: int16 / int12 / int10 x and g at each
    # full-width step's rows
    rows = [b * t for _, _, b, t in SWEEP_CELLS]
    for bits in (16, 12, 10):
        for r in rows:
            norm_fwd_case(torch, dev, gen, True, r, D, bits=bits)
            ln_bwd_case(torch, dev, gen, r, D, x_bits=bits, g_bits=bits,
                        timed=False)
    print(f"  int_layernorm_fwd / _bwd: the sweep's int16, int12 and int10 "
          f"calls held at rows {rows} x {D} (x and g at 16, 12 and 10 bits)",
          flush=True)
    return [fwd, bwd]


#: bert-base's span fine-tuning step: batch 12 x seq 384 rows
SPAN_ROWS = 12 * 384


def ln_bwd_case(torch, dev, gen, R, D, x_bits=12, g_bits=8,
                timed=True) -> dict:
    """int_layernorm_bwd on (R, D) int16 mantissas at ``x_bits`` (a12) and
    gradient mantissas at ``g_bits`` (g8: int8; wider: int16), the
    statistics from the plain forward: dbeta exactly, dx within 64 ulp of
    max|dx|, dgamma within 64 ulp of the column's Σ|gq·xn| (f32 sums in
    another order); with ``timed``, timed beside its bound and
    aten.native_layer_norm_backward."""
    from repro_torch.core import dfx
    from repro_torch.kernels import int_norm
    ulp = 2.0 ** -23
    xl, gl = 2 ** (x_bits - 1) - 1, 2 ** (g_bits - 1) - 1
    xm = torch.randint(-xl, xl + 1, (R, D), generator=gen, device=dev,
                       dtype=torch.int16)
    gm = torch.randint(-gl, gl + 1, (R, D), generator=gen, device=dev,
                       dtype=torch.int8 if g_bits == 8 else torch.int16)
    xe = torch.tensor(3 - x_bits, dtype=torch.int32, device=dev)
    ge = torch.tensor(-19 - g_bits, dtype=torch.int32, device=dev)
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
            f"int_layernorm_bwd differs at ({R},{D}) x{x_bits} g{g_bits}: dx "
            f"{(dx - dx0).abs().max().item()}, dgamma "
            f"{(dg - dg0).abs().max().item()}, dbeta exact "
            f"{torch.equal(db, db0)}")
    err = max((dx - dx0).abs().max().item(), (dg - dg0).abs().max().item())
    if not timed:
        return dict(max_abs_err=err)
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
    return dict(max_abs_err=err, bound_ms=b, bound_by=by, **t)


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
#: hd, offsets, causal, window, act bits, grad bits); q/k/v carry
#: n_limbs(act bits) planes and P is quantized at the act bits, g carries
#: n_limbs(grad bits) planes and dS is quantized at the grad bits.  The
#: ", int16" / ", int12" / ... entries are the bit-width sweep's calls
#: (phase 9), bidirectional, held on the FP32 body the sweep runs
ATTN_BWD_SHAPES = {
    "bert-base cls": (32, 128, 128, 12, 1, 64, 0, False, None, 12, 8),
    "qwen1.5-0.5b train": (8, 256, 256, 16, 1, 64, 0, True, None, 12, 8),
    "smollm-135m gqa": (8, 256, 256, 3, 3, 64, 0, True, None, 12, 8),
    "ragged + window": (2, 20, 150, 2, 2, 16, [100, 37], True, 40, 12, 8),
    "qwen2-moe-a2.7b train": (8, 256, 256, 16, 1, 128, 0, True, None, 12,
                              8),
    "head dim 256 (widest body)": (8, 256, 256, 4, 1, 256, 0, True, None, 12,
                                   8),
    "head dim 384": (8, 256, 256, 4, 1, 384, 0, True, None, 12, 8),
    "bert-base cls, int16": (32, 128, 128, 12, 1, 64, 0, False, None, 16,
                             16),
    "bert-base span, int16": (12, 384, 384, 12, 1, 64, 0, False, None, 16,
                              16),
    "vit-base img, int16": (32, 197, 197, 12, 1, 64, 0, False, None, 16,
                            16),
    "bert-base cls, int12": (32, 128, 128, 12, 1, 64, 0, False, None, 12,
                             12),
    "vit-base img, int12": (32, 197, 197, 12, 1, 64, 0, False, None, 12,
                            12),
    "vit-base img, int10": (32, 197, 197, 12, 1, 64, 0, False, None, 10,
                            10),
    "vit-base img, int8": (32, 197, 197, 12, 1, 64, 0, False, None, 12, 8),
    MIXTRAL_ATTN: (1, 5120, 5120, 8, 4, 128, 0, True, 4096, 12, 8),
    LARGE_ATTN: (8, 256, 256, 8, 12, 128, 0, True, None, 12, 8),
}


def _attn_bwd_inputs(torch, dev, gen, shape):
    """Operands at the shape's bits: q/k/v n_limbs(act bits) planes, g
    n_limbs(grad bits) planes, the exponents keeping the values' size at
    every plane count; lse from the forward kernel, delta = rowsum(g·o)
    and dS's exponent from the dequantized values, as ``int_attention``
    makes them; exponents [q, k, v, g, dS]."""
    from repro_torch.core import int_ops
    from repro_torch.kernels import int_attention as ia
    from repro_torch.kernels.dfx_quant import n_limbs
    B, Sq, Sk, KV, G, hd, off, causal, window, ab, gb = shape
    L, Lg = n_limbs(ab), n_limbs(gb)
    q = _planes(torch, gen, dev, L, B, Sq, KV, G, hd)
    k = _planes(torch, gen, dev, L, B, Sk, KV, hd)
    v = _planes(torch, gen, dev, L, B, Sk, KV, hd)
    g = _planes(torch, gen, dev, Lg, B, Sq, KV, G, hd)
    qo = torch.tensor(off if isinstance(off, list) else [off] * B,
                      dtype=torch.int32, device=dev)
    qe, ke, ve = (e - 7 * (L - 2) for e in (-12, -12, -9))
    ge = -20 - 7 * (Lg - 1)
    o, lse = ia.int_attn_fwd(
        q, k, v, qo, torch.tensor([qe, ke, ve], dtype=torch.int32,
                                  device=dev),
        p_bits=ab, causal=causal, window=window, sc=1.0 / hd ** 0.5)
    e = torch.tensor([ve, ge], dtype=torch.int32, device=dev)
    gd, vd = _dequant(g, e[1]), _dequant(v, e[0])
    delta = (gd * o).sum(-1)
    dse = int_ops._ds_exp(int_ops._max_row_norm(gd),
                          int_ops._max_row_norm(vd), gb)
    exps = torch.tensor([qe, ke, ve, ge, int(dse)], dtype=torch.int32,
                        device=dev)
    return q, k, v, g, lse, delta, qo, exps


def check_attention_bwd(torch, dev, gen):
    """int_attn_bwd_dq and int_attn_bwd_dkv against their plain versions at
    ATTN_BWD_SHAPES (the int8 preset's bits, FP32 and kept-int bodies; the
    sweep's shapes at int16, int12, int10 and int8, the FP32 body), timed
    at the qwen1.5-0.5b training shape (the kept-int body too: int_*) and,
    beside it, at qwen2-moe-a2.7b's (head dim 128; moe_*), at head dim
    256 (the widest body; hd256_*), head dim 384 (hd384_*) and the sweep's
    int16 calls (``sweep_rows``).  Tolerance: exact (the same expf or
    i_exp, the same exact int32 limb-pair dots and the same ordered f32
    sums on both sides).  Library: SDPA's f32
    backward at the same shape (dq, dk and dv together).  Bound: the bytes
    of the planes, rows and outputs, or the int8 operations of the
    limb-pair products over the (query, key) pairs the mask lets through,
    whichever is larger."""
    import torch.nn.functional as F
    from repro_torch.kernels import int_attention as ia
    from repro_torch.kernels.dfx_quant import n_limbs
    errs = {"int_attn_bwd_dq": 0.0, "int_attn_bwd_dkv": 0.0}
    timed = {}
    for label, shape in ATTN_BWD_SHAPES.items():
        B, Sq, Sk, KV, G, hd, off, causal, window, ab, gb = shape
        q, k, v, g, lse, delta, qo, exps = _attn_bwd_inputs(torch, dev, gen,
                                                            shape)
        for iexp in (False, True) if (ab, gb) == (12, 8) else (False,):
            kw = dict(ds_bits=gb, causal=causal, window=window,
                      sc=1.0 / hd ** 0.5, integer_exp=iexp)
            dq = ia.int_attn_bwd_dq(q, k, v, g, lse, delta, qo, exps,
                                    p_bits=ab, **kw)
            dk, dv = ia.int_attn_bwd_dkv(q, k, v, g, lse, delta, qo, exps,
                                         p_bits=ab, **kw)
            dq0 = ia.int_attn_bwd_dq_plain(q, k, v, g, lse, delta, qo, exps,
                                           **kw)
            dk0, dv0 = ia.int_attn_bwd_dkv_plain(q, k, v, g, lse, delta, qo,
                                                 exps, p_bits=ab, **kw)
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
                  f"body) at {label} {shape[:6]}, q/k/v {q.shape[0]} planes "
                  f"(P {ab} bits), g {g.shape[0]} (dS {gb} bits): "
                  + "; ".join(line), flush=True)
            if not iexp and label in ("qwen1.5-0.5b train",
                                      "qwen2-moe-a2.7b train",
                                      "head dim 256 (widest body)",
                                      "head dim 384") + SWEEP_TIMED \
                    + ARCH_ATTN:
                timed[label] = (shape, q, k, v, g, lse, delta, qo, exps, kw,
                                dq, dk, dv)

    def measure(shape, q, k, v, g, lse, delta, qo, exps, kw, dq, dk, dv,
                kept_int=False, time_plain=True):
        """{name: timings and bound} of both kernels at one shape, with
        SDPA's f32 backward (autograd, its graph built once; a boolean mask
        where a window bites) beside them; with ``kept_int`` also the
        kept-int bodies' timings (int_*); the plain versions' unless
        ``time_plain`` is False."""
        B, Sq, Sk, KV, G, hd, off, causal, window, ab, gb = shape
        H = KV * G
        qs, ks, vs = (torch.randn((B, H, S, hd), generator=gen, device=dev)
                      .requires_grad_(True) for S in (Sq, Sk, Sk))
        qpos = qo[:, None] + torch.arange(Sq, device=dev)          # (B, Sq)
        kpos = torch.arange(Sk, device=dev)
        seen = kpos <= qpos[..., None] if causal else \
            torch.ones((B, Sq, Sk), dtype=torch.bool, device=dev)
        if window is not None:
            seen = seen & (kpos > qpos[..., None] - window)
        out = (F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
               if window is None else
               F.scaled_dot_product_attention(qs, ks, vs,
                                              attn_mask=seen[:, None]))
        gout = torch.randn_like(out)

        def library():
            return torch.autograd.grad(out, (qs, ks, vs), gout,
                                       retain_graph=True)
        lib_t = dict(library_ms=cuda_ms(library),
                     library_device_ms=device_ms(library))
        # the (query, key) pairs the mask lets through
        pairs = int(seen.sum()) * KV * G
        rows = nbytes(lse, delta)
        # s (L x L limb pairs), dp (Lg x L), dq or dk (dS planes x L), and
        # dv (P planes x Lg)
        L, Lg, Lds = q.shape[0], g.shape[0], n_limbs(gb)
        res = {}
        for name, fn, plain, outs, limb_pairs in (
                ("int_attn_bwd_dq",
                 lambda: ia.int_attn_bwd_dq(q, k, v, g, lse, delta, qo, exps,
                                            p_bits=ab, **kw),
                 lambda: ia.int_attn_bwd_dq_plain(q, k, v, g, lse, delta, qo,
                                                  exps, **kw),
                 (dq,), L * L + Lg * L + Lds * L),
                ("int_attn_bwd_dkv",
                 lambda: ia.int_attn_bwd_dkv(q, k, v, g, lse, delta, qo,
                                             exps, p_bits=ab, **kw),
                 lambda: ia.int_attn_bwd_dkv_plain(q, k, v, g, lse, delta,
                                                   qo, exps, p_bits=ab, **kw),
                 (dk, dv), L * L + Lg * L + Lds * L + L * Lg)):
            b, by = bound_ms(nbytes(q, k, v, g, qo, exps, *outs) + rows,
                             2 * hd * pairs * limb_pairs)
            res[name] = {**timings(fn, plain if time_plain else None),
                         **lib_t, "bound_ms": b, "bound_by": by}
        if kept_int:
            ki = dict(kw, integer_exp=True)
            res["int_attn_bwd_dq"].update(int_body(timings(
                lambda: ia.int_attn_bwd_dq(q, k, v, g, lse, delta, qo, exps,
                                           p_bits=ab, **ki),
                lambda: ia.int_attn_bwd_dq_plain(q, k, v, g, lse, delta, qo,
                                                 exps, **ki)),
                bound_ms=res["int_attn_bwd_dq"]["bound_ms"],
                bound_by=res["int_attn_bwd_dq"]["bound_by"]))
            res["int_attn_bwd_dkv"].update(int_body(timings(
                lambda: ia.int_attn_bwd_dkv(q, k, v, g, lse, delta, qo,
                                            exps, p_bits=ab, **ki),
                lambda: ia.int_attn_bwd_dkv_plain(q, k, v, g, lse, delta, qo,
                                                  exps, p_bits=ab, **ki)),
                bound_ms=res["int_attn_bwd_dkv"]["bound_ms"],
                bound_by=res["int_attn_bwd_dkv"]["bound_by"]))
        return res

    main = measure(*timed["qwen1.5-0.5b train"], kept_int=True)
    moe = measure(*timed["qwen2-moe-a2.7b train"])
    wide = measure(*timed["head dim 256 (widest body)"])
    wide384 = measure(*timed["head dim 384"])
    sweep = {lb: measure(*timed[lb]) for lb in SWEEP_TIMED}
    arch = {lb: measure(*timed[lb], time_plain=lb != MIXTRAL_ATTN)
            for lb in ARCH_ATTN}
    shape = ATTN_BWD_SHAPES["qwen1.5-0.5b train"]
    B, Sq, Sk, KV, G, hd = shape[:6]
    out_k = []
    for name in ("int_attn_bwd_dq", "int_attn_bwd_dkv"):
        for what, m in (("qwen2-moe-a2.7b train (hd 128)", moe[name]),
                        ("head dim 256", wide[name]),
                        ("head dim 384 (direct body)", wide384[name]),
                        *((lb, r[name]) for lb, r in sweep.items()),
                        *((lb, r[name]) for lb, r in arch.items())):
            print(f"  {name} at {what}: call {m['ms']:.4f} ms, device "
                  f"{m['device_ms']:.4f} ms; plain device "
                  f"{_ms(m['plain_device_ms'])}; SDPA backward device "
                  f"{m['library_device_ms']:.4f}; bound {m['bound_ms']:.4f} "
                  f"ms ({m['bound_by']})", flush=True)
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
                  "(moe_*), at head dim 256 (hd256_*), at head dim 384 "
                  "(hd384_*, the direct body), at the sweep's int16 "
                  "calls (sweep_rows) and at phase 10's mixtral and "
                  "mistral-large calls (arch_rows); held at "
                  + ", ".join(ATTN_BWD_SHAPES)
                  + " (both bodies at the int8 bits); tolerance exact; "
                  "library: SDPA backward (f32, autograd, dq + dk + dv)",
            max_abs_err=errs[name], int_max_abs_err=errs[name + " int"],
            **main[name],
            **{f"moe_{k_}": v_ for k_, v_ in moe[name].items()},
            **{f"hd256_{k_}": v_ for k_, v_ in wide[name].items()},
            **{f"hd384_{k_}": v_ for k_, v_ in wide384[name].items()},
            sweep_rows=[dict(label=lb, max_abs_err=0.0, **r[name])
                        for lb, r in sweep.items()],
            arch_rows=[dict(label=lb, max_abs_err=0.0, **r[name])
                       for lb, r in arch.items()]))
    return out_k


def _quant_planes(torch, gen, dev, bits, *shape):
    """The limb planes of a seeded normal tensor quantized at ``bits`` (the
    quantize kernel, as a layer makes them: balanced base-2^7 digits, a
    small top plane)."""
    from repro_torch.core import dfx
    return dfx.quantize(torch.randn(shape, generator=gen, device=dev), bits,
                        limb_planes=True).m


def check_sweep_matmuls(torch, dev, gen, bert, tokens, vit_tokens) -> dict:
    """bfp_matmul, bfp_matmul_nt and bfp_matmul_tn at the sweep's limb
    pairs, on operands quantized as a layer quantizes them: 3x3 at 16 bits,
    2x2 at 12 and at 10.  At each full-width step's rows (bert-base cls
    and span, vit-base img: 32 x 197 = 6304 rows, a ragged last tile and
    the sweep's longest contraction), w1's forward X . W, its dX G . W^T
    and its dW X^T . G, held exactly against the plain versions (float64
    sums: a wrapped int32 sum would differ), with dW's largest
    |limb-pair sum| printed beside 2^31.  Timed beside torch._int_mm per
    limb pair: NT and TN at 3x3 on bert w1 and TN on vit w1 (int16), and
    NN, NT and TN at 2x2 on bert w1 (int12).  Returns {kernel: [row, ...]}."""
    from repro_torch.kernels import bfp_matmul as bm
    from repro_torch.kernels.dfx_quant import n_limbs
    D, F = bert.d_model, bert.d_ff
    e = torch.tensor(-30, dtype=torch.int32, device=dev)
    rows = {"bfp_matmul": [], "bfp_matmul_nt": [], "bfp_matmul_tn": []}
    for bits in (16, 12, 10):
        L = n_limbs(bits)
        w = _quant_planes(torch, gen, dev, bits, D, F)
        wt = [wj.t().contiguous() for wj in w]
        for T in (b * t for _, _, b, t in SWEEP_CELLS):
            label = f"{'vit' if T == vit_tokens else 'bert'} w1"
            what = f"int{bits} {L}x{L} {label} ({T} rows)"
            x = _quant_planes(torch, gen, dev, bits, T, D)
            g = _quant_planes(torch, gen, dev, bits, T, F)
            _held("bfp_matmul", bm.bfp_matmul(x, w, e),
                  bm.bfp_matmul_plain(x, w, e), f"{what} forward")
            _held("bfp_matmul_nt", bm.bfp_matmul_nt(g, w, e),
                  bm.bfp_matmul_nt_plain(g, w, e), f"{what} dX")
            _held("bfp_matmul_tn", bm.bfp_matmul_tn(x, g, e),
                  bm.bfp_matmul_tn_plain(x, g, e), f"{what} dW")
            peak = max(float((xi.t().double() @ gj.double()).abs().max())
                       for xi in x for gj in g)
            print(f"  {what}: forward, dX and dW bit for bit; dW's largest "
                  f"|limb-pair sum| {peak:.0f} = 2^{math.log2(peak):.2f} of "
                  "2^31 (no int32 wrap)", flush=True)
            if peak >= 2 ** 31:
                raise AssertionError(f"the {what} dW's int32 limb-pair sums "
                                     f"wrap: {peak}")
            timed = {(16, tokens): "nt tn", (16, vit_tokens): "tn",
                     (12, tokens): "nn nt tn"}.get((bits, T), "").split()
            n_ops = 2 * T * D * F * L * L
            if "nn" in timed:
                ws = [wj.contiguous() for wj in w]
                wc = [_colmajor(wj) for wj in w]
                rows["bfp_matmul"].append(mm_row(
                    f"{what} forward {T}x{D}x{F}",
                    lambda: bm.bfp_matmul(x, w, e), n_ops,
                    nbytes(x, w) + 4 * T * F,
                    {"int_mm": lambda: [torch._int_mm(xi, wj) for xi in x
                                        for wj in ws],
                     "int_mm_colmajor": lambda: [torch._int_mm(xi, wj)
                                                 for xi in x for wj in wc]}))
            if "nt" in timed:
                rows["bfp_matmul_nt"].append(mm_row(
                    f"{what} dX {T}x{F} . ({D}x{F})^T",
                    lambda: bm.bfp_matmul_nt(g, w, e), n_ops,
                    nbytes(g, w) + 4 * T * D,
                    {"int_mm": lambda: [torch._int_mm(gi, wj) for gi in g
                                        for wj in wt],
                     "int_mm_colmajor": lambda: [torch._int_mm(gi, wj.t())
                                                 for gi in g for wj in w]}))
            if "tn" in timed:
                xt = [xi.t().contiguous() for xi in x]
                gc_ = [_colmajor(gj) for gj in g]
                rows["bfp_matmul_tn"].append(dict(mm_row(
                    f"{what} dW ({T}x{D})^T . {T}x{F}",
                    lambda: bm.bfp_matmul_tn(x, g, e), n_ops,
                    nbytes(x, g) + 4 * D * F,
                    {"int_mm": lambda: [torch._int_mm(xi, gj) for xi in xt
                                        for gj in g],
                     "int_mm_colmajor": lambda: [torch._int_mm(xi, gj)
                                                 for xi in xt
                                                 for gj in gc_]}),
                    max_limb_pair_sum=peak))
    return rows


#: qwen2-moe-a2.7b training depth in phase 8 (of 24 layers): the deepest
#: that leaves 10% of the card's memory spare
MOE_TRAIN_LAYERS = 6

#: Phase 10's depths (PR 22), at full width.  FP32 bytes: a mistral-nemo-12b
#: layer is 272.6 M parameters (1.016 GiB), its untied embedding and head
#: 1.342 B (5.0 GiB); a mixtral-8x7b layer 1,451 M (5.41 GiB; the 8 expert
#: stacks 1,409 M), its embedding and head 262 M (0.98 GiB); a
#: mistral-large-123b layer 1,384 M (5.16 GiB), its embedding and head 805
#: M (3.0 GiB).  The card holds 79.18 GiB; 10% spare leaves 71.26.
#: Serving holds the FP32 weights, one weight's int8 planes at a time and a
#: 4-slot cache of 256 positions (measured peaks, H100 80GB HBM3: nemo
#: 47.23 GiB at its full 40 layers; mixtral 67.51 at 12 layers, 1.66 above
#: its weights, so 13 would need 72.9; large 65.66 at 12, 0.78 above its
#: weights, so 13 needs 70.8).
NEMO_SERVE_LAYERS, MIXTRAL_SERVE_LAYERS, LARGE_SERVE_LAYERS = 40, 12, 13
#: Training holds parameters, AdamW moments and gradients (16 bytes a
#: parameter, the update in place), at the end of the backward the
#: per-layer gradients of the stacked block weights beside their stack (up
#: to 4 more bytes a block parameter), and the step's activations (one
#: layer's under remat).  mixtral at 2 layers, batch 8 x 512 (T·K = 8192 >
#: 4096: the capacity dispatch, 1280 rows per expert): measured peak 54.19
#: GiB.  nemo at batch 8 x 256: 16-20 B x 272.6 M = 4.06-5.08 GiB a layer;
#: measured 57.56 GiB at 8 layers, so 10 layers need 65.7-67.7 GiB and 11
#: up to 72.8.  mistral-large at 2 layers, batch 8 x 256: 2 x 1,384 M x
#: 20 B + 805 M x 16 B = 68.2 GB = 63.5 GiB at most.
MIXTRAL_TRAIN_LAYERS, NEMO_TRAIN_LAYERS, LARGE_TRAIN_LAYERS = 2, 10, 2
#: mixtral's training batch (8 x 512 = 4096 tokens, 8192 choices of 2) and
#: its capacity rows per expert, ceil128(1.25 x 8192 / 8) = 1280
MIXTRAL_TRAIN_BATCH, MIXTRAL_TRAIN_ROWS = (8, 512), 1280
#: nemo on the chunked FP32 attention path: 1 x 4096 tokens at 2 layers
#: (``flash_attention``'s backward keeps no chunk's scores; without remat
#: a layer keeps its FP32 activations: the MLP's 4096 x 14336 rows, the
#: projections, norms and residuals, ~1.4 GiB)
NEMO_FP32_LAYERS, NEMO_FP32_SEQ = 2, 4096

#: qwen2-moe-a2.7b training step's capacity rows per expert (batch 8 x seq
#: 256, top-4 of 60: ceil128(1.25 * 8192 / 60)) and its decode's (4 slots
#: x top-4, drop-free)
MOE_TRAIN_ROWS, MOE_DECODE_ROWS = 256, 16


def _quant_row(torch, label, x, bits, limbs, u=None) -> dict:
    """A quantize call (``dfx_quantize``; ``dfx_quantize_grouped`` for a 3-d
    stack, one exponent per leading slice) held exactly against its plain
    version and timed beside its bound and, for 8 bits, the library's int8
    quantize at the same power-of-two scale(s)."""
    from repro_torch.core import dfx
    from repro_torch.kernels import dfx_quant as dq
    from repro_torch.kernels.dfx_quant import n_limbs
    grouped = x.dim() == 3
    name = "dfx_quantize_grouped" if grouped else "dfx_quantize"
    e = (dfx.slice_exponents(x) if grouped else dfx.scale_exponent(x)) \
        - (bits - 1)
    kernel = dq.dfx_quantize_grouped if grouped else dq.dfx_quantize
    plain = (dq.dfx_quantize_grouped_plain if grouped
             else dq.dfx_quantize_plain)
    out = kernel(x, e, bits=bits, u=u, limb_planes=limbs)
    _held(name, out, plain(x, e, bits=bits, u=u, limb_planes=limbs), label)
    del out
    if bits != 8:
        lib = None
    elif grouped:
        scales = dfx.pow2(e).double()
        zeros = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)

        def lib():
            return torch.quantize_per_channel(x, scales, zeros, 0,
                                              torch.qint8)
    else:
        scale = float(dfx.pow2(e))

        def lib():
            return torch.quantize_per_tensor(x, scale, 0, torch.qint8)
    d = device_ms(lambda: kernel(x, e, bits=bits, u=u, limb_planes=limbs))
    out_bytes = x.numel() * (n_limbs(bits) if limbs else
                             (1 if bits <= 8 else 2))
    b, by = bound_ms(nbytes(x) + out_bytes + (nbytes(u) if u is not None
                                              else 0), 0)
    ld = device_ms(lib) if lib else None
    print(f"  {name} {label}: held exactly; device {d:.4f} ms, "
          f"{100 * b / d:.1f}% of its bound {b:.4f} ms ({by}); "
          + (f"library {ld:.4f} ms (factor {d / ld:.2f})" if ld else
             "no int8 library call at these bits"), flush=True)
    return dict(label=label, device_ms=d, bound_ms=b, bound_by=by,
                library_device_ms=ld, factor=d / ld if ld else None,
                max_abs_err=0.0)


def check_arch_shapes(torch, dev, gen) -> dict:
    """Phase 2's holds at the shapes phase 10 gives the kernels (PR 22):
    mistral-nemo-12b (d_model 5120, attention width 4096, d_ff 14336, an
    untied 131,072-column head), mixtral-8x7b (d_model 4096, 8 experts of
    d_ff 14336, 1280 capacity rows each at batch 8 x 512) and
    mistral-large-123b (d_model 12288, d_ff 28672), at 2048 training rows
    (batch 8 x 256).  Each call held exactly against its plain version
    (the norms within the tolerances of ``norm_fwd_case`` /
    ``rms_bwd_case``), the listed ones timed beside the bound and the
    library call: the quantize of nemo's embedding table (8-bit mantissa),
    its head (8-bit planes) and its logits' gradient (2048 x 131072, g8
    planes, stochastic), and of large's wd; the grouped quantize of
    mixtral's expert stack, expert input (a12 planes) and expert gradient;
    nemo's head NN (logits), NT (dX over V = 2^17, its largest |limb-pair
    partial sum| printed against 2^31: the port wraps as the reference
    does) and TN (dW), large's wd NN (K = 28672), also held: large's wq,
    nemo's wq, wo and wd; the batched NN / NT / TN at mixtral's wg_e (and
    wd_e's NN held); the RMS-norm forward and backward at 2048 x {4096,
    5120, 12288} (mixtral, nemo, large).  Returns {kernel: [row, ...]}."""
    from repro_torch.kernels import bfp_matmul as bm
    from repro_torch.models import lm
    from repro_torch.configs import registry
    nemo = registry.get_config("mistral-nemo-12b")
    mixtral = registry.get_config("mixtral-8x7b")
    large = registry.get_config("mistral-large-123b")
    T, V = 8 * 256, lm.padded_vocab(nemo)
    rows = {k: [] for k in ("dfx_quantize", "dfx_quantize_grouped",
                            "bfp_matmul", "bfp_matmul_nt", "bfp_matmul_tn",
                            "bfp_matmul_batched", "bfp_matmul_batched_nt",
                            "bfp_matmul_batched_tn", "int_rmsnorm_fwd",
                            "int_rmsnorm_bwd")}
    e = torch.tensor(-30, dtype=torch.int32, device=dev)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    # ---- quantize
    x = randn(V, nemo.d_model, scale=0.02)
    rows["dfx_quantize"].append(_quant_row(
        torch, f"nemo embedding table ({V},{nemo.d_model}) -> 8-bit "
        "mantissa", x, 8, False))
    x = randn(nemo.d_model, V, scale=0.02)
    rows["dfx_quantize"].append(_quant_row(
        torch, f"nemo head ({nemo.d_model},{V}) -> 8-bit planes", x, 8,
        True))
    x = randn(T, V, scale=1e-6)
    u = torch.rand(x.shape, generator=gen, device=dev)
    rows["dfx_quantize"].append(_quant_row(
        torch, f"nemo logits' gradient ({T},{V}) -> g8 planes, stochastic",
        x, 8, True, u))
    del u
    x = randn(large.d_ff, large.d_model, scale=0.02)
    rows["dfx_quantize"].append(_quant_row(
        torch, f"large wd ({large.d_ff},{large.d_model}) -> 8-bit planes",
        x, 8, True))
    E, C, D, F = (mixtral.moe_experts, MIXTRAL_TRAIN_ROWS, mixtral.d_model,
                  mixtral.d_ff)
    x = randn(E, D, F, scale=0.02)
    rows["dfx_quantize_grouped"].append(_quant_row(
        torch, f"mixtral expert stack ({E},{D},{F}) -> 8-bit planes", x, 8,
        True))
    x = randn(E, C, D)
    x[3, C // 2:] = 0                         # an expert's empty rows
    rows["dfx_quantize_grouped"].append(_quant_row(
        torch, f"mixtral expert input ({E},{C},{D}) -> a12 planes", x, 12,
        True))
    x = randn(E, C, F, scale=1e-6)
    u = torch.rand(x.shape, generator=gen, device=dev)
    rows["dfx_quantize_grouped"].append(_quant_row(
        torch, f"mixtral expert gradient ({E},{C},{F}) -> g8 planes, "
        "stochastic", x, 8, True, u))
    del x, u

    # ---- NN / NT / TN: nemo's head, large's wd (and held-only calls)
    def libs(pairs):
        """torch._int_mm per limb pair, B row-major and column-major."""
        rm = [(a, b.contiguous()) for a, b in pairs]
        cm = [(a, _colmajor(b)) for a, b in pairs]
        return {"int_mm": lambda: [torch._int_mm(a, b) for a, b in rm],
                "int_mm_colmajor": lambda: [torch._int_mm(a, b)
                                            for a, b in cm]}

    def held(name, fn, plain, a, b, what, ex=e):
        _held(name, fn(a, b, ex), plain(a, b, ex), what)

    Dn = nemo.d_model
    xq = _quant_planes(torch, gen, dev, 12, T, Dn)            # (2, T, D)
    wh = _quant_planes(torch, gen, dev, 8, Dn, V)             # (1, D, V)
    held("bfp_matmul", bm.bfp_matmul, bm.bfp_matmul_plain, xq, wh,
         "nemo's head logits")
    rows["bfp_matmul"].append(mm_row(
        f"nemo head logits {T}x{Dn}x{V} 2x1", lambda: bm.bfp_matmul(
            xq, wh, e), 2 * T * Dn * V * 2, nbytes(xq, wh) + 4 * T * V,
        libs([(xj, wh[0]) for xj in xq])))
    g = _quant_planes(torch, gen, dev, 8, T, V)               # (1, T, V)
    held("bfp_matmul_nt", bm.bfp_matmul_nt, bm.bfp_matmul_nt_plain, g, wh,
         "nemo's head dX over V")
    peak = float((g[0].double() @ wh[0].double().t()).abs().max())
    print(f"  bfp_matmul_nt nemo head dX over V = {V}: bit for bit; largest "
          f"|limb-pair partial sum| {peak:.0f} = 2^{math.log2(peak):.2f} of "
          f"2^31 (at most {V} x 127^2 = 2^{math.log2(V * 127 ** 2):.3f})",
          flush=True)
    rows["bfp_matmul_nt"].append(dict(mm_row(
        f"nemo head dX {T}x{V} . ({Dn}x{V})^T 1x1",
        lambda: bm.bfp_matmul_nt(g, wh, e), 2 * T * V * Dn,
        nbytes(g, wh) + 4 * T * Dn, libs([(g[0], wh[0].t())])),
        max_limb_pair_sum=peak))
    held("bfp_matmul_tn", bm.bfp_matmul_tn, bm.bfp_matmul_tn_plain, xq, g,
         "nemo's head dW")
    peak = max(float((xj.t().double() @ g[0].double()).abs().max())
               for xj in xq)
    xt = [xj.t().contiguous() for xj in xq]
    rows["bfp_matmul_tn"].append(dict(mm_row(
        f"nemo head dW ({T}x{Dn})^T . {T}x{V} 2x1",
        lambda: bm.bfp_matmul_tn(xq, g, e), 2 * T * Dn * V * 2,
        nbytes(xq, g) + 4 * Dn * V,
        libs([(xj, g[0]) for xj in xt])), max_limb_pair_sum=peak))
    del xq, wh, g, xt
    xq = _quant_planes(torch, gen, dev, 12, T, large.d_ff)
    w = _quant_planes(torch, gen, dev, 8, large.d_ff, large.d_model)
    held("bfp_matmul", bm.bfp_matmul, bm.bfp_matmul_plain, xq, w,
         "large's wd")
    rows["bfp_matmul"].append(mm_row(
        f"large wd {T}x{large.d_ff}x{large.d_model} 2x1",
        lambda: bm.bfp_matmul(xq, w, e), 2 * T * large.d_ff * large.d_model
        * 2, nbytes(xq, w) + 4 * T * large.d_model,
        libs([(xj, w[0]) for xj in xq])))
    del xq, w
    for what, K, N in (("large wq", large.d_model, large.n_heads * 128),
                       ("nemo wq", Dn, nemo.n_heads * nemo.head_dim),
                       ("nemo wo", nemo.n_heads * nemo.head_dim, Dn),
                       ("nemo wd", nemo.d_ff, Dn)):
        held("bfp_matmul", bm.bfp_matmul, bm.bfp_matmul_plain,
             _planes(torch, gen, dev, 2, T, K), _planes(torch, gen, dev, 1,
                                                        K, N),
             f"{what} {T}x{K}x{N}")
    print("  bfp_matmul: large wq, nemo wq / wo / wd held exactly",
          flush=True)

    # ---- the batched trio at mixtral's wg_e (E = 8, 1280 rows)
    eb = torch.arange(E, dtype=torch.int32, device=dev) - 30
    x, wg, gg = (_planes(torch, gen, dev, 2, E, C, D),
                 _planes(torch, gen, dev, 1, E, D, F),
                 _planes(torch, gen, dev, 1, E, C, F))
    h, wd = _planes(torch, gen, dev, 2, E, C, F), _planes(torch, gen, dev,
                                                          1, E, F, D)
    for name, a, b, what, n_ops, out_n in (
            ("bfp_matmul_batched", x, wg, f"wg_e forward ({E},{C},{D})x"
             f"({E},{D},{F}) 2x1", 2 * E * C * D * F * 2, E * C * F),
            ("bfp_matmul_batched_nt", gg, wg, f"wg_e dX ({E},{C},{F}) . "
             f"({E},{D},{F})^T 1x1", 2 * E * C * F * D, E * C * D),
            ("bfp_matmul_batched_tn", x, gg, f"wg_e dW ({E},{C},{D})^T . "
             f"({E},{C},{F}) 2x1", 2 * E * C * D * F * 2, E * D * F)):
        fn, plain = getattr(bm, name), getattr(bm, name + "_plain")
        held(name, fn, plain, a, b, f"mixtral {what}", eb)
        if name == "bfp_matmul_batched":
            held(name, fn, plain, h, wd, "mixtral wd_e forward", eb)
            pairs = [(aj[i], b[0][i]) for aj in a for i in range(E)]
        elif name == "bfp_matmul_batched_nt":
            pairs = [(a[0][i], b[0][i].t()) for i in range(E)]
        else:
            pairs = [(aj[i].t().contiguous(), b[0][i]) for aj in a
                     for i in range(E)]
        rows[name].append(mm_row(
            f"mixtral {what}", lambda: fn(a, b, eb), n_ops,
            nbytes(a, b, eb) + 4 * out_n, libs(pairs)))
        del pairs
    del x, wg, gg, h, wd

    # ---- RMS-norm forward and backward at the three widths
    for arch, cfg in (("mixtral", mixtral), ("nemo", nemo),
                      ("large", large)):
        rows["int_rmsnorm_fwd"].append(norm_fwd_row(
            f"{arch} training {T}x{cfg.d_model}",
            norm_fwd_case(torch, dev, gen, False, T, cfg.d_model)))
        r = rms_bwd_case(torch, dev, gen, T, cfg.d_model)
        rows["int_rmsnorm_bwd"].append(dict(
            r, label=f"{arch} training {T}x{cfg.d_model}"))
        d, b = r["device_ms"], r["bound_ms"]
        print(f"  int_rmsnorm_bwd {arch} training {T}x{cfg.d_model}: device "
              f"{d:.4f} ms, {100 * b / d:.1f}% of its bound {b:.4f} ms "
              f"({r['bound_by']}); library {r['library_device_ms']:.4f} ms "
              f"(factor {d / r['library_device_ms']:.2f})", flush=True)
    return rows


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


def small_config(arch: str):
    """``arch``'s reduced config (2 layers, d_model 128, 4 heads of 32),
    keeping the trait ``reduced()`` hides, as ``tests/test_torch_archs.py``
    does: mistral-nemo-12b's attention width unlike d_model (4 heads of
    48), mistral-large-123b's 12 query heads per kv head (one kv head of
    16)."""
    import dataclasses
    from repro_torch.configs import registry
    trait = {"mistral-nemo-12b": dict(head_dim=48),
             "mistral-large-123b": dict(n_heads=12, n_kv_heads=1,
                                        head_dim=16)}
    return dataclasses.replace(registry.get_config(arch).reduced(),
                               **trait.get(arch, {}))


def check_small_model(torch, dev, arch="qwen1.5-0.5b"):
    """A dense arch's reduced config (``small_config``, 2 layers): prefill
    + 3 decode steps on the card (CUDA kernels) against the port's CPU
    path (plain versions)."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    cfg = small_config(arch)
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
    print(f"  reduced {arch}, card vs CPU logits: max |diff| / max|ref| "
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


def check_small_sweep(torch, dev):
    """The sweep's presets on reduced models: one training step, rounding
    to nearest, on the card against the port's CPU path from the same
    weights and batch, with ``check_small_bert``'s tolerances (loss 1e-5
    relative, every gradient within 2e-3 of its largest magnitude): the
    reduced bert-base cls step at int16 (3 limb planes, integer
    attention), and a reduced ViT (2 layers, d_model 128, 32 x 32 images in
    8 x 8 patches: 17 tokens, a ragged key block) at int16 and int8."""
    import dataclasses
    import functools
    from repro_torch.configs import bert_base
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import paper_models as pm
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as topt
    bert = bert_base.CONFIG.reduced()
    vit = pm.vit_config(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                        img=32, patch=8, name="vit-2l-d128")
    ocfg = topt.OptimizerConfig(lr=1e-3, weight_decay=0.0)
    for model, preset in (("bert", "int16"), ("vit", "int16"),
                          ("vit", "int8")):
        qcfg = dataclasses.replace(QuantConfig.preset(preset),
                                   stochastic_grad=False)
        g = torch.Generator().manual_seed(1)
        if model == "bert":
            cfg, loss_fn = bert, pm.bert_cls_loss
            params = pm.bert_init(g, cfg, num_labels=4, device="cpu")
            batch = tf.make_cls_task(vocab=cfg.vocab, seq=32)(4, 0)
        else:
            cfg = vit
            loss_fn = functools.partial(pm.vit_cls_loss, patch=8)
            params = pm.vit_init(g, cfg, num_classes=4, img=32, patch=8,
                                 device="cpu")
            batch = tf.make_img_task(img=32, patch=8)(4, 0)
        res = {}
        for device in ("cpu", dev):
            p = _to(params, device)
            _, _, loss, grads, _ = tf.train_step(
                p, topt.init(p), tf.to_device(batch, device), cfg, qcfg,
                loss_fn, ocfg, None)
            res[str(device)] = (float(loss), {n: g_.cpu()
                                              for n, g_ in _leaves(grads)})
        (l0, g0), (l1, g1) = res["cpu"], res[str(dev)]
        dl = abs(l1 - l0) / abs(l0)
        worst, at = _grad_agreement(torch, g0, g1)
        print(f"  reduced {cfg.name} step ({preset}), card vs CPU: loss "
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

    def forward_calls(self) -> list:
        """The first of two recorded steps' calls (the CPU step's), without
        the per-layer remat's recompute calls: their outputs feed no
        backward, so they receive no gradient."""
        return [e for e in self.calls[:len(self.calls) // 2]
                if e["g"] is not None]

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
    heads over 2 kv heads), mistral-nemo-12b and mistral-large-123b
    (``small_config``): one ``lm_loss`` step under int8, rounding to
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
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import trainer
    rn = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    for arch, label, qcfg in (
            ("qwen1.5-0.5b", "int8", rn), ("smollm-135m", "int8", rn),
            ("qwen1.5-0.5b", "int8 + kept-int",
             dataclasses.replace(rn, kept_ops="integer")),
            ("mistral-nemo-12b", "int8", rn),
            ("mistral-large-123b", "int8", rn)):
        cfg = small_config(arch)
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
        calls = rec.forward_calls()
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


def check_small_moe(torch, dev, arch="qwen2-moe-a2.7b", seq=64, prompt=9):
    """A MoE arch's reduced config (2 layers, d_model 128, 4 experts top-2;
    qwen2-moe-a2.7b with a shared expert of 128, mixtral-8x7b with a
    window of 64 keys) on the card against the port's CPU path from the
    same weights: the served logits (a prompt of ``prompt`` tokens, then 3
    decode steps, 4 rows) and one ``lm_loss`` step on 4 x ``seq`` tokens
    under int8, rounding to nearest (past the window, either makes it
    bite).

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
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import trainer
    cfg = small_config(arch)
    params = lm.lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    B = 4
    toks = torch.randint(0, cfg.vocab, (B, prompt), generator=gen)
    dec = torch.randint(0, cfg.vocab, (3, B, 1), generator=gen)
    outs, routes = {}, {}
    for device in ("cpu", dev):
        p = _to(params, device)
        cache = lm.init_cache(cfg, B, max(64, prompt + 16), device=device)
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
    print(f"  reduced {arch} served, card vs CPU: {n_rr} token "
          f"routings of {sum(x.shape[0] for x in routes['cpu'])} differ "
          f"({int(bad.sum())} of {B} rows set aside); logits of the other "
          f"rows max |diff| / max|ref| = {worst:.3e} (tolerance 5e-3)")
    if worst > 5e-3:
        raise AssertionError("card MoE logits disagree with the CPU path")

    rn = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    batch = next(SyntheticLM(DataConfig(batch_size=4, seq_len=seq,
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
    n_tok = 4 * seq
    n_rr, _ = _rerouted(torch, routes["cpu"], routes[str(dev)], 4)
    dl = abs(l1 - l0) / abs(l0)
    worst, at = _grad_agreement(torch, g0, g1)
    calls = rec.forward_calls()
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
    print(f"  reduced {arch} lm_loss step (int8), card vs CPU: "
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
                prompt_len: int = 64, new: int = 16,
                max_share: float = 1.0) -> dict:
    """Serve ``cfg`` at full width, int8 (w8·a12), random weights from a
    seeded generator: 4 slots, max_seq 256, ``n_req`` requests of
    ``prompt_len``-token prompts, ``new`` new tokens each, through
    ``ContinuousBatcher.run_until_drained``.  The launch counters are set
    to 0 just before the run and read just after; every kernel in
    ``wrappers`` must have launched.  Prints tokens/s, peak memory, one
    decode step's time and launches, one prefill's time and a profiled
    decode step.  The peak memory must stay within ``max_share`` of the
    card's.  Returns the run's launches."""
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
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"  served {n_req} requests ({prompt_len}-token prompts, {new} new "
          f"tokens each) in {dt:.3f} s: {tokens / dt:.1f} generated tok/s, "
          f"{n_req * (prompt_len + new) / dt:.1f} processed tok/s; peak "
          f"memory {peak:.2f} GiB ({100 * peak / total:.1f}% of "
          f"{total:.2f}); launches {launches}")
    if peak > max_share * total:
        raise AssertionError(f"serving peak {peak:.2f} GiB is past "
                             f"{max_share:.0%} of the card's {total:.2f} GiB")
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


def train_cut_phase(torch, dev, cfg, wrappers, batch=(8, 256),
                    steps: int = 6, lr: float = 1e-4) -> dict:
    """Train ``cfg`` — a full-width config with its depth cut to fit, as
    ``cfg.n_layers`` says — through ``lm_loss`` + ``make_train_step`` (what
    ``launch.train`` wires; the launcher has no depth flag, as the
    reference's has none), with the per-layer remat on: int8, ``batch``
    (rows x tokens) of ``SyntheticLM``, ``steps`` AdamW steps at ``lr``,
    random weights and stochastic gradient rounding from one seeded CUDA
    generator.  The depth is the deepest that leaves 10% of the card's
    memory spare, with parameters, AdamW moments and gradients (16 bytes a
    parameter: the update runs in place) and the step's activations.  The
    launch counters are set to 0 just before the int8 run and read just
    after; every kernel in ``wrappers`` must have launched, every loss be
    finite and the first within 1 of ln(vocab) + d_model x 0.02^2 / 2 (the
    cross entropy of the random head's logits), and the peak must leave
    10% of the card's memory.  Then one profiled int8 step, and the same steps
    under FP32 from the same init.  Returns the int8 run's launches."""
    import math
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    from repro_torch.train.finetune import to_device
    B, S = batch

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
        raise AssertionError(f"non-finite {cfg.name} training loss: {losses}")
    # random weights: the head's logits have variance d_model x 0.02^2
    # over unit-RMS features, so the first loss sits near ln V + that / 2
    expect = math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2
    if abs(losses[0] - expect) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln {cfg.vocab} + {cfg.d_model} x 0.02^2 / 2 "
                             f"= {expect:.3f}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {n} was not launched on the "
                                 f"{cfg.name} training path")
    first_ms = 1e3 * (stamps[0] - t_start)
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    med = statistics.median(step_ms)
    tok_s = B * S * len(step_ms) / sum(step_ms) * 1e3
    last = {n: counts[-1][n] - counts[-2][n] for n in wrappers}
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"  {cfg.name}, {cfg.n_layers} layers, batch {B} x {S}, "
          f"{n_params / 1e9:.3f} B parameters; set-up + step 0 "
          f"{first_ms:.2f} ms; steps 1-{steps - 1} ms "
          f"{[round(v, 2) for v in step_ms]}; median {med:.2f} ms; "
          f"{tok_s:.1f} tokens/s over those steps; peak memory {peak:.2f} "
          f"GiB of {total:.2f} GiB ({100 * peak / total:.1f}%); launches in "
          f"the run {launches}; in one step {last}", flush=True)
    if peak > 0.9 * total:
        raise AssertionError(f"peak {peak:.2f} GiB leaves less than 10% of "
                             f"the card's {total:.2f} GiB")
    profile_step(torch, one_step, f"{cfg.name} training step "
                 f"({cfg.n_layers} layers, int8)")
    del one_step, run
    gc.collect()
    torch.cuda.empty_cache()
    one_step, run = start("fp32")
    losses32 = [one_step() for _ in range(steps)]
    del one_step, run
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  lr {lr}; int8 losses {[round(v, 5) for v in losses]}; FP32 "
          f"losses from the same init {[round(v, 5) for v in losses32]}")
    return launches


def fp32_remat_phase(torch, dev, steps: int = 2, lr: float = 1e-4) -> dict:
    """mistral-nemo-12b at full width, ``NEMO_FP32_LAYERS`` layers, on the
    chunked FP32 attention path (``blocks.flash_attention``): batch 1 x
    ``NEMO_FP32_SEQ`` tokens under the ``fp32`` preset, ``steps`` AdamW
    steps with the per-layer remat on (peak memory from the start), one
    profiled step, then one step from the same init with ``remat=False``
    (``_backbone_train``'s internal switch; its own peak).  No kernel
    runs on this path: every launch counter must stay 0.  Prints losses,
    step ms, tokens/s, both peaks and the busy share."""
    import dataclasses
    import functools
    import math
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    from repro_torch.train.finetune import to_device
    cfg = dataclasses.replace(registry.get_config("mistral-nemo-12b"),
                              n_layers=NEMO_FP32_LAYERS)
    S = NEMO_FP32_SEQ
    wrappers = kops.wrappers()

    def run_steps(n, remat=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.lm_init(gen, cfg, device=dev)
        step = trainer.make_train_step(
            lm.lm_loss, cfg, registry.get_quant("fp32"),
            opt_lib.OptimizerConfig(lr=lr, total_steps=steps))
        data = SyntheticLM(DataConfig(batch_size=1, seq_len=S,
                                      vocab=cfg.vocab, seed=0))
        state = {"p": params, "o": opt_lib.init(params)}
        del params
        orig = lm._backbone_train
        lm._backbone_train = functools.partial(orig, remat=remat)
        losses, stamps = [], []
        try:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            for _ in range(n):
                batch = to_device(next(data), dev)
                state["p"], state["o"], m = step(state["p"], state["o"],
                                                 batch, gen)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
            peak = torch.cuda.max_memory_allocated() / 2**30
            if remat:
                profile_step(torch, lambda: step(
                    state["p"], state["o"], to_device(next(data), dev), gen),
                    f"{cfg.name} FP32 training step (1 x {S}, "
                    f"{cfg.n_layers} layers, remat)")
        finally:
            lm._backbone_train = orig
        return losses, [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])], \
            peak

    for w in wrappers.values():
        w.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, peak = run_steps(steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses0, ms0, peak0 = run_steps(1, remat=False)
    launched = {n: w.launches for n, w in wrappers.items() if w.launches}
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses + losses0):
        raise AssertionError(f"non-finite FP32 nemo loss: {losses} "
                             f"{losses0}")
    expect = math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2
    if abs(losses[0] - expect) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"{expect:.3f} (as train_cut_phase's)")
    if launched:
        raise AssertionError(f"kernels launched on the FP32 path: {launched}")
    print(f"  {cfg.name}, {cfg.n_layers} layers, 1 x {S} tokens, fp32: "
          f"remat on: losses {[round(v, 5) for v in losses]}, step ms "
          f"{[round(v, 2) for v in ms]} ({S * len(ms) / sum(ms) * 1e3:.1f} "
          f"tokens/s), peak {peak:.2f} GiB; remat off, one step from the "
          f"same init: loss {losses0[0]:.5f}, {ms0[0]:.2f} ms, peak "
          f"{peak0:.2f} GiB; launches 0 (no kernel on this path)",
          flush=True)
    return dict(peak_remat=peak, peak_no_remat=peak0, step_ms=ms,
                step_ms_no_remat=ms0)


def arch_phase(torch, dev) -> dict:
    """Phase 10 (PR 22): mistral-nemo-12b, mixtral-8x7b and
    mistral-large-123b at full width, int8.  Serving through
    ``serve_phase`` (4 slots, 8 requests x (64 + 16) tokens): nemo at full
    depth, mixtral and large at the depths that leave 10% of the memory
    spare.  Training through ``train_cut_phase`` (4 AdamW steps, remat
    on, stochastic gradient rounding): mixtral at 2 layers and batch 8 x
    512 (the capacity dispatch), nemo at ``NEMO_TRAIN_LAYERS`` and large
    at 2, batch 8 x 256.  Then nemo on the FP32 path at 1 x 4096 tokens
    (``fp32_remat_phase``).  Each model is freed before the next.
    Returns each run's launches by path name."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import ops as kops
    serve = ("dfx_quantize", "bfp_matmul", "int_rmsnorm_fwd", "int_attn_fwd")
    moe_fwd = ("dfx_quantize_grouped", "bfp_matmul_batched")
    train = ("dfx_quantize", "bfp_matmul", "bfp_matmul_nt", "bfp_matmul_tn",
             "int_rmsnorm_fwd", "int_rmsnorm_bwd", "int_attn_fwd",
             "int_attn_bwd_dq", "int_attn_bwd_dkv")
    moe_train = moe_fwd + ("bfp_matmul_batched_nt", "bfp_matmul_batched_tn")
    out = {}
    for key, arch, depth in (("nemo", "mistral-nemo-12b", NEMO_SERVE_LAYERS),
                             ("mixtral", "mixtral-8x7b",
                              MIXTRAL_SERVE_LAYERS),
                             ("large", "mistral-large-123b",
                              LARGE_SERVE_LAYERS)):
        cfg = dataclasses.replace(registry.get_config(arch), n_layers=depth)
        t0 = time.perf_counter()
        print(f"[10] serve {arch}, {depth} of "
              f"{registry.get_config(arch).n_layers} layers, int8")
        out[f"serve_{key}"] = serve_phase(
            torch, dev, cfg, kops.wrappers(
                *serve, *(moe_fwd if cfg.moe_experts else ())),
            max_share=0.9)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[10] {arch} served in {time.perf_counter() - t0:.1f} s",
              flush=True)
    for key, arch, depth, batch in (
            ("mixtral", "mixtral-8x7b", MIXTRAL_TRAIN_LAYERS,
             MIXTRAL_TRAIN_BATCH),
            ("nemo", "mistral-nemo-12b", NEMO_TRAIN_LAYERS, (8, 256)),
            ("large", "mistral-large-123b", LARGE_TRAIN_LAYERS, (8, 256))):
        cfg = dataclasses.replace(registry.get_config(arch), n_layers=depth)
        t0 = time.perf_counter()
        print(f"[10] train {arch}, {depth} layers, int8, batch {batch[0]} x "
              f"{batch[1]}, remat on")
        out[f"train_{key}"] = train_cut_phase(
            torch, dev, cfg, kops.wrappers(
                *train, *(moe_train if cfg.moe_experts else ())),
            batch=batch, steps=4)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[10] {arch} trained in {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    print(f"[10] train mistral-nemo-12b on the FP32 path, {NEMO_FP32_LAYERS} "
          f"layers, 1 x {NEMO_FP32_SEQ} tokens, remat on and off")
    fp32_remat_phase(torch, dev)
    print(f"[10] FP32 nemo in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


#: phase 9: the paper's presets, and the full-width cells (task, config
#: module, batch, tokens per sample)
SWEEP_PRESETS = ("fp32", "int16", "int12", "int10", "int8")
SWEEP_CELLS = (("cls", "bert_base", 32, 128), ("span", "bert_base", 12, 384),
               ("img", "vit_base", 32, 197))
#: the kernels of phase 9's path: each launches at every integer preset
SWEEP_KERNELS = ("dfx_quantize", "bfp_matmul", "bfp_matmul_nt",
                 "bfp_matmul_tn", "int_layernorm_fwd", "int_layernorm_bwd",
                 "int_attn_fwd", "int_attn_bwd_dq", "int_attn_bwd_dkv")


def sweep_full_width(torch, dev, wrappers) -> dict:
    """Phase 9, full width: bert-base cls and span and vit-base img through
    ``finetune`` at each of SWEEP_PRESETS (the plain presets, as the
    reference's ``sweep`` runs them: integer attention, stochastic gradient
    rounding from a seeded CUDA generator), lr 1e-4, 6 steps each.  The
    launch counters are set to 0 just before each run and read just after.
    Every loss must be finite; at each integer preset every kernel of the
    path launches in every step, and each wrapper's launches per step are
    the same at int16, int12, int10 and int8 (the reference's
    ``step_stats`` claim); FP32 launches none.  Prints the losses, the
    median of steps 1-5, tokens/s, the peak, the launches per step, and a
    profiled step's busy share at int16 and int8.  Returns each wrapper's
    launches over the integer runs."""
    import importlib
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as topt
    total = dict.fromkeys(wrappers, 0)
    for task, module, batch, seq in SWEEP_CELLS:
        conf = importlib.import_module(f"repro_torch.configs.{module}")
        arch = conf.CONFIG
        ft = tf.FtConfig(steps=6, batch=batch, eval_n=batch, lr=1e-4,
                         **({"img": conf.IMG} if task == "img" else
                            {"seq": seq}))
        per_preset = {}
        for p in SWEEP_PRESETS:
            stamps, counts = [], []

            def on_step(i, loss):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                counts.append({n: w.launches for n, w in wrappers.items()})
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            t_start = time.perf_counter()
            metric, losses = tf.finetune(task, QuantConfig.preset(p), ft,
                                         device=dev, arch=arch,
                                         return_losses=True, on_step=on_step)
            torch.cuda.synchronize()
            launches = {n: w.launches for n, w in wrappers.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"non-finite {task} {p} loss: {losses}")
            steps = _per_step(counts)
            st = _step_stats(torch, stamps, t_start, batch * seq)
            last = {n: c for n, c in steps[-1].items() if c}
            print(f"  {arch.name} {task} {p}: losses "
                  f"{[round(v, 5) for v in losses]}; steps 1-5 ms "
                  f"{[round(v, 2) for v in st['step_ms']]}, median "
                  f"{st['median_ms']:.2f} ms, {st['tok_s']:.1f} tokens/s; "
                  f"set-up + step 0 {st['first_ms']:.2f} ms; peak "
                  f"{peak:.2f} GiB; launches per step {last} (run, eval "
                  f"included: {sum(launches.values())}); eval metric "
                  f"{metric:.1f}% on {batch}", flush=True)
            if p == "fp32":
                if any(launches.values()):
                    raise AssertionError(f"FP32 {task} launched kernels: "
                                         f"{launches}")
            else:
                for n in SWEEP_KERNELS:
                    if not all(s_[n] > 0 for s_ in steps):
                        raise AssertionError(
                            f"kernel {n} was not launched in every {task} "
                            f"{p} step: {[s_[n] for s_ in steps]}")
                for n, c in launches.items():
                    total[n] += c
            per_preset[p] = steps[-1]
        ints = [p for p in SWEEP_PRESETS if p != "fp32"]
        for n in wrappers:
            seen = {p: per_preset[p][n] for p in ints}
            if len(set(seen.values())) != 1:
                raise AssertionError(f"{task}: {n}'s launches per step differ "
                                     f"across the integer presets: {seen}")
        print(f"  {task}: launches per step equal at "
              f"{', '.join(ints)}: {sum(per_preset['int8'].values())} "
              "(delta 0 against int8)", flush=True)
        for p in ("int16", "int8"):
            gen = torch.Generator(device=dev).manual_seed(1)
            cfg, params, sampler, loss_fn, lr = tf._task_setup(
                task, gen, ft, arch, dev)
            ocfg = topt.OptimizerConfig(lr=lr, weight_decay=0.0)
            state = {"p": params, "o": topt.init(params)}
            b = tf.to_device(sampler(batch, 0), dev)
            q = QuantConfig.preset(p)

            def one_step():
                state["p"], state["o"], _, _, _ = tf.train_step(
                    state["p"], state["o"], b, cfg, q, loss_fn, ocfg, gen)
            one_step()
            profile_step(torch, one_step, f"{arch.name} {task} step ({p})")
            del state, params
    return total


def sweep_reference_size(torch, dev) -> None:
    """Phase 9, the paper's numbers at the reference's sizes (bert-tiny /
    vit-tiny, batch 16, eval on 128): Tables 1-3 and Fig. 4 at 120 steps,
    Fig. 5 at 150 with its assertion (int16's final loss near FP32's).
    Prints each table's metric and drop against FP32, and int8's average
    drop over the three tables (the paper reports 3.1 points)."""
    from repro_torch.train import paper_tables as pt
    drops = []
    for title, fn in (("Table 1 (GLUE proxy, cls, accuracy)",
                       pt.table1_glue_sweep),
                      ("Table 2 (SQuAD proxy, span, exact match)",
                       pt.table2_squad_sweep),
                      ("Table 3 (CIFAR proxy, ViT img, accuracy)",
                       pt.table3_vit_sweep)):
        t0 = time.perf_counter()
        rows = fn(steps=120, device=dev)
        res = {r[0].split("/")[1]: pt.metric_of(r) for r in rows}
        drops.append(res["fp32"] - res["int8"])
        print(f"  {title}, 120 steps, {time.perf_counter() - t0:.1f} s: "
              + "; ".join(f"{p} {m:.2f} (drop {res['fp32'] - m:+.2f})"
                          for p, m in res.items()), flush=True)
    t0 = time.perf_counter()
    rows = pt.fig4_act_bits(steps=120, device=dev)
    print(f"  Fig. 4 (w8 g8, span EM by activation bits), 120 steps, "
          f"{time.perf_counter() - t0:.1f} s: "
          + "; ".join(f"{r[0].split('/')[1]} {pt.metric_of(r):.2f}"
                      for r in rows), flush=True)
    t0 = time.perf_counter()
    rows = pt.fig5_loss_traj(steps=150, device=dev)
    print(f"  Fig. 5 (span loss trajectories), 150 steps, "
          f"{time.perf_counter() - t0:.1f} s: final losses "
          + "; ".join(f"{r[0].split('/')[1]} {pt.metric_of(r):.4f}"
                      for r in rows) + " (int16 within 0.15 max(fp32, 0.1) "
          "+ 0.05 of fp32: holds)", flush=True)
    print(f"  int8's drop against FP32: {[round(d, 2) for d in drops]}, "
          f"average {sum(drops) / len(drops):+.2f} points (the paper: 3.1)",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 11: the state plane and the recovering training loop
# ---------------------------------------------------------------------------

def check_state_shapes(torch, dev, gen) -> dict:
    """Phase 2's holds of ``dfx_quantize_grouped`` at the state plane's
    shapes: the quantized moments keep one exponent per leading
    slice, so qwen1.5-0.5b's (152064, 1024) embedding moment (its 151,936
    tokens padded to a multiple of 256) is a (152064, 1, 1024) stack of
    152,064 slices (more than ``gridDim.y``'s 65,535),
    held exactly at round to nearest and stochastic, 1 plane (8 bits) and
    3 (16 bits), with an all-zero slice; and its 24 layers' (1024, 2816)
    MLP stacks.  Both timed at the moment update's call (8 bits,
    stochastic): call and device ms beside the bound and
    ``torch.quantize_per_channel``.  Returns {kernel: [row, ...]}."""
    from repro_torch.configs import registry
    from repro_torch.core import dfx
    from repro_torch.kernels import dfx_quant as dq
    from repro_torch.models import lm
    cfg = registry.get_config("qwen1.5-0.5b")
    V, D, F, L = lm.padded_vocab(cfg), cfg.d_model, cfg.d_ff, cfg.n_layers
    emb = torch.randn((V, 1, D), generator=gen, device=dev).mul_(1e-3)
    emb[7] = 0
    u = torch.rand(emb.shape, generator=gen, device=dev)
    for bits in (8, 16):
        e = dfx.slice_exponents(emb) - (bits - 1)
        for uu in (None, u):
            _held("dfx_quantize_grouped",
                  dq.dfx_quantize_grouped(emb, e, bits=bits, u=uu,
                                          limb_planes=True),
                  dq.dfx_quantize_grouped_plain(emb, e, bits=bits, u=uu,
                                                limb_planes=True),
                  f"({V}, 1, {D}) at {bits} bits, "
                  + ("stochastic" if uu is not None else "round to nearest"))
    print(f"  dfx_quantize_grouped: held exactly at ({V}, 1, {D}), 1 and 3 "
          "planes, round to nearest and stochastic", flush=True)
    rows = []
    stack = torch.randn((L, D, F), generator=gen, device=dev).mul_(1e-3)
    us = torch.rand(stack.shape, generator=gen, device=dev)
    for label, x, uu in ((f"qwen embedding moment ({V},1,{D}), 8-bit "
                          "plane, stochastic", emb, u),
                         (f"qwen MLP stack moment ({L},{D},{F}), 8-bit "
                          "plane, stochastic", stack, us)):
        row = _quant_row(torch, label, x, 8, True, uu)
        e = dfx.slice_exponents(x) - 7
        row["ms"] = cuda_ms(lambda: dq.dfx_quantize_grouped(
            x, e, bits=8, u=uu, limb_planes=True))
        print(f"    call {row['ms']:.4f} ms", flush=True)
        rows.append(row)
    del emb, u, stack, us
    return {"dfx_quantize_grouped": rows}


def _moment_bytes(torch, opt_state) -> int:
    """Resident bytes of the AdamW moments (``QTensor.nbytes``, or 4 a
    float)."""
    from repro_torch.core import qtensor
    from repro_torch.train import optimizer as opt_lib
    return sum(x.nbytes if qtensor.is_qtensor(x) else x.numel() * 4
               for t in (opt_state.m, opt_state.v)
               for x in opt_lib.tree_leaves(t))


def _dir_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def state_plane_qwen(torch, dev, wrappers, steps: int = 6,
                     lr: float = 1e-4) -> dict:
    """Phase 11a: qwen1.5-0.5b at full width through ``launch.train``,
    int8, batch 8 x seq 256, ``steps`` steps from seed 0, three runs:
    FP32 moments, int8 QTensor moments (``--state-bits 8``), and int8
    moments with the int8 parameter image (``--gather-bits 8``).  Every
    counter is set to 0 just before each run and read just after; each run
    must launch every training kernel, the state-bits runs the grouped
    quantize too (the moments' per-slice exponents).  Each run writes its
    final checkpoint into a temporary directory that is then removed.
    Prints the losses, the median of steps 1.., tokens/s, peak memory,
    the resident moment bytes, the launches per step and the bytes of the
    checkpoint.  Returns {run: launches}."""
    import math
    import shutil
    import tempfile
    from repro_torch.launch import train as lt
    base = ["--arch", "qwen1.5-0.5b", "--batch", "8", "--seq", "256",
            "--steps", str(steps), "--lr", str(lr), "--log-every",
            str(steps), "--device", str(dev), "--quant", "int8"]
    runs = {"state_bits_0": [], "state_bits_8": ["--state-bits", "8"],
            "state_bits_8_gather_8": ["--state-bits", "8", "--gather-bits",
                                      "8"]}
    out, report = {}, {}
    for name, extra in runs.items():
        stamps, counts = [], []

        def on_step(i, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts.append({n: w.launches for n, w in wrappers.items()})
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            t_start = time.perf_counter()
            run = lt.train(lt.parse_args(base + extra + ["--ckpt-dir", tmp]),
                           on_step)
            torch.cuda.synchronize()
            t_saved = time.perf_counter()
            launches = {n: w.launches for n, w in wrappers.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            moment = _moment_bytes(torch, run.opt_state)
            disk = _dir_bytes(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        losses = [run.losses[i] for i in range(steps)]
        del run
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        need = [n for n in wrappers if n != "dfx_quantize_grouped"
                or name != "state_bits_0"]
        for n in need:
            if launches[n] <= 0:
                raise AssertionError(f"{name}: kernel {n} was not launched")
        st = _step_stats(torch, stamps, t_start, 8 * 256)
        report[name] = dict(losses=losses, median_ms=st["median_ms"],
                            tok_s=st["tok_s"], peak=peak, moment=moment,
                            disk=disk, per_step=_per_step(counts)[-1],
                            save_s=t_saved - stamps[-1])
        out[name] = launches
    print("  run: losses | median step ms (steps 1-5) | tokens/s | peak GiB "
          "| moment bytes | checkpoint bytes (final save s)")
    for name, r in report.items():
        print(f"  {name}: {[round(v, 5) for v in r['losses']]} | "
              f"{r['median_ms']:.2f} | {r['tok_s']:.1f} | {r['peak']:.2f} | "
              f"{r['moment']} ({r['moment'] / 1e9:.3f} GB) | {r['disk']} "
              f"({r['disk'] / 1e9:.3f} GB; {r['save_s']:.2f} s)")
    for name, r in report.items():
        print(f"  {name} launches per step: {r['per_step']}")
    return out


def _snapshot(torch, run) -> list:
    """Copies of a run's parameters and moments (QTensor planes and
    exponents), in a fixed order."""
    from repro_torch.core import qtensor
    from repro_torch.train import optimizer as opt_lib
    out = [p.clone() for p in opt_lib.tree_leaves(run.params)]
    for t in (run.opt_state.m, run.opt_state.v):
        for x in opt_lib.tree_leaves(t):
            out += ([x.m.clone(), x.exp.clone()] if qtensor.is_qtensor(x)
                    else [x.clone()])
    return out


def _bitwise(torch, a: list, b: list, what: str) -> None:
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        bad = sum(not torch.equal(x, y) for x, y in zip(a, b))
        raise AssertionError(f"{what}: {bad} of {len(a)} tensors differ")


def state_plane_chaos(torch, dev, wrappers, steps: int = 10) -> dict:
    """Phase 11b: smollm-135m at its full config (the end-to-end example's
    model), batch 8 x seq 128, ``--state-bits 8 --sentinel --ckpt-dir
    <tmp> --ckpt-every 2``, ``steps`` steps, each run in a temporary
    directory removed afterwards.  A clean run; a chaos run (preemption at
    step 3, a moment bit-flip at 5, the newest checkpoint's bytes flipped
    at 7, a 2 s straggler before 8) whose final parameters and moments
    must equal the clean run's bit for bit and whose events must hold the
    retries, restores, a ``ckpt-corrupt`` and a straggler at step 8; a NaN
    injected at step 4 (one ``skip-step``; the parameters and moments
    after step 4 equal those before it); and a sentinel forced to
    escalate (``clip_high`` 0): the rebuilt step (attention at 16 bits)
    must run the matmul and attention kernels on 3 limb planes, its step
    ms printed beside the int8 steps'.  Returns {run: launches}."""
    import math
    import shutil
    import tempfile
    from repro_torch.kernels import dfx_quant
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as lt
    from repro_torch.train import sentinel as sentinel_lib
    B, S = 8, 128
    base = ["--arch", "smollm-135m", "--batch", str(B), "--seq", str(S),
            "--steps", str(steps), "--lr", "3e-4", "--device", str(dev),
            "--state-bits", "8", "--sentinel", "--ckpt-every", "2",
            "--log-every", str(steps)]
    out = {}

    def go(name, extra, on_step=None, sentinel_cfg=None):
        """A run with its own checkpoint directory; ``on_step(run, step)``."""
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            args = lt.parse_args(base + extra + ["--ckpt-dir", tmp])
            run = lt.build(args, sentinel_cfg)
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            lt.train(args, on_step and (lambda i, m: on_step(run, i)), run)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out[name] = {n: w.launches for n, w in wrappers.items()}
        for n, c in out[name].items():
            if c <= 0:
                raise AssertionError(f"{name}: kernel {n} was not launched")
        losses = [run.losses[i] for i in sorted(run.losses)]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        print(f"  {name}: {dt:.1f} s; losses {[round(v, 5) for v in losses]}"
              f"; events {[e['type'] for e in run.events]}", flush=True)
        return run

    clean = go("clean", [])
    ref = _snapshot(torch, clean)
    del clean
    chaos = go("chaos", ["--chaos-preempt-at", "3", "--chaos-bitflip-at",
                         "5", "--chaos-corrupt-ckpt-at", "7",
                         "--chaos-straggle-at", "8", "--chaos-straggle-s",
                         "2"])
    for ev in chaos.events:
        print(f"    {ev}")
    kinds = [e["type"] for e in chaos.events]
    errors = {e["error"] for e in chaos.events if e["type"] == "retry"}
    if (kinds.count("retry") != 3 or kinds.count("restore") != 3
            or errors != {"Preemption", "StateCorruption"}
            or {"type": "ckpt-corrupt", "step": 6} not in chaos.events
            or not any(e["type"] == "straggler" and e["step"] == 8
                       for e in chaos.events)):
        raise AssertionError(f"chaos run events: {chaos.events}")
    _bitwise(torch, _snapshot(torch, chaos), ref,
             "chaos run's final parameters and moments against the clean "
             "run's")
    print("  chaos run's final parameters and moments equal the clean "
          "run's bit for bit", flush=True)
    del chaos, ref

    snaps = {}

    def keep(run, i):
        if i in (3, 4):
            snaps[i] = _snapshot(torch, run)
    run = go("nan", ["--chaos-nan-at", "4"], keep)
    skips = [e for e in run.events if e["type"] == "skip-step"]
    if skips != [{"type": "skip-step", "step": 4, "streak": 1}]:
        raise AssertionError(f"NaN run events: {run.events}")
    _bitwise(torch, snaps[4], snaps[3], "parameters and moments after the "
             "skipped step 4 against those before it")
    print("  NaN at step 4: one skip-step; parameters and moments after it "
          "equal those before it bit for bit", flush=True)
    del run, snaps

    planes, stamps = [], []
    mm, attn = kops.bfp_matmul, kops.int_attn_fwd

    def mm_rec(xm, wm, *a, **k):
        planes.append(("bfp_matmul", xm.shape[0], wm.shape[0]))
        return mm(xm, wm, *a, **k)

    def attn_rec(qm, km, vm, *a, **k):
        planes.append(("int_attn_fwd", qm.shape[0], km.shape[0]))
        return attn(qm, km, vm, *a, **k)

    def mark(run, i):
        torch.cuda.synchronize()
        stamps.append((i, time.perf_counter(), len(planes)))
    kops.bfp_matmul, kops.int_attn_fwd = mm_rec, attn_rec
    try:
        # no checkpoint until the last step: the step ms hold no save
        run = go("escalate", ["--steps", "6", "--ckpt-every", "100"], mark,
                 sentinel_lib.SentinelConfig(clip_high=0.0))
    finally:
        kops.bfp_matmul, kops.int_attn_fwd = mm, attn
    esc = [e for e in run.events if e["type"] == "escalation"]
    if not esc:
        raise AssertionError(f"no escalation: {run.events}")
    at = esc[0]["step"]
    n16 = dfx_quant.n_limbs(esc[0]["bits"])
    after = planes[stamps[at][2]:]
    for k in ("bfp_matmul", "int_attn_fwd"):
        if not any(p[0] == k and p[1] == n16 and p[2] == n16 for p in after):
            raise AssertionError(f"the rebuilt step ran no {n16}-plane {k}")
    ms = [1e3 * (b[1] - a[1]) for a, b in zip(stamps, stamps[1:])]
    print(f"  escalation {esc[0]} at step {at}; the rebuilt step runs "
          f"{n16}-plane bfp_matmul and int_attn_fwd; step ms "
          f"{[round(v, 2) for v in ms]} (steps 1-{at} int8, after them the "
          "escalated policy)", flush=True)
    del run
    return out


def state_plane_phase(torch, dev, kops) -> dict:
    """Phase 11: ``state_plane_qwen`` and ``state_plane_chaos``.
    Returns {path: launches} of the five runs."""
    lm_train = ("dfx_quantize", "bfp_matmul", "bfp_matmul_nt",
                "bfp_matmul_tn", "int_rmsnorm_fwd", "int_rmsnorm_bwd",
                "int_attn_fwd", "int_attn_bwd_dq", "int_attn_bwd_dkv")
    wrappers = kops.wrappers(*lm_train, "dfx_quantize_grouped")
    qwen = state_plane_qwen(torch, dev, wrappers)
    gc.collect()
    torch.cuda.empty_cache()
    chaos = state_plane_chaos(torch, dev, wrappers)
    return {**{f"state_{k}": v for k, v in qwen.items()},
            **{f"chaos_{k}": v for k, v in chaos.items()}}


def _to(tree, device):
    """A copy of the tree on ``device`` (a copy on the CPU too: a training
    step updates its parameters in place)."""
    return {k: _to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def main() -> int:
    import dataclasses
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
    from repro_torch.kernels import _lib
    from repro_torch.kernels import ops as kops
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
    sweep_rows = check_sweep_matmuls(torch, dev, gen, bert, tokens, 32 * 197)
    for k in kernels:
        if k["name"] in sweep_rows:
            k["sweep_rows"] = sweep_rows[k["name"]]
    arch_rows = check_arch_shapes(torch, dev, gen)
    for k in kernels:
        if k["name"] in arch_rows:
            k["arch_rows"] = arch_rows[k["name"]]
    state_rows = check_state_shapes(torch, dev, gen)
    for k in kernels:
        if k["name"] in state_rows:
            k["state_rows"] = state_rows[k["name"]]
    for k in kernels:
        print(f"  {k['name']}: max_abs_err {k['max_abs_err']:.3e}; call "
              f"{k['ms']:.4f} ms, device {k['device_ms']:.4f} ms; plain "
              f"{k['plain_ms']:.4f} / {k['plain_device_ms']:.4f}; library "
              f"{k['library_ms']} / {k['library_device_ms']}; bound "
              f"{k['bound_ms']:.4f} by {k['bound_by']} [{k['shape']}]")

    print("[3] reduced models, card vs CPU path")
    check_small_model(torch, dev)
    check_small_bert(torch, dev)
    check_small_sweep(torch, dev)
    check_small_lm_train(torch, dev)
    check_small_moe(torch, dev)
    check_small_moe_kept_int(torch, dev)
    for arch in ("mistral-nemo-12b", "mistral-large-123b"):
        check_small_model(torch, dev, arch)
    check_small_moe(torch, dev, "mixtral-8x7b", seq=80, prompt=89)

    print("[4] serve qwen1.5-0.5b, full width, int8")
    serve = ("dfx_quantize", "bfp_matmul", "int_rmsnorm_fwd", "int_attn_fwd")
    launches = serve_phase(torch, dev, cfg, kops.wrappers(*serve))
    print("[5] fine-tune bert-base, full width, paper scope (int8 linear / "
          "layer-norm / embedding), stochastic gradient rounding")
    matmuls = ("dfx_quantize", "bfp_matmul", "bfp_matmul_nt", "bfp_matmul_tn")
    attn = ("int_attn_fwd", "int_attn_bwd_dq", "int_attn_bwd_dkv")
    paper = matmuls + ("int_layernorm_fwd", "int_layernorm_bwd")
    lm_train = matmuls + ("int_rmsnorm_fwd", "int_rmsnorm_bwd") + attn
    ft_launches, ft8_launches = finetune_phase(
        torch, dev, kops.wrappers(*paper), kops.wrappers(*paper, *attn))
    print("[6] train qwen1.5-0.5b, full width, int8, batch 8 x seq 256, "
          "through launch.train")
    tr_launches = train_phase(torch, dev, kops.wrappers(*lm_train))
    print("[6b] kept_ops=\"integer\" at full width beside int8: bert-base "
          "cls (batch 32 x seq 128, 10 steps) and qwen1.5-0.5b training "
          "(batch 8 x seq 256, 6 steps)")
    gc.collect()
    torch.cuda.empty_cache()
    kept = kept_int_phase(torch, dev, kops.wrappers(*paper, *attn),
                          kops.wrappers(*lm_train))
    moe_fwd = ("dfx_quantize_grouped", "bfp_matmul_batched")
    gc.collect()
    torch.cuda.empty_cache()
    print("[7] serve qwen2-moe-a2.7b, full width and depth (24 layers, 60 "
          "experts top-4 + shared expert), int8; device memory allocated "
          f"before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    moe_serve = serve_phase(torch, dev, registry.get_config(
        "qwen2-moe-a2.7b"), kops.wrappers(*serve, *moe_fwd))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[8] train qwen2-moe-a2.7b, full width, {MOE_TRAIN_LAYERS} layers, "
          "int8, batch 8 x seq 256, lm_loss + make_train_step; device memory "
          f"allocated before: {torch.cuda.memory_allocated() / 2**30:.2f} "
          "GiB")
    moe_train = train_cut_phase(torch, dev, dataclasses.replace(
        moe, n_layers=MOE_TRAIN_LAYERS), kops.wrappers(
        *lm_train, *moe_fwd, "bfp_matmul_batched_nt", "bfp_matmul_batched_tn"))
    gc.collect()
    torch.cuda.empty_cache()
    print("[9] the paper's bit-width sweep (fp32, int16, int12, int10, "
          "int8): bert-base cls / span and vit-base img at full width, 6 "
          "steps each; Tables 1-3 and Figs. 4-5 at the reference's sizes")
    t9 = time.perf_counter()
    sweep_launches = sweep_full_width(torch, dev, kops.wrappers())
    print(f"[9] full width in {time.perf_counter() - t9:.1f} s", flush=True)
    sweep_reference_size(torch, dev)
    print(f"[9] phase took {time.perf_counter() - t9:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print("[10] mistral-nemo-12b, mixtral-8x7b and mistral-large-123b at full "
          "width, int8: served (nemo at full depth) and trained (remat on); "
          "nemo on the FP32 path at 1 x 4096 tokens; device memory "
          f"allocated before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t10 = time.perf_counter()
    arch_launches = arch_phase(torch, dev)
    print(f"[10] phase took {time.perf_counter() - t10:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("[11] the state plane and the recovering training loop: "
          "qwen1.5-0.5b at full width with FP32 / int8 moments / int8 "
          "moments + int8 parameter image; smollm-135m clean, chaos, NaN "
          "and escalation runs through launch.train")
    t11 = time.perf_counter()
    state_launches = state_plane_phase(torch, dev, kops)
    print(f"[11] phase took {time.perf_counter() - t11:.1f} s", flush=True)
    for k in kernels:
        by_path = {"serve": launches.get(k["name"], 0),
                   "finetune": ft_launches.get(k["name"], 0),
                   "finetune_int8": ft8_launches.get(k["name"], 0),
                   "train": tr_launches.get(k["name"], 0),
                   "serve_moe": moe_serve.get(k["name"], 0),
                   "train_moe": moe_train.get(k["name"], 0),
                   "finetune_keptint": kept["finetune_keptint"].get(
                       k["name"], 0),
                   "train_keptint": kept["train_keptint"].get(k["name"], 0),
                   "sweep": sweep_launches.get(k["name"], 0),
                   **{path: ls.get(k["name"], 0)
                      for path, ls in arch_launches.items()},
                   **{path: ls.get(k["name"], 0)
                      for path, ls in state_launches.items()}}
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
