#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (each raises on failure; nothing is caught):

1. Print the card (``nvidia-smi`` name and power limit); build the CUDA
   kernels from ``src/repro_torch/csrc`` and print the build seconds and
   the ``ptxas`` register / shared-memory report.
2. For each ported kernel, at the shapes the qwen1.5-0.5b serving path
   gives it: run the kernel and its plain PyTorch version on the card from
   the same seeded inputs and hold them together (integer outputs exactly,
   f32 outputs within the stated tolerance); time kernel, plain version and
   a one-call PyTorch yardstick with CUDA events (median); compute the
   card's lower bound from the bytes and int8 operations this call needs.
3. Check the served logits against the port's CPU path on a reduced
   qwen1.5-0.5b (2 layers) from the same weights.
4. Serve qwen1.5-0.5b at full width (24 layers, d_model 1024, vocab
   151936), int8 (w8·a12), random weights from a seeded generator: 4 slots,
   max_seq 256, 8 requests of 64-token prompts, 16 new tokens each, through
   ``ContinuousBatcher.run_until_drained``.  Every launch counter is set to
   0 just before and read just after; every kernel must have launched.
   Prints tokens/s, peak memory and the launches of one decode step.
5. Print the ``{"kernels": [...]}`` line, then the last line
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

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    """Least time the card could take: max(bytes / HBM rate, int8 ops /
    int8 tensor rate), and which of the two bounds it."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_quantize(torch, dev, gen, V, D):
    """dfx_quantize at the path's largest call: the whole embedding table
    (V, D) f32 -> int8 mantissas, re-quantized on every serving step."""
    from repro_torch.core import dfx
    from repro_torch.kernels import dfx_quant
    table = torch.randn((V, D), generator=gen, device=dev) * 0.02
    exp = dfx.scale_exponent(table) - 7
    cases = [(table, 8, False),                  # int_embedding table
             (table, 8, True),                   # tied head's planes
             (torch.randn((256, 2816), generator=gen, device=dev), 12, True)]
    err = 0.0
    for x, bits, limbs in cases:
        e = dfx.scale_exponent(x) - (bits - 1)
        got = dfx_quant.dfx_quantize(x, e, bits=bits, limb_planes=limbs)
        ref = dfx_quant.dfx_quantize_plain(x, e, bits=bits, limb_planes=limbs)
        if not torch.equal(got, ref):
            raise AssertionError(f"dfx_quantize differs from its plain "
                                 f"version at {tuple(x.shape)} bits={bits}")
        err = max(err, (got.float() - ref.float()).abs().max().item())
    u = torch.rand((256, 2816), generator=gen, device=dev)
    x = cases[2][0]
    e = dfx.scale_exponent(x) - 11
    if not torch.equal(dfx_quant.dfx_quantize(x, e, bits=12, u=u),
                       dfx_quant.dfx_quantize_plain(x, e, bits=12, u=u)):
        raise AssertionError("stochastic dfx_quantize differs")
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
    return dict(name="dfx_quantize", route="cuda",
                source="src/repro_torch/csrc/dfx_quant.cu",
                replaces="src/repro/kernels/dfx_quant.py:115",
                shape=f"x ({V},{D}) f32 -> int8, tolerance exact; "
                      "library: torch.quantize_per_tensor to qint8",
                max_abs_err=err, bound_ms=b, bound_by=by, **t)


def _planes(torch, gen, dev, L, *shape):
    return torch.randint(-64, 64, (L,) + shape, generator=gen, device=dev,
                         dtype=torch.int8)


def check_matmul(torch, dev, gen, cfg, V):
    """bfp_matmul at the path's shapes: the decode head (4 x 1024 x 152064,
    W K-major), a decode and a prefill linear; timed at the prefill MLP
    up-projection (256 x 1024 x 2816, 2x1 limbs)."""
    from repro_torch.kernels import bfp_matmul as bm
    D, F = cfg.d_model, cfg.d_ff
    exp = torch.tensor(-19, dtype=torch.int32, device=dev)
    head_w = _planes(torch, gen, dev, 1, V, D).transpose(1, 2)
    cases = [(_planes(torch, gen, dev, 2, 4, D), head_w),
             (_planes(torch, gen, dev, 2, 4, D), _planes(torch, gen, dev, 1, D, 3 * D)),
             (_planes(torch, gen, dev, 2, 256, F), _planes(torch, gen, dev, 1, F, D)),
             (_planes(torch, gen, dev, 2, 256, D), _planes(torch, gen, dev, 1, D, F))]
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
    return dict(name="bfp_matmul", route="cuda",
                source="src/repro_torch/csrc/bfp_matmul.cu",
                replaces="src/repro/kernels/bfp_matmul.py:147",
                shape=f"({M},{K})x({K},{N}), 2x1 limbs, tolerance exact; "
                      "library: torch._int_mm of one limb pair",
                max_abs_err=err, bound_ms=b, bound_by=by, head_ms=head_ms,
                head_device_ms=head_dev, head_bound_ms=head_b, **t)


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


def profile_decode_step(torch, engine, batcher) -> None:
    """torch.profiler over one decode step: wall time, summed device time
    (the device's busy share) and the device time by kernel or op."""
    from torch.profiler import ProfilerActivity, profile
    cache = {k: v.clone() for k, v in batcher.cache.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._decode(engine.params, batcher.last_tok, cache)
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
    print(f"  profiled decode step: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%) in {launches} "
          "device kernels / copies; top device time:")
    for dev_us, count, key in rows[:14]:
        print(f"    {dev_us / 1e3:8.3f} ms  {count:5d}x  {key[:110]}")


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
    from repro_torch.configs import registry
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
    kernels = [check_quantize(torch, dev, gen, V, cfg.d_model),
               check_matmul(torch, dev, gen, cfg, V),
               check_rmsnorm(torch, dev, gen, cfg.d_model),
               check_attention(torch, dev, gen, cfg)]
    for k in kernels:
        print(f"  {k['name']}: max_abs_err {k['max_abs_err']:.3e}; call "
              f"{k['ms']:.4f} ms, device {k['device_ms']:.4f} ms; plain "
              f"{k['plain_ms']:.4f} / {k['plain_device_ms']:.4f}; library "
              f"{k['library_ms']} / {k['library_device_ms']}; bound "
              f"{k['bound_ms']:.4f} by {k['bound_by']} [{k['shape']}]")

    print("[3] reduced model, card vs CPU path")
    check_small_model(torch, dev)

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
    profile_decode_step(torch, engine, batcher)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
