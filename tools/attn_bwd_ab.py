#!/usr/bin/env python3
"""Device time of the port's attention backward, kernel and training step.

    python3 tools/attn_bwd_ab.py [TREE]     # TREE: root of a checkout

Measures the checkout at TREE (default: this one) on the card: the device
time (torch.profiler, per call, through ``chip_smoke.device_ms``) of
``int_attn_bwd_dq`` and ``int_attn_bwd_dkv`` at the qwen1.5-0.5b and
bert-base training shapes and qwen2-moe-a2.7b's head dim 128 (int8
preset, ``chip_smoke.py`` phase 2's seeded inputs), with SDPA's f32
backward beside them; then the device time of one qwen1.5-0.5b int8
training step (full width, batch 8 x seq 256, ``launch.train``) and the
attention backward's part of it, over three profiled steps after two
warm-up steps.  To compare two commits on one card, unpack the other into
a git-ignored directory (``git archive``) and run both in turns in one
call:

    for t in build/parent . . build/parent; do
        python3 tools/attn_bwd_ab.py $t; done
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

SHAPES = {  # (B, Sq, Sk, KV, G, hd, offset, causal, window)
    "qwen1.5-0.5b train": (8, 256, 256, 16, 1, 64, 0, True, None),
    "bert-base cls": (32, 128, 128, 12, 1, 64, 0, False, None),
    "qwen2-moe-a2.7b train": (8, 256, 256, 16, 1, 128, 0, True, None),
}


def kernels(torch, root: Path) -> None:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.kernels import int_attention as ia
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, shape in SHAPES.items():
        B, Sq, Sk, KV, G, hd, _, causal, window = shape
        q, k, v, g, lse, delta, qo, exps = cs._attn_bwd_inputs(torch, dev, gen,
                                                               shape)
        kw = dict(p_bits=12, ds_bits=8, causal=causal, window=window,
                  sc=1.0 / hd ** 0.5)
        qs, ks, vs = (torch.randn((B, KV * G, S, hd), generator=gen,
                                  device=dev).requires_grad_(True)
                      for S in (Sq, Sk, Sk))
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)
        gout = torch.randn_like(out)
        t = [cs.device_ms(lambda: ia.int_attn_bwd_dq(
                 q, k, v, g, lse, delta, qo, exps, **kw)),
             cs.device_ms(lambda: ia.int_attn_bwd_dkv(
                 q, k, v, g, lse, delta, qo, exps, **kw)),
             cs.device_ms(lambda: torch.autograd.grad(
                 out, (qs, ks, vs), gout, retain_graph=True))]
        print(f"  {label}: dq {t[0]:.4f} ms, dkv {t[1]:.4f} ms device; SDPA "
              f"backward (f32) {t[2]:.4f} ms", flush=True)


def train_step(torch) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as lt
    run = lt.build(lt.parse_args([
        "--arch", "qwen1.5-0.5b", "--batch", "8", "--seq", "256", "--steps",
        "5", "--lr", "1e-4", "--device", "cuda", "--quant", "int8"]))
    for _ in range(2):
        run.step()
    busy, attn, wall = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run.step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        rows = [(getattr(e, "self_device_time_total", 0), e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy.append(sum(us for us, _ in rows) / 1e3)
        attn.append(sum(us for us, key in rows
                        if "dq_kernel" in key or "dkv_kernel" in key) / 1e3)
    print(f"  qwen1.5-0.5b int8 training step: device busy ms "
          f"{[round(x, 2) for x in busy]}, attention backward ms "
          f"{[round(x, 2) for x in attn]}; profiled wall ms "
          f"{[round(x, 1) for x in wall]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attn_bwd_ab: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _lib
    _lib.build()
    print(f"{root.name or root}: {torch.cuda.get_device_name(0)}", flush=True)
    kernels(torch, root)
    train_step(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
