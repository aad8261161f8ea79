#!/usr/bin/env python3
"""Device time of the port's attention forward, kernel and training step.

    python3 tools/attn_fwd_ab.py [TREE]     # TREE: root of a checkout

Measures the checkout at TREE (default: this one) on the card: the device
time (torch.profiler, per call, through ``chip_smoke.device_ms``) of
``int_attn_fwd`` at decode (4 rows, one per slot at positions 64..67, of
16 heads of 64 over a 256-deep cache), at the qwen1.5-0.5b training shape
(8 x 256, 16 heads of 64, causal; FP32 and kept-int bodies) and at
qwen2-moe-a2.7b's head dim 128, int8 preset planes from a seeded
generator, with SDPA's f32 forward on the dequantized values beside each;
then one qwen1.5-0.5b training step (full width, batch 8 x seq 256,
``lm_loss`` + ``make_train_step``) under int8 and int8 + kept ops
"integer": its device time and the attention forward's part of it over
three profiled steps after two warm-up steps, and the profiled wall time.
To compare two commits on one card, unpack the other into a git-ignored
directory (``git archive``) and run both in turns in one call:

    for t in build/parent . . build/parent; do
        python3 tools/attn_fwd_ab.py $t; done
"""
from __future__ import annotations

import dataclasses
import re
import sys
import time
from pathlib import Path

SHAPES = {  # (B, Sq, Sk, KV, G, hd, offsets, causal)
    "decode": (4, 1, 256, 16, 1, 64, [64, 65, 66, 67], True),
    "qwen1.5-0.5b train": (8, 256, 256, 16, 1, 64, [0] * 8, True),
    "qwen2-moe-a2.7b train (hd 128)": (8, 256, 256, 16, 1, 128, [0] * 8,
                                       True),
}


def kernels(torch, cs) -> None:
    from repro_torch.kernels import int_attention as ia
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    exps = torch.tensor([-9, -9, -8], dtype=torch.int32, device=dev)

    def planes(*shape):
        return torch.randint(-64, 64, (2,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)

    def deq(x, e):
        return (x[0].float() + 128 * x[1].float()) * 2.0 ** int(e)
    for label, (B, Sq, Sk, KV, G, hd, off, causal) in SHAPES.items():
        q, k, v = planes(B, Sq, KV, G, hd), planes(B, Sk, KV, hd), \
            planes(B, Sk, KV, hd)
        qo = torch.tensor(off, dtype=torch.int32, device=dev)
        kw = dict(p_bits=12, causal=causal, window=None, sc=1.0 / hd ** 0.5)
        qs = deq(q, exps[0]).reshape(B, Sq, KV * G, hd).transpose(1, 2)
        ks, vs = (deq(x, e).repeat_interleave(G, dim=2).transpose(1, 2)
                  for x, e in ((k, exps[1]), (v, exps[2])))
        qpos = qo[:, None] + torch.arange(Sq, device=dev)
        # is_causal where the mask is the plain causal one (its fastest form)
        plain = Sq == Sk and not bool(qo.any())
        mask = None if plain else \
            (torch.arange(Sk, device=dev) <= qpos[..., None])[:, None]
        t = [cs.device_ms(lambda: ia.int_attn_fwd(q, k, v, qo, exps, **kw)),
             cs.device_ms(lambda: ia.int_attn_fwd(q, k, v, qo, exps, **kw,
                                                  integer_exp=True)),
             cs.device_ms(lambda: F.scaled_dot_product_attention(
                 qs, ks, vs, attn_mask=mask, is_causal=plain))]
        print(f"  {label}: int_attn_fwd {t[0]:.4f} ms, kept-int body "
              f"{t[1]:.4f} ms device; SDPA forward (f32) {t[2]:.4f} ms",
              flush=True)


def train_step(torch, kept_int: bool) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    dev = torch.device("cuda")
    q = QuantConfig.int8()
    if kept_int:
        q = dataclasses.replace(q, kept_ops="integer")
    cfg = registry.get_config("qwen1.5-0.5b")
    gen = torch.Generator(device=dev).manual_seed(0)
    run = {"p": lm.lm_init(gen, cfg, device=dev)}
    run["o"] = opt_lib.init(run["p"])
    step = trainer.make_train_step(
        lm.lm_loss, cfg, q, opt_lib.OptimizerConfig(lr=1e-4, total_steps=5))
    data = SyntheticLM(DataConfig(batch_size=8, seq_len=256, vocab=cfg.vocab,
                                  seed=0))

    def one_step():
        batch = tf.to_device(next(data), dev)
        run["p"], run["o"], _ = step(run["p"], run["o"], batch, gen)
    for _ in range(2):
        one_step()
    busy, attn, wall = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        rows = [(getattr(e, "self_device_time_total", 0), e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy.append(sum(us for us, _ in rows) / 1e3)
        attn.append(sum(us for us, key in rows if re.search(
            r"::(int_attn_)?fwd(_direct)?_kernel<", key)) / 1e3)
    print(f"  qwen1.5-0.5b {'int8 + kept-int' if kept_int else 'int8'} "
          f"training step: device busy ms {[round(x, 2) for x in busy]}, "
          f"attention forward ms {[round(x, 3) for x in attn]}; profiled "
          f"wall ms {[round(x, 1) for x in wall]}", flush=True)
    del run
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attn_fwd_ab: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.kernels import _lib
    _lib.build()
    print(f"{root.name or root}: {torch.cuda.get_device_name(0)}", flush=True)
    kernels(torch, cs)
    train_step(torch, kept_int=False)
    train_step(torch, kept_int=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
