#!/usr/bin/env python3
"""Device time of the port's block-floating-point matmul, kernel and steps.

    python3 tools/matmul_ab.py [TREE]     # TREE: root of a checkout

Measures the checkout at TREE (default: this one) on the card:

- the device time (torch.profiler, per call, through
  ``chip_smoke.device_ms``) of the six matmul wrappers at the main paths'
  shapes: ``chip_smoke.py`` phase 2's rows 3, 3b, 3c (NN), 4 (NT), 5 (TN),
  6, 6b, 7 and 8 (batched), and qwen1.5-0.5b's training shapes NN / NT /
  TN (batch 8 x seq 256, d_model 1024, d_ff 2816), int8 limb planes from
  a seeded generator;
- the int8 losses, at full precision, of phase 5 (bert-base cls under the
  paper's scope, 10 steps of 32 x 128 through ``finetune``), phase 6
  (qwen1.5-0.5b, 6 steps of 8 x 256 through ``launch.train``) and phase 8
  (qwen2-moe-a2.7b at 6 layers, 6 steps of 8 x 256 through ``lm_loss`` +
  ``make_train_step``), each wrapper's launches in one step of each, and
  the qwen and MoE steps' device busy time, its matmul part (kernels named
  ``bfp_matmul_kernel`` or ``bfp_mma_kernel``) and the profiled wall time,
  over three profiled steps after the run.

The matmul kernels are exact, so two checkouts that differ only in them
print the same losses at every digit and the same launches.  To compare
two commits on one card, unpack the other into a git-ignored directory
(``git archive``) and run both in turns in one call:

    for t in build/parent . . build/parent; do
        python3 tools/matmul_ab.py $t; done
"""
from __future__ import annotations

import dataclasses
import re
import sys
import time
from pathlib import Path

MATMUL = re.compile(r"bfp_(matmul|mma)_kernel")


def wrappers() -> dict:
    """Every kernel wrapper of the checkout (a function with a launch
    count), by name."""
    from repro_torch.kernels import bfp_matmul, dfx_quant, int_attention
    from repro_torch.kernels import int_norm
    return {n: f for m in (bfp_matmul, dfx_quant, int_attention, int_norm)
            for n, f in vars(m).items()
            if callable(f) and hasattr(f, "launches")}


def kernels(torch, cs) -> None:
    from repro_torch.kernels import bfp_matmul as bm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    e = torch.tensor(-19, dtype=torch.int32, device=dev)
    E = 60
    ee = torch.arange(E, dtype=torch.int32, device=dev) - 40

    def pl(L, *shape):
        return torch.randint(-64, 64, (L,) + shape, generator=gen,
                             device=dev, dtype=torch.int8)
    x3, w3 = pl(2, 256, 1024), pl(1, 1024, 2816)
    hx, hw = pl(2, 4, 1024), pl(1, 152064, 1024).transpose(1, 2)
    xb, wb = pl(2, 4096, 768), pl(1, 768, 3072)
    g4, w4 = pl(1, 4096, 3072), pl(1, 768, 3072)
    xq, wq = pl(2, 2048, 1024), pl(1, 1024, 2816)
    gq, wqt = pl(1, 2048, 2816), pl(1, 1024, 2816)
    xm, wm = pl(2, E, 256, 2048), pl(1, E, 2048, 1408)
    xd, gm = pl(2, E, 16, 2048), pl(1, E, 256, 1408)
    rows = [
        ("3 NN qwen prefill MLP 256x1024x2816 2x1",
         lambda: bm.bfp_matmul(x3, w3, e)),
        ("3b NN decode tied head 4x1024x152064 (W K-major) 2x1",
         lambda: bm.bfp_matmul(hx, hw, e)),
        ("3c NN bert-base w1 4096x768x3072 2x1",
         lambda: bm.bfp_matmul(xb, wb, e)),
        ("4 NT bert-base w1 dX 1x1", lambda: bm.bfp_matmul_nt(g4, w4, e)),
        ("5 TN bert-base w1 dW 2x1", lambda: bm.bfp_matmul_tn(xb, g4, e)),
        ("qwen train NN 2048x1024x2816 2x1", lambda: bm.bfp_matmul(xq, wq, e)),
        ("qwen train NT 2048x2816 . (1024x2816)^T 1x1",
         lambda: bm.bfp_matmul_nt(gq, wqt, e)),
        ("qwen train TN (2048x1024)^T . 2048x2816 2x1",
         lambda: bm.bfp_matmul_tn(xq, gq, e)),
        ("6 batched NN 60x256x2048x1408 2x1",
         lambda: bm.bfp_matmul_batched(xm, wm, ee)),
        ("6b batched NN MoE decode 60x16x2048x1408 2x1",
         lambda: bm.bfp_matmul_batched(xd, wm, ee)),
        ("7 batched NT 60x256x1408 . (60x2048x1408)^T 1x1",
         lambda: bm.bfp_matmul_batched_nt(gm, wm, ee)),
        ("8 batched TN (60x256x2048)^T . 60x256x1408 2x1",
         lambda: bm.bfp_matmul_batched_tn(xm, gm, ee)),
    ]
    for label, call in rows:
        print(f"  {label}: device {cs.device_ms(call):.4f} ms", flush=True)
    del rows
    torch.cuda.empty_cache()


def profiled(torch, one_step, what: str,
             parts=(("matmul", MATMUL),)) -> None:
    """Three profiled steps: device busy ms, the part of it in kernels whose
    name matches each of ``parts`` ((label, pattern) pairs), wall ms."""
    from torch.profiler import ProfilerActivity, profile
    busy, wall = [], []
    split = {label: [] for label, _ in parts}
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
        for label, pattern in parts:
            split[label].append(sum(us for us, key in rows
                                    if pattern.search(key)) / 1e3)
    print(f"  {what}: device busy ms {[round(v, 2) for v in busy]}, "
          + ", ".join(f"{label} ms {[round(v, 3) for v in ms]}"
                      for label, ms in split.items())
          + f"; profiled wall ms {[round(v, 1) for v in wall]}", flush=True)


def counted(ws: dict, steps: list) -> list:
    """Each wrapper's launches in the last of the steps whose cumulative
    counts ``steps`` holds (wrappers that launched)."""
    last = {n: steps[-1][n] - steps[-2][n] for n in ws}
    return sorted((n, c) for n, c in last.items() if c)


def bert_phase5(torch, ws: dict, parts=None) -> tuple:
    """Phase 5's cls run; with ``parts``, also three profiled steps (as
    ``chip_smoke.py`` phase 5 profiles one).  Returns the losses and the
    launches in one step, as the phases below do."""
    from repro_torch.configs import bert_base
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as topt
    dev = torch.device("cuda")
    ft = tf.FtConfig(steps=10, batch=32, seq=128, eval_n=32, lr=1e-4)
    counts = []
    for w in ws.values():
        w.launches = 0
    _, losses = tf.finetune(
        "cls", tf.paper_scope(), ft, device=dev, arch=bert_base.CONFIG,
        return_losses=True,
        on_step=lambda i, loss: counts.append(
            {n: w.launches for n, w in ws.items()}))
    print(f"  phase 5 bert-base cls, paper scope: losses {losses}; "
          f"launches in one step {counted(ws, counts)}", flush=True)
    if parts:
        gen = torch.Generator(device=dev).manual_seed(1)
        cfg, params, sampler, loss_fn, lr = tf._task_setup(
            "cls", gen, ft, bert_base.CONFIG, dev)
        ocfg = topt.OptimizerConfig(lr=lr, weight_decay=0.0)
        state = {"p": params, "o": topt.init(params)}
        batch = tf.to_device(sampler(ft.batch, 0), dev)

        def one_step():
            state["p"], state["o"], _, _, _ = tf.train_step(
                state["p"], state["o"], batch, cfg, tf.paper_scope(),
                loss_fn, ocfg, gen)
        one_step()
        profiled(torch, one_step, "bert-base cls training step", parts)
        del state
    torch.cuda.empty_cache()
    return losses, counted(ws, counts)


def qwen_phase6(torch, ws: dict, parts=(("matmul", MATMUL),)) -> tuple:
    from repro_torch.launch import train as lt
    argv = ["--arch", "qwen1.5-0.5b", "--batch", "8", "--seq", "256",
            "--steps", "6", "--lr", "0.0001", "--log-every", "6",
            "--device", "cuda", "--quant", "int8"]
    counts = []
    for w in ws.values():
        w.launches = 0
    losses = lt.main(argv, on_step=lambda i, m: counts.append(
        {n: w.launches for n, w in ws.items()}))
    print(f"  phase 6 qwen1.5-0.5b int8: losses {losses}; launches in one "
          f"step {counted(ws, counts)}", flush=True)
    run = lt.build(lt.parse_args(argv))
    run.step()
    profiled(torch, run.step, "qwen1.5-0.5b int8 training step", parts)
    del run
    torch.cuda.empty_cache()
    return losses, counted(ws, counts)


def moe_phase8(torch, ws: dict, layers: int,
               parts=(("matmul", MATMUL),)) -> tuple:
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    from repro_torch.train.finetune import to_device
    dev = torch.device("cuda")
    cfg = dataclasses.replace(registry.get_config("qwen2-moe-a2.7b"),
                              n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    run = {"p": lm.lm_init(gen, cfg, device=dev)}
    run["o"] = opt_lib.init(run["p"])
    step = trainer.make_train_step(
        lm.lm_loss, cfg, registry.get_quant("int8"),
        opt_lib.OptimizerConfig(lr=1e-4, total_steps=6))
    data = SyntheticLM(DataConfig(batch_size=8, seq_len=256, vocab=cfg.vocab,
                                  seed=0))

    def one_step():
        batch = to_device(next(data), dev)
        run["p"], run["o"], m = step(run["p"], run["o"], batch, gen)
        return float(m["loss"])
    for w in ws.values():
        w.launches = 0
    losses, counts = [], []
    for _ in range(6):
        losses.append(one_step())
        counts.append({n: w.launches for n, w in ws.items()})
    print(f"  phase 8 qwen2-moe-a2.7b ({layers} layers) int8: losses "
          f"{losses}; launches in one step {counted(ws, counts)}", flush=True)
    profiled(torch, one_step, f"qwen2-moe-a2.7b ({layers} layers) int8 "
             "training step", parts)
    del run, step
    torch.cuda.empty_cache()
    return losses, counted(ws, counts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("matmul_ab: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.build()
    print(f"{root.name or root}: {torch.cuda.get_device_name(0)}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kernels(torch, cs)
    ws = wrappers()
    bert_phase5(torch, ws)
    qwen_phase6(torch, ws)
    moe_phase8(torch, ws, cs.MOE_TRAIN_LAYERS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
