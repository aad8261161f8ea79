#!/usr/bin/env python3
"""The bit-width sweep's metric spread across seeds, and one proxy run
replayed on the card and on the CPU.

    python3 tools/sweep_seeds.py [--tasks cls,span,img] [--seeds 0,1,2,3,4]

Fine-tunes each task's reference-size model (bert-tiny / vit-tiny, batch
16, eval on 128, the reference's 120 steps) at fp32, int16, int12, int10
and int8 for each seed (``FtConfig.seed``: the init and the
stochastic-rounding stream of a CUDA generator), and prints every metric,
each preset's mean, standard error and range over the seeds, and its
drop against FP32 paired by seed (the mean of the per-seed drops and
their standard error).  Last, int8's drop averaged over the tasks, per
seed, with its mean and standard error (the paper's 3.1 points).  Then
vit-tiny under int8 and int16 with round-to-nearest gradients
from one CPU-drawn init on the CPU (plain versions) and on the card
(CUDA kernels): the step losses of both runs, the first step where they
part by more than 1e-5 relative, and both eval metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ("fp32", "int16", "int12", "int10", "int8")


def mean_se(xs) -> tuple:
    """(mean, standard error of the mean) of ``xs``."""
    return (statistics.mean(xs),
            statistics.stdev(xs) / len(xs) ** 0.5 if len(xs) > 1 else 0.0)


def spread(torch, dev, task: str, seeds) -> dict:
    """{preset: [metric per seed]}, each line printed."""
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.train import finetune as tf
    res = {p: [] for p in PRESETS}
    for seed in seeds:
        for p in PRESETS:
            t = time.perf_counter()
            m, losses = tf.finetune(
                task, QuantConfig.preset(p),
                tf.FtConfig(steps=120, batch=16, eval_n=128, seed=seed),
                device=dev, return_losses=True)
            res[p].append(m)
            print(f"  {task} seed {seed} {p}: metric {m:.2f}, final loss "
                  f"{losses[-1]:.4f} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
    for p, ms in res.items():
        m, se = mean_se(ms)
        d, dse = mean_se([f - x for f, x in zip(res["fp32"], ms)])
        print(f"  {task} {p}: mean {m:.2f} ± {se:.2f} (standard error) over "
              f"seeds {list(seeds)}, range {min(ms):.2f}-{max(ms):.2f}; drop "
              f"against fp32 paired by seed {d:+.2f} ± {dse:.2f}", flush=True)
    return res


def replay(torch, dev, preset: str) -> None:
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as topt
    q = dataclasses.replace(QuantConfig.preset(preset), stochastic_grad=False)
    ft = tf.FtConfig(steps=120, batch=16, eval_n=128)
    runs = {}
    for d in ("cpu", dev):
        cfg, params, sampler, loss_fn, lr = tf._task_setup(
            "img", torch.Generator().manual_seed(0), ft, None, "cpu")
        params = _to(params, d)
        ocfg = topt.OptimizerConfig(lr=lr, weight_decay=0.0)
        state, losses = topt.init(params), []
        for i in range(ft.steps):
            params, state, loss, _, _ = tf.train_step(
                params, state, tf.to_device(sampler(ft.batch, i), d), cfg, q,
                loss_fn, ocfg, None)
            losses.append(float(loss))
        runs[str(d)] = (tf.evaluate("img", params, cfg, q, sampler,
                                    ft.eval_n, d), losses)
    (m0, a), (m1, b) = runs["cpu"], runs[str(dev)]
    first = next((i for i, (x, y) in enumerate(zip(a, b))
                  if abs(x - y) > 1e-5 * abs(x)), None)
    print(f"  vit-tiny {preset} RN, CPU vs card: losses[::10] "
          f"{[round(x, 4) for x in a[::10]]} vs "
          f"{[round(x, 4) for x in b[::10]]}; "
          f"first step parting by > 1e-5 relative: {first} (step 0: "
          f"{a[0]:.7f} vs {b[0]:.7f}); metric {m0:.2f} vs {m1:.2f}",
          flush=True)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", default="cls,span,img")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_seeds: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib
    _lib.build()
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    res = {task: spread(torch, dev, task, seeds)
           for task in args.tasks.split(",")}
    avg = [statistics.mean(r["fp32"][i] - r["int8"][i] for r in res.values())
           for i in range(len(seeds))]
    m, se = mean_se(avg)
    print(f"  int8's drop against fp32 averaged over {', '.join(res)}, per "
          f"seed: {[round(a, 2) for a in avg]}; mean {m:+.2f} ± {se:.2f} "
          "(the paper: 3.1)", flush=True)
    for preset in ("int8", "int16"):
        replay(torch, dev, preset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
