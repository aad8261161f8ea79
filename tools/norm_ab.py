#!/usr/bin/env python3
"""Device time of the port's norm kernels, alone and in the steps.

    python3 tools/norm_ab.py [TREE ...]     # TREE: root of a checkout

Measures each checkout at TREE (default: this one) on the card, in turns,
each in a process of its own:

- the device time (torch.profiler, per call, through
  ``chip_smoke.device_ms``) and the device kernels per call of the
  forwards at ``chip_smoke.py`` phase 2's rows: ``int_layernorm_fwd`` at
  bert-base's cls and span steps (9: 4096 x 768, 9b: 4608 x 768) and
  ``int_rmsnorm_fwd`` at prefill (11: 256 x 1024), qwen1.5-0.5b's training
  step (11b: 2048 x 1024), qwen2-moe-a2.7b's width (11c: 2048 x 2048) and
  decode (11d: 4 x 1024), int16 mantissas (a12), FP32 and kept-int
  bodies;
- the same of the backwards: ``int_rmsnorm_bwd`` at qwen1.5-0.5b's
  training shape (2048 x 1024), qwen2-moe-a2.7b's (2048 x 2048) and
  smollm-135m's width (2048 x 576), and ``int_layernorm_bwd`` at
  bert-base's cls and span steps: int16 activation mantissas (a12) and
  int8 gradient mantissas (g8), plus each at the int16 preset's 16-bit
  gradients;
- phases 5, 6 and 8 of ``chip_smoke.py`` as ``tools/matmul_ab.py`` runs
  them: the int8 losses at full precision, each wrapper's launches in one
  step, and three profiled bert-base cls, qwen1.5-0.5b and qwen2-moe-a2.7b
  (6 layers) steps' device busy time, its norm-forward part (kernels
  named ``*ln_fwd*``, ``*rms_fwd*`` or ``*norm_fwd*``), its norm-backward
  part (``*ln_bwd*``, ``*rms_bwd*`` or ``*norm_bwd*``) and the profiled
  wall time;
- phase 6b's kept-int runs: bert-base cls (10 steps) and qwen1.5-0.5b
  (6 steps) under int8 + ``kept_ops="integer"``, their losses and
  launches in one step.

After the runs it prints, phase by phase, whether each run's losses equal
the first run's at every digit (else the largest relative difference) and
whether its launches per step do.  A change to the forwards that keeps
their outputs bit for bit keeps every loss; a change to the backwards
that sums dgamma or the row sums in another order moves dx and dgamma by
an ulp, and the losses drift apart after a few steps (the launches per
step stay equal).  To compare two commits on one card, unpack the other
into a git-ignored directory (``git archive``) and name both in turns:

    python3 tools/norm_ab.py build/parent . . build/parent
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import matmul_ab

NORM_FWD = re.compile(r"(ln|rms|norm)_fwd")
NORM_BWD = re.compile(r"(ln|rms|norm)_bwd")


def kernels_per_call(torch, fn, reps: int = 5) -> str:
    """The device kernels and copies of ``reps`` calls, per call, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return ", ".join(f"{e.key[:60]} x{e.count / reps:g}"
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)


def forwards(torch, cs) -> None:
    from repro_torch.kernels import int_norm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xe = torch.tensor(-9, dtype=torch.int32, device=dev)
    for label, R, D in (("9 ln bert-base cls", 4096, 768),
                        ("9b ln bert-base span", 4608, 768),
                        ("11 rms prefill", 256, 1024),
                        ("11b rms qwen1.5-0.5b", 2048, 1024),
                        ("11c rms qwen2-moe-a2.7b", 2048, 2048),
                        ("11d rms decode", 4, 1024)):
        xm = torch.randint(-2047, 2048, (R, D), generator=gen, device=dev,
                           dtype=torch.int16)
        gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
        for ir in (False, True):
            if label.split()[1] == "ln":
                def call():
                    return int_norm.int_layernorm_fwd(xm, xe, gamma, gamma,
                                                      integer_rsqrt=ir)
            else:
                def call():
                    return int_norm.int_rmsnorm_fwd(xm, xe, gamma,
                                                    integer_rsqrt=ir)
            body = "kept-int" if ir else "FP32"
            print(f"  {label} {R}x{D} a12 {body}: device "
                  f"{cs.device_ms(call):.4f} ms; per call: "
                  f"{kernels_per_call(torch, call)}", flush=True)
    torch.cuda.empty_cache()


def kept_phase6b(torch, ws: dict) -> dict:
    """Phase 6b's kept-int runs: their losses and launches in one step."""
    import dataclasses
    from repro_torch.configs import bert_base, registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    dev = torch.device("cuda")
    kept = dataclasses.replace(QuantConfig.int8(), kept_ops="integer")
    out, counts = {}, []
    for w in ws.values():
        w.launches = 0
    _, losses = tf.finetune(
        "cls", kept, tf.FtConfig(steps=10, batch=32, seq=128, eval_n=32,
                                 lr=1e-4),
        device=dev, arch=bert_base.CONFIG, return_losses=True,
        on_step=lambda i, loss: counts.append(
            {n: w.launches for n, w in ws.items()}))
    out["phase 6b bert"] = (losses, matmul_ab.counted(ws, counts))
    cfg = registry.get_config("qwen1.5-0.5b")
    gen = torch.Generator(device=dev).manual_seed(0)
    run = {"p": lm.lm_init(gen, cfg, device=dev)}
    run["o"] = opt_lib.init(run["p"])
    step = trainer.make_train_step(
        lm.lm_loss, cfg, kept, opt_lib.OptimizerConfig(lr=1e-4,
                                                       total_steps=6))
    data = SyntheticLM(DataConfig(batch_size=8, seq_len=256, vocab=cfg.vocab,
                                  seed=0))
    for w in ws.values():
        w.launches = 0
    losses, counts = [], []
    for _ in range(6):
        batch = tf.to_device(next(data), dev)
        run["p"], run["o"], m = step(run["p"], run["o"], batch, gen)
        losses.append(float(m["loss"]))
        counts.append({n: w.launches for n, w in ws.items()})
    out["phase 6b qwen"] = (losses, matmul_ab.counted(ws, counts))
    for name, (losses, launches) in out.items():
        print(f"  {name} int8 + kept-int: losses {losses}; launches in one "
              f"step {launches}", flush=True)
    del run, step
    torch.cuda.empty_cache()
    return out


def backwards(torch, cs) -> None:
    from repro_torch.kernels import int_norm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xe = torch.tensor(-9, dtype=torch.int32, device=dev)
    ge = torch.tensor(-27, dtype=torch.int32, device=dev)
    for label, R, D in (("rms qwen1.5-0.5b", 2048, 1024),
                        ("rms qwen2-moe-a2.7b", 2048, 2048),
                        ("rms smollm-135m", 2048, 576),
                        ("ln bert-base cls", 4096, 768),
                        ("ln bert-base span", 4608, 768)):
        xm = torch.randint(-2047, 2048, (R, D), generator=gen, device=dev,
                           dtype=torch.int16)
        gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
        for gt, glim in ((torch.int8, 127), (torch.int16, 32767)):
            gm = torch.randint(-glim, glim + 1, (R, D), generator=gen,
                               device=dev).to(gt)
            if label.startswith("rms"):
                _, rstd = int_norm.int_rmsnorm_fwd(xm, xe, gamma)

                def call():
                    return int_norm.int_rmsnorm_bwd(xm, gm, xe, ge, gamma,
                                                    rstd)
            else:
                _, mu, rstd = int_norm.int_layernorm_fwd(xm, xe, gamma,
                                                         gamma)

                def call():
                    return int_norm.int_layernorm_bwd(xm, gm, xe, ge, gamma,
                                                      mu, rstd)
            g = "g8" if gt == torch.int8 else "g16"
            print(f"  {label} {R}x{D} a12 {g}: device "
                  f"{cs.device_ms(call):.4f} ms; per call: "
                  f"{kernels_per_call(torch, call)}", flush=True)
    torch.cuda.empty_cache()


def measure(root: Path) -> dict:
    """One checkout's measurements (printed); returns its phases' losses
    and launches in one step."""
    import torch
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.build()
    print(f"{root.name or root}: {torch.cuda.get_device_name(0)}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    forwards(torch, cs)
    backwards(torch, cs)
    ws = matmul_ab.wrappers()
    parts = (("norm fwd", NORM_FWD), ("norm bwd", NORM_BWD))
    return {"phase 5": matmul_ab.bert_phase5(torch, ws, parts),
            "phase 6": matmul_ab.qwen_phase6(torch, ws, parts),
            **kept_phase6b(torch, ws),
            "phase 8": matmul_ab.moe_phase8(torch, ws, cs.MOE_TRAIN_LAYERS,
                                            parts)}


def compare(runs: list) -> None:
    """Each run's losses and launches against the first run's."""
    t0, first = runs[0]
    for tree, phases in runs:
        out = []
        for name, (losses, launches) in phases.items():
            ref, ref_launches = first[name]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            loss = ("losses equal" if losses == ref else
                    f"max rel loss difference {rel:.3g}")
            same = "equal" if launches == ref_launches else "DIFFER"
            out.append(f"{name} {loss}, launches per step {same}")
        print(f"  {tree} against {t0}: " + "; ".join(out), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("norm_ab: no CUDA device available", file=sys.stderr)
        return 2
    trees = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    if len(trees) == 1:
        print("NORM_AB " + json.dumps(measure(Path(trees[0]).resolve())))
        return 0
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, tree],
                              stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.splitlines()
        print("\n".join(l for l in lines if not l.startswith("NORM_AB ")),
              flush=True)
        if proc.returncode:
            print(f"norm_ab: {tree} exited {proc.returncode}",
                  file=sys.stderr)
            return proc.returncode
        runs.append((tree, json.loads(next(
            l for l in lines if l.startswith("NORM_AB "))[8:])))
    compare(runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
