#!/usr/bin/env python3
"""Device time of the port's norm backwards, kernel and steps.

    python3 tools/norm_ab.py [TREE ...]     # TREE: root of a checkout

Measures each checkout at TREE (default: this one) on the card, in turns,
each in a process of its own:

- the device time (torch.profiler, per call, through
  ``chip_smoke.device_ms``) and the device kernels per call of
  ``int_rmsnorm_bwd`` at qwen1.5-0.5b's training shape (2048 x 1024),
  qwen2-moe-a2.7b's (2048 x 2048) and smollm-135m's width (2048 x 576),
  and of ``int_layernorm_bwd`` at bert-base's cls and span steps (4096 x
  768, 4608 x 768): int16 activation mantissas (a12) and int8 gradient
  mantissas (g8), plus each at the int16 preset's 16-bit gradients;
- phases 5, 6 and 8 of ``chip_smoke.py`` as ``tools/matmul_ab.py`` runs
  them: the int8 losses at full precision, each wrapper's launches in one
  step, and three profiled bert-base cls, qwen1.5-0.5b and qwen2-moe-a2.7b
  (6 layers) steps' device busy time, its norm-backward part (kernels
  named ``*ln_bwd*``, ``*rms_bwd*`` or ``*norm_bwd*``, the partials'
  reduce included) and the profiled wall time.

After the runs it prints each run's largest relative loss difference from
the first run's, phase by phase, and whether its launches per step equal
the first run's.  dgamma is an f32 sum over rows and the row sums feed dx,
so two checkouts that sum in another order print losses that drift apart
after a few steps; the launches per step stay equal.  To compare two
commits on one card, unpack the other into a git-ignored directory (``git
archive``) and name both in turns:

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


def kernels(torch, cs) -> None:
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
    kernels(torch, cs)
    ws = matmul_ab.wrappers()
    part = ("norm bwd", NORM_BWD)
    return {"phase 5": matmul_ab.bert_phase5(torch, ws, part),
            "phase 6": matmul_ab.qwen_phase6(torch, ws, part),
            "phase 8": matmul_ab.moe_phase8(torch, ws, cs.MOE_TRAIN_LAYERS,
                                            part)}


def compare(runs: list) -> None:
    """Each run's losses and launches against the first run's."""
    t0, first = runs[0]
    for tree, phases in runs:
        out = []
        for name, (losses, launches) in phases.items():
            ref, ref_launches = first[name]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            same = "equal" if launches == ref_launches else "DIFFER"
            out.append(f"{name} max rel loss difference {rel:.3g}, launches "
                       f"per step {same}")
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
