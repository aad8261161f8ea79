"""One function per table and figure of the paper's bit-width experiment.

Counterpart of ``benchmarks/paper_tables.py`` (Tables 1-3, Figs. 4-5) at
the reference's sizes: bert-tiny / vit-tiny, batch 16, eval on 128 held-out
samples, the reference's steps.  Each function returns a list of rows
``(name, us_per_step, derived)``; the derived column carries the table's
metric (``metric_of`` reads it back).  ``fig5_loss_traj`` keeps the
reference's directional assertion.  ``fig1_throughput`` gives the H100's
peaks in place of the TPU's and times the port's integer matmul against
the float ones on the card.

    PYTHONPATH=src python -c "from repro_torch.train import paper_tables \\
        as pt; print(pt.table1_glue_sweep(steps=4, device='cpu'))"
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels.bfp_matmul import bfp_matmul
from repro_torch.models.lm import resolve_device
from repro_torch.train.finetune import FtConfig, finetune, sweep

PRESETS = ["fp32", "int16", "int12", "int10", "int8"]
Row = Tuple[str, float, str]


def _ft(steps: int) -> FtConfig:
    return FtConfig(steps=steps, batch=16, eval_n=128)


def metric_of(row: Row) -> float:
    """The number in a row's derived column (``"acc=97.66"`` -> 97.66)."""
    return float(row[2].split("=", 1)[1])


def _sweep_rows(table: str, task: str, key: str, steps: int,
                device) -> List[Row]:
    t0 = time.time()
    res = sweep(task, PRESETS, _ft(steps), device=device)
    us = (time.time() - t0) * 1e6 / (len(PRESETS) * steps)
    return [(f"{table}/{p}", us, f"{key}={res[p]:.2f}") for p in PRESETS]


def table1_glue_sweep(steps: int = 120, device="cuda") -> List[Row]:
    """Table 1: bit-width sweep on the GLUE-proxy classification task."""
    return _sweep_rows("table1_glue", "cls", "acc", steps, device)


def table2_squad_sweep(steps: int = 120, device="cuda") -> List[Row]:
    """Table 2 + Fig. 3: bit-width sweep on the SQuAD-proxy span task."""
    return _sweep_rows("table2_squad", "span", "em", steps, device)


def table3_vit_sweep(steps: int = 120, device="cuda") -> List[Row]:
    """Table 3: bit-width sweep on the CIFAR-proxy image task (ViT)."""
    return _sweep_rows("table3_vit", "img", "acc", steps, device)


def fig4_act_bits(steps: int = 120, device="cuda") -> List[Row]:
    """Fig. 4: 8-bit weights/grads, varying input-activation bit-width."""
    rows = []
    for ab in (8, 10, 12, 16):
        q = QuantConfig(weight_bits=8, act_bits=ab, grad_bits=8)
        t0 = time.time()
        metric, _ = finetune("span", q, _ft(steps), device=device)
        us = (time.time() - t0) * 1e6 / steps
        print(f"  fig4 w8a{ab:<2d} em={metric:6.2f}", flush=True)
        rows.append((f"fig4_act_bits/w8a{ab}", us, f"em={metric:.2f}"))
    return rows


def fig5_loss_traj(steps: int = 150, device="cuda",
                   csv_path: Optional[str] = None) -> List[Row]:
    """Fig. 5: loss trajectories — int16 tracks fp32; int8(w)/12(a) shifted
    but same trend.  Writes the trajectories to ``csv_path`` when given."""
    rows = []
    trajs = {}
    for p in ("fp32", "int16", "int8"):
        t0 = time.time()
        _, losses = finetune("span", QuantConfig.preset(p), _ft(steps),
                             device=device, return_losses=True)
        us = (time.time() - t0) * 1e6 / steps
        trajs[p] = losses
        rows.append((f"fig5_loss_traj/{p}", us,
                     f"final_loss={losses[-1]:.4f}"))
    if csv_path is not None:
        with open(csv_path, "w") as f:
            f.write("step," + ",".join(trajs) + "\n")
            for i in range(steps):
                f.write(f"{i}," + ",".join(f"{trajs[p][i]:.5f}"
                                           for p in trajs) + "\n")
    # directional check: int16 final loss within 15% of fp32
    assert abs(trajs["int16"][-1] - trajs["fp32"][-1]) < 0.15 * max(
        trajs["fp32"][-1], 0.1) + 0.05, trajs
    return rows


#: the H100 SXM's dense data-sheet peaks, operations a second
H100_PEAKS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def _event_us(fn, reps: int) -> float:
    """Median time of ``fn()`` on the card in microseconds, by CUDA
    events around each call after a warm-up."""
    for _ in range(3):
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
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def fig1_throughput(device="cuda", sizes=(512, 4096),
                    reps: int = 20) -> List[Row]:
    """Fig. 1 analogue: integer against float throughput.

    The paper measured a Xeon, the reference states the TPU v5e's
    roofline.  Here: the H100 SXM's dense data-sheet peaks (int8 1,979
    TOP/s, bf16 989 and f32 67 TFLOP/s), and on the card the port's
    ``bfp_matmul`` at 1 x 1 limbs (int8 planes, int32 sums, one exponent)
    against ``torch.matmul`` in f32 and bf16 on the same n x n x n
    operands, timed by CUDA events, with the card's name and power limit.
    On the CPU each product runs once through its plain version and no
    speed is claimed (us 0)."""
    rows = [
        ("fig1_model/h100_int8", 0.0, "peak=1979e12ops 2.0x_vs_bf16"),
        ("fig1_model/h100_bf16", 0.0, "peak=989e12ops 1.0x"),
        ("fig1_model/h100_f32", 0.0, "peak=67e12ops 0.068x_vs_bf16"),
    ]
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        rows.append(("fig1_card/card", 0.0, f"card={card_name()}"))
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in sizes:
        a8, b8 = (torch.randint(-127, 128, (1, n, n), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        exp = torch.zeros((), dtype=torch.int32, device=dev)
        af, bf = a8[0].to(torch.float32), b8[0].to(torch.float32)
        ah, bh = af.to(torch.bfloat16), bf.to(torch.bfloat16)
        calls = {"bfp_matmul_int8": lambda: bfp_matmul(a8, b8, exp),
                 "f32_matmul": lambda: torch.matmul(af, bf),
                 "bf16_matmul": lambda: torch.matmul(ah, bh)}
        for name, fn in calls.items():
            if not on_card:
                fn()
                rows.append((f"fig1_cpu/{name}", 0.0,
                             f"n={n} plain_version_not_timed"))
                continue
            us = _event_us(fn, reps)
            rows.append((f"fig1_card/{name}", us,
                         f"n={n} rate={2 * n ** 3 / us / 1e6:.1f}e12ops"))
    return rows
