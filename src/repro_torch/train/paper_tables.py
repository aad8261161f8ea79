"""One function per table and figure of the paper's bit-width experiment.

Counterpart of ``benchmarks/paper_tables.py`` (Tables 1-3, Figs. 4-5) at
the reference's sizes: bert-tiny / vit-tiny, batch 16, eval on 128 held-out
samples, the reference's steps.  Each function returns a list of rows
``(name, us_per_step, derived)``; the derived column carries the table's
metric (``metric_of`` reads it back).  ``fig5_loss_traj`` keeps the
reference's directional assertion.  ``fig1_throughput`` (the TPU roofline
and a numpy microbenchmark) is not ported.

    PYTHONPATH=src python -c "from repro_torch.train import paper_tables \\
        as pt; print(pt.table1_glue_sweep(steps=4, device='cpu'))"
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

from repro_torch.core.qconfig import QuantConfig
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
