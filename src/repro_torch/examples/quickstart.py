"""Quickstart: fine-tune a small LM with integer forward and backward
propagation and compare it against the FP32 baseline — the paper's recipe
in a few lines.

Counterpart of ``examples/quickstart.py``: reduced qwen1.5-0.5b on the
synthetic corpus under the fp32, int16 and int8 presets, from one seeded
init.  The stochastic-rounding noise comes from one ``torch.Generator``
on the device, seeded with the step (the reference folds the step into
its key).

    python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        --steps 4 --batch 2 --seq 16 --device cpu
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.core.qconfig import QuantConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.train import optimizer as opt_lib, trainer
from repro_torch.train.finetune import to_device


def finetune(preset: str, steps: int = 30, batch: int = 8, seq: int = 64,
             device="cuda") -> list:
    """The losses of ``steps`` AdamW steps under ``preset``."""
    device = lm.resolve_device(device)
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    qcfg = QuantConfig.preset(preset)
    params = lm.lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    opt_state = opt_lib.init(params)
    opt_cfg = opt_lib.OptimizerConfig(lr=2e-3, weight_decay=0.0)
    step = trainer.make_train_step(lm.lm_loss, cfg, qcfg, opt_cfg)
    data = SyntheticLM(DataConfig(batch_size=batch, seq_len=seq,
                                  vocab=cfg.vocab))
    losses = []
    for i in range(steps):
        key = torch.Generator(device=device).manual_seed(i)
        params, opt_state, m = step(params, opt_state,
                                    to_device(next(data), device), key)
        losses.append(float(m["loss"]))
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {}
    for preset in ("fp32", "int16", "int8"):
        losses = finetune(preset, args.steps, args.batch, args.seq,
                          args.device)
        out[preset] = losses
        print(f"{preset:6s} first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"trajectory={['%.2f' % v for v in losses[::6]]}")
    print("\nint16 should track fp32 closely; int8 (w8/a12/g8) slightly "
          "shifted but converging — the paper's Figure 5 at smoke scale.")
    return out


if __name__ == "__main__":
    main()
