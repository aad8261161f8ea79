"""Training launcher: the reference's ``repro.launch.train`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --quant int8 --batch 8 --seq 256 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 3 --batch 2 --seq 32

Random weights from ``--seed`` (default 0) through one ``torch.Generator``
on the device, which then also draws the stochastic gradient rounding's
noise; batches from ``SyntheticLM``; AdamW (FP32 moments and masters) at
``--lr`` with the reference's defaults (constant schedule, clipping at 1).
Runs on the card unless ``--device cpu``.  The reference's other flags
belong to parts of the system not ported yet (mesh and model parallelism,
pods and compressed gradients, the state plane, checkpoints, the sentinel,
chaos injection): each is accepted at its default and raises
``NotImplementedError`` when set.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer
from repro_torch.train.finetune import to_device

log = logging.getLogger("repro_torch.train")


def _steps_list(s: str) -> tuple:
    """CLI step lists: "3,7,11" -> (3, 7, 11)."""
    return tuple(int(x) for x in s.split(",") if x)


#: the reference's flags that are not ported: name -> (type, default, what
#: brings it)
_UNPORTED = {
    "model-parallel": (int, 1, "the distributed slice (mesh)"),
    "pods": (int, 1, "the distributed slice (pods)"),
    "gather-bits": (int, 0, "the state plane slice"),
    "state-bits": (int, 0, "the state plane slice"),
    "grad-compress-bits": (int, 0, "the distributed slice (grad compress)"),
    "ckpt-dir": (str, "", "the state plane slice (checkpoints)"),
    "ckpt-every": (int, 50, "the state plane slice (checkpoints)"),
    "sentinel": (bool, False, "the robustness slice (sentinel)"),
    "chaos-seed": (int, 0, "the robustness slice (chaos)"),
    "chaos-preempt-at": (_steps_list, (), "the robustness slice (fault)"),
    "chaos-drop-psum-at": (_steps_list, (), "the robustness slice (chaos)"),
    "chaos-bitflip-at": (_steps_list, (), "the robustness slice (chaos)"),
    "chaos-corrupt-exp-at": (_steps_list, (), "the robustness slice (chaos)"),
    "chaos-nan-at": (_steps_list, (), "the robustness slice (chaos)"),
    "chaos-straggle-at": (_steps_list, (), "the robustness slice (chaos)"),
    "chaos-corrupt-ckpt-at": (_steps_list, (),
                              "the robustness slice (chaos)"),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--quant", default="int8",
                    help="uniform QuantConfig preset or QuantPolicy preset")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    for flag, (typ, default, _) in _UNPORTED.items():
        if typ is bool:
            ap.add_argument(f"--{flag}", action="store_true")
        else:
            ap.add_argument(f"--{flag}", type=typ, default=default)
    args = ap.parse_args(argv)
    for flag, (_, default, where) in _UNPORTED.items():
        if getattr(args, flag.replace("-", "_")) != default:
            raise NotImplementedError(
                f"--{flag} belongs to {where}, not ported yet")
    return args


@dataclasses.dataclass
class Run:
    """One training run's state: ``step()`` advances it by one step."""
    args: argparse.Namespace
    cfg: Any
    params: dict
    opt_state: opt_lib.OptState
    step_fn: Callable
    data: SyntheticLM
    gen: torch.Generator
    device: torch.device

    def step(self) -> dict:
        batch = to_device(next(self.data), self.device)
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch, self.gen)
        return metrics


def build(args: argparse.Namespace) -> Run:
    """Config, params, optimizer state, step function and data of a run."""
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    qcfg = registry.get_quant(args.quant)
    device = lm.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.lm_init(gen, cfg, device=device)
    opt_cfg = opt_lib.OptimizerConfig(lr=args.lr, total_steps=args.steps)
    step_fn = trainer.make_train_step(
        lm.lm_loss, cfg, qcfg, opt_cfg,
        trainer.TrainConfig(microbatches=args.microbatches))
    data = SyntheticLM(DataConfig(batch_size=args.batch, seq_len=args.seq,
                                  vocab=cfg.vocab, seed=args.seed))
    n = sum(p.numel() for p in opt_lib.tree_leaves(params))
    log.info("arch=%s params=%.2fM quant=%s device=%s", cfg.name, n / 1e6,
             args.quant, torch.cuda.get_device_name(device)
             if device.type == "cuda" else "cpu")
    return Run(args, cfg, params, opt_lib.init(params), step_fn, data, gen,
               device)


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None
         ) -> list:
    """Train ``--steps`` steps; returns the losses.  ``on_step(i,
    metrics)`` is called after each step, the loss already on the host."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    run = build(args)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        metrics = run.step()
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0:
            log.info("step %d loss=%.4f gnorm=%.3f", i, losses[-1],
                     float(metrics["grad_norm"]))
        if on_step is not None:
            on_step(i, metrics)
    log.info("done: %d steps in %.1fs", args.steps, time.time() - t0)
    return losses


if __name__ == "__main__":
    main()
