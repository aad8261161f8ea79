"""Training launcher: the reference's ``repro.launch.train`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --quant int8 --batch 8 --seq 256 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 10 --batch 2 --seq 32 --state-bits 8 --sentinel \\
        --ckpt-dir /tmp/ckpt --ckpt-every 2 --chaos-preempt-at 3 \\
        --chaos-bitflip-at 5 --chaos-corrupt-ckpt-at 7

Random weights from ``--seed`` (default 0) through one ``torch.Generator``
on the device, which then also draws the stochastic gradient rounding's
noise; batches from ``SyntheticLM``; AdamW at ``--lr`` with the reference's
defaults (constant schedule, clipping at 1): FP32 moments, or with
``--state-bits`` QTensor moments; ``--gather-bits`` lets the compute see
each parameter's DFX image.  Runs on the card unless ``--device cpu``.

The step loop is the reference's: ``fault.run_with_recovery`` over the
step wrapped by ``chaos.ChaosMonkey`` (``--chaos-*``), a checkpoint every
``--ckpt-every`` steps and at the end (``--ckpt-dir``; the newest one
that verifies is restored on start and after a failed step), and with
``--sentinel`` the sentinel step, which skips a step whose gradient is
non-finite and rebuilds the step function when a scope escalates.  The
checkpoint holds the parameters, the optimizer state, the data state and
the generator's state (``rng``), so a restored run replays the noise the
uninterrupted run drew.  The reference's distributed flags
(``--model-parallel``, ``--pods``, ``--grad-compress-bits``) are accepted
at their defaults and raise ``NotImplementedError`` when set.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.train import chaos as chaos_lib
from repro_torch.train import checkpoint, fault
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import sentinel as sentinel_lib
from repro_torch.train import trainer
from repro_torch.train.finetune import to_device

log = logging.getLogger("repro_torch.train")


def _steps_list(s: str) -> tuple:
    """CLI step lists: "3,7,11" -> (3, 7, 11)."""
    return tuple(int(x) for x in s.split(",") if x)


#: the reference's flags that are not ported: name -> (type, default)
_UNPORTED = {
    "model-parallel": (int, 1),
    "pods": (int, 1),
    "grad-compress-bits": (int, 0),
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
    ap.add_argument("--gather-bits", type=int, default=0,
                    help="0 = FP32 params into the compute; 8 = each "
                         "parameter's DFX image, straight-through gradient")
    ap.add_argument("--state-bits", type=int, default=0,
                    help="0 = FP32 Adam moments; 8 = QTensor moments with "
                         "stochastic-rounding EMA")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--sentinel", action="store_true",
                    help="numerics-sentinel step: health counters, skip on "
                         "non-finite gradients, per-scope bit escalation")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-preempt-at", type=_steps_list, default=(),
                    help="steps at which to inject a preemption (recover "
                         "by restore + replay)")
    ap.add_argument("--chaos-drop-psum-at", type=_steps_list, default=(),
                    help="steps at which a collective participant drops")
    ap.add_argument("--chaos-bitflip-at", type=_steps_list, default=(),
                    help="steps at which a state QTensor mantissa bit flips")
    ap.add_argument("--chaos-corrupt-exp-at", type=_steps_list, default=(),
                    help="steps at which a scale exponent goes stale")
    ap.add_argument("--chaos-nan-at", type=_steps_list, default=(),
                    help="steps at which gradients get a NaN injected "
                         "(needs --sentinel; one skipped step)")
    ap.add_argument("--chaos-straggle-at", type=_steps_list, default=(),
                    help="steps preceded by an injected straggler delay")
    ap.add_argument("--chaos-straggle-s", type=float, default=0.05,
                    help="seconds of each injected straggler delay")
    ap.add_argument("--chaos-corrupt-ckpt-at", type=_steps_list, default=(),
                    help="steps at which the newest checkpoint leaf gets "
                         "flipped bytes (restore must fall back)")
    for flag, (typ, default) in _UNPORTED.items():
        ap.add_argument(f"--{flag}", type=typ, default=default)
    args = ap.parse_args(argv)
    if args.sentinel and args.grad_compress_bits > 0:
        ap.error("--sentinel and --grad-compress-bits are mutually "
                 "exclusive (the sentinel step owns the optimizer update)")
    if args.chaos_nan_at and not args.sentinel:
        ap.error("--chaos-nan-at needs --sentinel (the NaN rides the "
                 "sentinel step's inject operand)")
    for flag, (_, default) in _UNPORTED.items():
        if getattr(args, flag.replace("-", "_")) != default:
            raise NotImplementedError(
                f"--{flag} belongs to the distributed slice, not ported yet")
    return args


@dataclasses.dataclass
class Run:
    """One training run: its configuration, live state and record.
    ``step_fn(params, opt_state, batch, key)`` (the sentinel step also
    takes ``inject_nan``)."""
    args: argparse.Namespace
    cfg: Any
    qcfg: Any
    opt_cfg: opt_lib.OptimizerConfig
    train_cfg: trainer.TrainConfig
    params: dict
    opt_state: opt_lib.OptState
    step_fn: Callable
    data: SyntheticLM
    gen: torch.Generator
    device: torch.device
    sentinel: Optional[sentinel_lib.Sentinel] = None
    losses: Dict[int, float] = dataclasses.field(default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list)

    def step(self, inject_nan: float = 0.0) -> dict:
        batch = to_device(next(self.data), self.device)
        if self.sentinel is None:
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.gen)
        else:
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.gen, inject_nan)
        return metrics

    def state(self) -> dict:
        """What a checkpoint holds."""
        return {"params": self.params, "opt": self.opt_state,
                "data": self.data.state(), "rng": self.gen.get_state()}

    def load(self, state: dict) -> None:
        self.params, self.opt_state = state["params"], state["opt"]
        self.data.restore(state["data"])
        self.gen.set_state(state["rng"])

    def event(self, ev: dict) -> None:
        self.events.append(ev)
        log.info("event: %s", ev)


def _step_fn(cfg, qcfg, opt_cfg, tcfg, sentinel: bool):
    make = (sentinel_lib.make_sentinel_step if sentinel
            else trainer.make_train_step)
    return make(lm.lm_loss, cfg, qcfg, opt_cfg, tcfg)


def build(args: argparse.Namespace,
          sentinel_cfg: Optional[sentinel_lib.SentinelConfig] = None) -> Run:
    """Config, params, optimizer state, step function and data of a run
    (``sentinel_cfg``: the sentinel's thresholds with ``--sentinel``, the
    reference's defaults when None)."""
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    qcfg = registry.get_quant(args.quant)
    device = lm.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.lm_init(gen, cfg, device=device)
    opt_cfg = opt_lib.OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                      state_bits=args.state_bits,
                                      seed=args.seed)
    tcfg = trainer.TrainConfig(microbatches=args.microbatches,
                               gather_bits=args.gather_bits)
    data = SyntheticLM(DataConfig(batch_size=args.batch, seq_len=args.seq,
                                  vocab=cfg.vocab, seed=args.seed))
    n = sum(p.numel() for p in opt_lib.tree_leaves(params))
    log.info("arch=%s params=%.2fM quant=%s device=%s gather_bits=%d "
             "state_bits=%d", cfg.name, n / 1e6, args.quant,
             torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu", args.gather_bits, args.state_bits)
    run = Run(args, cfg, qcfg, opt_cfg, tcfg, params,
              opt_lib.init(params, opt_cfg),
              _step_fn(cfg, qcfg, opt_cfg, tcfg, args.sentinel), data,
              gen, device)
    if args.sentinel:
        run.sentinel = sentinel_lib.Sentinel(
            sentinel_cfg or sentinel_lib.SentinelConfig(), qcfg,
            on_event=run.event)
    return run


def train(args: argparse.Namespace,
          on_step: Optional[Callable[[int, dict], None]] = None,
          run: Optional[Run] = None) -> Run:
    """Restore the newest usable checkpoint of ``--ckpt-dir`` into ``run``
    (``build(args)`` when None), train to step ``start + --steps`` through
    ``run_with_recovery`` and save the last step.  Returns the run: its
    final state, ``losses`` by step (a replayed step's last loss) and
    ``events``.  ``on_step(step, metrics)`` is called after each step run
    (replays too), the loss already on the host."""
    run = run or build(args)
    start = 0
    if args.ckpt_dir:
        got = checkpoint.restore_latest(args.ckpt_dir, run.state(),
                                        on_event=run.event)
        if got is not None:
            run.load(got[0])
            start = got[1]
            log.info("restored step %d", start)

    monkey = chaos_lib.ChaosMonkey(chaos_lib.ChaosConfig(
        seed=args.chaos_seed,
        preempt_at=args.chaos_preempt_at,
        bitflip_at=args.chaos_bitflip_at,
        corrupt_exp_at=args.chaos_corrupt_exp_at,
        drop_psum_at=args.chaos_drop_psum_at,
        nan_grad_at=args.chaos_nan_at,
        straggle_at=args.chaos_straggle_at,
        straggle_s=args.chaos_straggle_s,
        corrupt_ckpt_at=args.chaos_corrupt_ckpt_at,
        ckpt_dir=args.ckpt_dir))

    # the loop's state is (params, opt_state), as the reference's; the
    # data and generator states live in ``run`` and ride in checkpoints
    def one_step(state, step):
        run.params, run.opt_state = state
        metrics = run.step(monkey.nan_flag(step))
        run.losses[step] = float(metrics["loss"])     # waits for the step
        if run.sentinel is not None:
            policy = run.sentinel.observe(step, metrics)
            if policy is not None:
                run.qcfg = policy
                run.step_fn = _step_fn(run.cfg, policy, run.opt_cfg,
                                       run.train_cfg, True)
                log.info("sentinel: rebuilt the step with the escalated "
                         "policy (%d rules)", len(policy.rules))
        if step % args.log_every == 0:
            log.info("step %d loss=%.4f gnorm=%.3f", step, run.losses[step],
                     float(metrics["grad_norm"]))
        if on_step is not None:
            on_step(step, metrics)
        return run.params, run.opt_state

    def save_state(_, step):
        checkpoint.save(args.ckpt_dir, step, run.state())
        log.info("checkpointed step %d", step)

    def restore_fn():
        got = checkpoint.restore_latest(args.ckpt_dir, run.state(),
                                        on_event=run.event)
        if got is None:
            raise RuntimeError("no usable checkpoint to restore from")
        run.load(got[0])
        return (run.params, run.opt_state), got[1]

    t0 = time.time()
    fault.run_with_recovery(
        monkey.wrap(one_step), (run.params, run.opt_state),
        start_step=start, num_steps=args.steps,
        save_fn=save_state if args.ckpt_dir else None,
        restore_fn=restore_fn if args.ckpt_dir else None,
        save_every=args.ckpt_every, on_event=run.event)
    log.info("done: %d steps in %.1fs (%d events)", args.steps,
             time.time() - t0, len(run.events))
    if args.ckpt_dir:
        save_state(None, start + args.steps)
    return run


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None
         ) -> list:
    """Train ``--steps`` steps; returns the losses of steps ``start ..
    start + steps - 1``.  ``on_step(step, metrics)`` is called after each
    step, the loss already on the host."""
    logging.basicConfig(level=logging.INFO)
    run = train(parse_args(argv), on_step)
    return [run.losses[s] for s in sorted(run.losses)]


if __name__ == "__main__":
    main()
