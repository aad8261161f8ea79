"""Training launcher: the reference's ``repro.launch.train`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --quant int8 --batch 8 --seq 256 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 10 --batch 2 --seq 32 --state-bits 8 --sentinel \\
        --ckpt-dir /tmp/ckpt --ckpt-every 2 --chaos-preempt-at 3 \\
        --chaos-bitflip-at 5 --chaos-corrupt-ckpt-at 7

Random weights from ``--seed`` (default 0) through one ``torch.Generator``
on the device, which then also draws the stochastic gradient rounding's
noise; batches from ``SyntheticLM`` (``make_batch``: an enc-dec arch,
whose model is ``models/encdec.py``, also gets ``--seq`` frame embeddings
a row, a VLM its patch embeddings); AdamW at ``--lr`` with the reference's
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
uninterrupted run drew.

Distributed: under ``torchrun`` (its ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``) every process joins one world, gloo for ``--device cpu``
and NCCL for ``--device cuda`` unless ``--dist-backend`` names one, on
card ``LOCAL_RANK`` modulo the cards there are:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --device cpu --pods 2 --grad-compress-bits 8 --steps 3

The mesh is ``launch.mesh.make_host_mesh(--model-parallel, --pods)``.
Every rank draws the same global batch and initial weights; the step is
``trainer.jit_train_step`` (each rank keeps its blocks of the parameters
and moments; FSDP for the archs of ``registry.FSDP_ARCHS``), the sentinel
step over the mesh, or with ``--grad-compress-bits`` (``--pods > 1``) the
compressed cross-pod step.  With ``--model-parallel M`` every arch's
training stack (dense, MoE, VLM, the SSM and hybrid Mamba2 stacks,
whisper's encoder-decoder) splits every product over the M ranks of a
model group (``sharding.tensor_parallel``; a model axis that does not
divide the heads, the SSD heads, the inner widths or the padded
vocabulary raises):

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch mamba2-370m --reduced --device cpu --model-parallel 2 \
        --steps 3

Rank 0 writes the checkpoints (full arrays, the reference's format); a
resumed run sets each rank's generator from its own row of the saved
states.  Without that environment it is the one-device run.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.configs import registry
from repro_torch.core import grad_compress
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import encdec, lm
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
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1,
                    help="pod axis size (>1 enables the compressed "
                         "cross-pod step)")
    ap.add_argument("--dist-backend", default="",
                    help="torch.distributed backend under torchrun (default "
                         "gloo for --device cpu, nccl for cuda)")
    ap.add_argument("--gather-bits", type=int, default=0,
                    help="0 = FP32 params into the compute; 8 = each "
                         "parameter's DFX image (under a mesh the int8 "
                         "QTensor all-gather), straight-through gradient")
    ap.add_argument("--state-bits", type=int, default=0,
                    help="0 = FP32 Adam moments; 8 = QTensor moments with "
                         "stochastic-rounding EMA")
    ap.add_argument("--grad-compress-bits", type=int, default=0,
                    help="0 = off; 8 = int8 DFX cross-pod gradient "
                         "all-reduce with error feedback (needs --pods > 1)")
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
    args = ap.parse_args(argv)
    compressed = args.grad_compress_bits > 0
    if compressed and args.pods < 2:
        ap.error("--grad-compress-bits needs --pods > 1 (a pod mesh axis)")
    if args.sentinel and compressed:
        ap.error("--sentinel and --grad-compress-bits are mutually "
                 "exclusive (the sentinel step owns the optimizer update)")
    if args.chaos_nan_at and not args.sentinel:
        ap.error("--chaos-nan-at needs --sentinel (the NaN rides the "
                 "sentinel step's inject operand)")
    return args


@dataclasses.dataclass
class Run:
    """One training run: its configuration, live state and record.
    ``step_fn(params, opt_state, batch, key)`` (the sentinel step also
    takes ``inject_nan``; the compressed step ``residuals`` after the
    optimizer state).  Under a mesh ``params`` / ``opt_state`` are the
    rank's blocks (``pspecs``; None: replicated) and ``gen`` the rank's
    generator."""
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
    mesh: Optional[sharding.Mesh] = None
    pspecs: Any = None
    residuals: Any = None
    losses: Dict[int, float] = dataclasses.field(default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list)

    def step(self, inject_nan: float = 0.0) -> dict:
        batch = to_device(make_batch(self.cfg, next(self.data)), self.device)
        if self.residuals is not None:
            self.params, self.opt_state, self.residuals, metrics = \
                self.step_fn(self.params, self.opt_state, self.residuals,
                             batch, self.gen)
        elif self.sentinel is None:
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.gen)
        else:
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.gen, inject_nan)
        return metrics

    @property
    def layout(self) -> Optional[tuple]:
        """The checkpoint's ``layout`` under a mesh (None: one device)."""
        if self.mesh is None:
            return None
        ps = self.pspecs
        return self.mesh, {
            "params": ps, "opt": None if ps is None else opt_lib.OptState(
                step=(), m=ps, v=ps),
            "data": None, "rng": None, "residuals": None}

    def state(self) -> dict:
        """What a checkpoint holds (under a mesh every rank's generator
        state, a collective)."""
        rng = self.gen.get_state()
        if self.mesh is not None:
            rng = sharding.all_gather(rng, self.mesh.axis_names, self.mesh,
                                      tag="checkpoint")
        out = {"params": self.params, "opt": self.opt_state,
               "data": self.data.state(), "rng": rng}
        if self.residuals is not None:
            # the reference's: the residuals of rank 0 ride in the file
            out["residuals"] = self.residuals
        return out

    def load(self, state: dict) -> None:
        self.params, self.opt_state = state["params"], state["opt"]
        self.data.restore(state["data"])
        rng = state["rng"] if self.mesh is None else state["rng"][
            self.mesh.rank]
        # a fresh tensor at storage offset 0: a row of the gathered states
        # is a view at an offset, on which ``set_state`` crashed the CPU
        # process (rank 1's row)
        self.gen.set_state(rng.clone())
        if self.residuals is not None:
            self.residuals = state["residuals"]

    def event(self, ev: dict) -> None:
        self.events.append(ev)
        log.info("event: %s", ev)


def make_batch(cfg, raw: dict) -> dict:
    """The model's batch from the data's: an enc-dec arch's gets frame
    embeddings (B, seq, D), unit normals from a generator seeded 0 anew
    for every batch, and a VLM's zero patch embeddings (B, vlm_prefix, D),
    as the reference's launcher gives them (the audio frontend and the
    vision tower are stubs)."""
    if cfg.enc_dec:
        B, S = raw["tokens"].shape
        frames = np.random.default_rng(0).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        return {"frames": frames, **raw}
    if cfg.vlm_prefix:
        B = raw["tokens"].shape[0]
        return {"patch_embeds": np.zeros((B, cfg.vlm_prefix, cfg.d_model),
                                         np.float32), **raw}
    return raw


def _model(cfg) -> tuple:
    """(init, loss) of the arch's model: ``models/encdec.py`` for an
    enc-dec arch, ``models/lm.py`` for the others."""
    if cfg.enc_dec:
        return encdec.encdec_init, encdec.encdec_loss
    return lm.lm_init, lm.lm_loss


def _step_fn(cfg, qcfg, opt_cfg, tcfg, sentinel: bool, mesh=None,
             pspecs=None):
    loss_fn = _model(cfg)[1]
    if sentinel:
        return sentinel_lib.make_sentinel_step(loss_fn, cfg, qcfg, opt_cfg,
                                               tcfg, mesh=mesh,
                                               param_specs=pspecs)
    if tcfg.grad_compress_bits:
        return trainer.make_compressed_train_step(loss_fn, cfg, qcfg,
                                                  opt_cfg, mesh, tcfg)
    step = trainer.make_train_step(loss_fn, cfg, qcfg, opt_cfg, tcfg)
    return step if mesh is None else trainer.jit_train_step(step, mesh,
                                                            pspecs)


def init_world(args: argparse.Namespace) -> Optional[sharding.Mesh]:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``) and make the mesh; None without that environment (one
    device).  The backend is ``--dist-backend``, else gloo for the CPU and
    NCCL for the card; a CUDA rank takes card ``LOCAL_RANK`` modulo the
    cards there are."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return make_host_mesh(args.model_parallel, args.pods)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        args.device = str(device)
    if not dist.is_initialized():
        dist.init_process_group(
            args.dist_backend or ("nccl" if device.type == "cuda"
                                  else "gloo"))
    mesh = make_host_mesh(args.model_parallel, args.pods)
    sharding.set_mesh(mesh)
    return mesh


def build(args: argparse.Namespace,
          sentinel_cfg: Optional[sentinel_lib.SentinelConfig] = None,
          mesh: Optional[sharding.Mesh] = None) -> Run:
    """Config, params, optimizer state, step function and data of a run
    (``sentinel_cfg``: the sentinel's thresholds with ``--sentinel``, the
    reference's defaults when None; ``mesh``: ``init_world``'s)."""
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    qcfg = registry.get_quant(args.quant)
    device = lm.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    opt_cfg = opt_lib.OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                      state_bits=args.state_bits,
                                      seed=args.seed)
    tcfg = trainer.TrainConfig(microbatches=args.microbatches,
                               gather_bits=args.gather_bits,
                               grad_compress_bits=args.grad_compress_bits)
    init = _model(cfg)[0]
    pspecs = residuals = None
    if mesh is None or tcfg.grad_compress_bits:
        params = init(gen, cfg, device=device)
        opt_state = opt_lib.init(params, opt_cfg)
        if tcfg.grad_compress_bits:
            residuals = grad_compress.init_residuals(params)
    else:
        params, opt_state, pspecs = trainer.init_train_state(
            lambda g: init(g, cfg, device=device), gen, mesh,
            fsdp=registry.use_fsdp(args.arch), opt_cfg=opt_cfg)
    if mesh is not None:
        axes = sharding.batch_axes(mesh)
        if mesh.index(axes):
            # every batch-axis rank its own stochastic rounding; the ranks
            # of one model group (the same rows) draw the same noise
            seq = np.random.SeedSequence([args.seed, mesh.index(axes)])
            gen.manual_seed(int(seq.generate_state(1, np.uint64)[0] >> 1))
    data = SyntheticLM(DataConfig(batch_size=args.batch, seq_len=args.seq,
                                  vocab=cfg.vocab, seed=args.seed))
    n = sum(p.numel() for p in opt_lib.tree_leaves(params))
    log.info("arch=%s params=%.2fM (this rank) quant=%s device=%s mesh=%s "
             "gather_bits=%d state_bits=%d grad_compress_bits=%d", cfg.name,
             n / 1e6, args.quant,
             torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu", None if mesh is None else mesh.shape,
             args.gather_bits, args.state_bits, args.grad_compress_bits)
    run = Run(args, cfg, qcfg, opt_cfg, tcfg, params, opt_state,
              _step_fn(cfg, qcfg, opt_cfg, tcfg, args.sentinel, mesh,
                       pspecs), data, gen, device, mesh=mesh, pspecs=pspecs,
              residuals=residuals)
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
    run = run or build(args, mesh=init_world(args))
    start = 0
    if args.ckpt_dir:
        got = checkpoint.restore_latest(args.ckpt_dir, run.state(),
                                        on_event=run.event,
                                        layout=run.layout)
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
        ckpt_dir=args.ckpt_dir), writer=run.mesh is None or run.mesh.rank == 0)

    # the loop's state is (params, opt_state, residuals), as the
    # reference's; the data and generator states live in ``run`` and ride
    # in checkpoints
    def one_step(state, step):
        run.params, run.opt_state, run.residuals = state
        metrics = run.step(monkey.nan_flag(step))
        run.losses[step] = float(metrics["loss"])     # waits for the step
        if run.sentinel is not None:
            policy = run.sentinel.observe(step, metrics)
            if policy is not None:
                run.qcfg = policy
                run.step_fn = _step_fn(run.cfg, policy, run.opt_cfg,
                                       run.train_cfg, True, run.mesh,
                                       run.pspecs)
                log.info("sentinel: rebuilt the step with the escalated "
                         "policy (%d rules)", len(policy.rules))
        if step % args.log_every == 0:
            log.info("step %d loss=%.6f gnorm=%.3f", step, run.losses[step],
                     float(metrics["grad_norm"]))
        if on_step is not None:
            on_step(step, metrics)
        return run.params, run.opt_state, run.residuals

    def save_state(_, step):
        checkpoint.save(args.ckpt_dir, step, run.state(), layout=run.layout)
        log.info("checkpointed step %d", step)

    def restore_fn():
        got = checkpoint.restore_latest(args.ckpt_dir, run.state(),
                                        on_event=run.event,
                                        layout=run.layout)
        if got is None:
            raise RuntimeError("no usable checkpoint to restore from")
        run.load(got[0])
        return (run.params, run.opt_state, run.residuals), got[1]

    t0 = time.time()
    fault.run_with_recovery(
        monkey.wrap(one_step), (run.params, run.opt_state, run.residuals),
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
    step, the loss already on the host.  A world this call joined
    (``init_world``) is left before it returns."""
    args = parse_args(argv)
    joined = not dist.is_initialized()
    mesh = init_world(args)
    logging.basicConfig(level=logging.INFO if mesh is None or mesh.rank == 0
                        else logging.WARNING)
    try:
        run = train(args, on_step, build(args, mesh=mesh))
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
    return [run.losses[s] for s in sorted(run.losses)]


if __name__ == "__main__":
    main()
