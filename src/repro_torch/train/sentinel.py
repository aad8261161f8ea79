"""Numerics sentinel: react to the health counters.

Counterpart of ``repro/train/sentinel.py``.  Two layers:

* :func:`make_sentinel_step` — a train step that collects the per-scope
  health counters (``core/health.py``) beside the loss, computes the
  gradients' health at the policy's ``grad_bits``, and **skips** the
  optimizer update when a gradient is non-finite: the parameters and
  moments stay bit-identical.  The reference guards the update with
  ``lax.cond``; eagerly, the skip is a host branch after one read of the
  non-finite count.  ``inject_nan`` (a host number, 0 = clean) lets the
  chaos harness force the skip.
* :class:`Sentinel` — the host-side policy loop: hysteresis-gated
  per-scope bit-width escalation (a scope whose clip rate stays at or
  above ``clip_high`` for ``patience`` steps gets an int8→int16 rule in a
  new ``QuantPolicy``, and the caller builds a new step function with it;
  bounded by ``max_escalations`` and a ``cooldown``), and
  :class:`NumericsError` after ``nonfinite_patience`` skipped steps in a
  row.

The counters are plain PyTorch reductions: the sentinel step launches the
same kernels as ``trainer.make_train_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import health
from repro_torch.core.qpolicy import QuantLike, QuantPolicy, as_policy, rule
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import (LossFn, TrainConfig, loss_and_grads,
                                       placement)


class NumericsError(RuntimeError):
    """Persistent non-finite gradients — numeric health is unrecoverable by
    skipping; restore/rescale/widen instead."""


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    #: clip-rate hysteresis band: a scope counts "hot" at >= clip_high and
    #: resets only at <= clip_low (between the two, the streak holds)
    clip_high: float = 0.25
    clip_low: float = 0.05
    #: consecutive hot steps before a scope escalates
    patience: int = 3
    #: min steps between escalations (bounds rebuilds)
    cooldown: int = 20
    #: total escalation budget per run
    max_escalations: int = 4
    escalate_bits: int = 16
    #: consecutive skipped (non-finite) steps before NumericsError
    nonfinite_patience: int = 3


def grad_health(grads: Any, grad_bits: int,
                where=None) -> Dict[str, torch.Tensor]:
    """Gradient health at ``grad_bits``: worst clip rate, element-weighted
    mean zero-fraction, total non-finite count, largest step exponent.
    ``where`` (``trainer.placement``; default one device): under a mesh
    ``grads`` are blocks and the health is the logical tensors'."""
    where = where or placement()
    per = where.per_leaf(grads, lambda g: health.stats(g, grad_bits))
    gs = [s for s, _ in per]
    sizes = torch.tensor([float(n) for _, n in per],
                         device=gs[0]["clip"].device)
    return {
        "clip": torch.stack([s["clip"] for s in gs]).max(),
        "zero": (torch.stack([s["zero"] for s in gs]) * sizes).sum()
        / sizes.sum(),
        "nonfinite": torch.stack([s["nonfinite"] for s in gs]).sum(),
        "exp": torch.stack([s["exp"] for s in gs]).max(),
    }


def make_sentinel_step(loss_fn: LossFn, cfg, qcfg: QuantLike,
                       opt_cfg: opt_lib.OptimizerConfig,
                       train_cfg: TrainConfig = TrainConfig(), *,
                       mesh=None, param_specs=None):
    """Sentinel variant of ``trainer.make_train_step``:
    ``step(params, opt_state, batch, key, inject_nan)`` returns
    ``(params, opt_state, metrics)``; metrics carry ``skipped`` (1.0 when
    the non-finite guard fired: params and moments are then the tensors
    passed in, untouched), ``lr`` (0 on a skip) and ``health``, the
    per-scope counters and the ``grads`` aggregate.  With ``mesh`` and
    ``param_specs`` it is the SPMD step of ``trainer.jit_train_step``
    (blocks in and out, the global batch); the probes' counters and the
    gradients' health are then the logical tensors'."""
    grad_bits = as_policy(qcfg).base.grad_bits
    where = placement(mesh, param_specs, gather_bits=train_cfg.gather_bits,
                      cfg=cfg)

    def loss_with_health(params, batch, cfg, qcfg, key):
        # the collector is open around the forward only: the backward's
        # remat recomputes are not probed again
        with health.collect() as hp:
            loss, metrics = loss_fn(params, batch, cfg, qcfg, key)
        return loss, {**metrics, "health": hp}

    def grads_fn(params, batch, key):
        loss, metrics, grads = loss_and_grads(
            loss_with_health, params, batch, cfg, qcfg, key,
            grad_scale=where.scale, view=where.view)
        scal = {k: v.detach() for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0}
        return grads, {"loss": loss, **scal, "health": metrics["health"]}

    def step(params, opt_state, batch, key, inject_nan=0.0):
        grads, metrics = where.grads(grads_fn, params, batch, key)
        loss = metrics["loss"]
        if float(inject_nan) > 0:
            grads = opt_lib.tree_map(lambda g: g + float("nan"), grads)
        gh = grad_health(grads, grad_bits, where)
        if float(gh["nonfinite"]) == 0:
            params, opt_state, om = where.update(opt_cfg, grads, opt_state,
                                                 params)
            skipped = 0.0
        else:
            # params and moments pass through; lr 0 marks the skip
            om = {"grad_norm": where.global_norm(grads),
                  "lr": torch.zeros((), device=loss.device)}
            skipped = 1.0
        return params, opt_state, {
            **metrics, **om,
            "skipped": torch.tensor(skipped, device=loss.device),
            "health": {**metrics["health"], "grads": gh}}

    return step


Event = Dict[str, Any]


class Sentinel:
    """Host-side reaction loop over sentinel-step metrics.

    ``observe(step, metrics)`` returns a rebuilt :class:`QuantPolicy` when a
    scope escalated (the caller builds a new step with it) or ``None``.
    Raises :class:`NumericsError` on a persistent non-finite streak.
    """

    def __init__(self, cfg: SentinelConfig, qcfg: QuantLike,
                 on_event: Optional[Callable[[Event], None]] = None):
        self.cfg = cfg
        self.policy = as_policy(qcfg)
        self.on_event = on_event
        self.events: List[Event] = []
        self.hot: Dict[str, int] = {}
        self.escalated: Dict[str, int] = {}
        self.escalations = 0
        self.cooldown_until = -1
        self.nonfinite_streak = 0

    def _emit(self, ev: Event) -> None:
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    def observe(self, step: int, metrics: Dict[str, Any]
                ) -> Optional[QuantPolicy]:
        if float(metrics.get("skipped", 0.0)) > 0:
            self.nonfinite_streak += 1
            self._emit({"type": "skip-step", "step": step,
                        "streak": self.nonfinite_streak})
            if self.nonfinite_streak >= self.cfg.nonfinite_patience:
                raise NumericsError(
                    f"{self.nonfinite_streak} consecutive non-finite-"
                    f"gradient steps at step {step}; skipping cannot "
                    "recover — restore from checkpoint or widen bits")
        else:
            self.nonfinite_streak = 0

        new_policy = None
        hp = metrics.get("health") or {}
        for tag in sorted(hp):
            if tag == "grads" or tag in self.escalated:
                continue
            clip = float(hp[tag]["clip"])
            if clip >= self.cfg.clip_high:
                self.hot[tag] = self.hot.get(tag, 0) + 1
            elif clip <= self.cfg.clip_low:
                self.hot[tag] = 0
            # clip_low < clip < clip_high: hysteresis — streak holds
            if (self.hot.get(tag, 0) >= self.cfg.patience
                    and step >= self.cooldown_until
                    and self.escalations < self.cfg.max_escalations):
                new_policy = self._escalate(step, tag)
        return new_policy

    def _escalate(self, step: int, tag: str) -> QuantPolicy:
        b = self.cfg.escalate_bits
        self.escalations += 1
        self.cooldown_until = step + self.cfg.cooldown
        self.escalated[tag] = b
        self.hot[tag] = 0
        # tag "blocks.*.mlp" -> pattern "blocks.*.mlp*" covers the module
        # and all its leaves; appended rules out-rank earlier ties
        self.policy = QuantPolicy(
            base=self.policy.base,
            rules=self.policy.rules + (
                rule(tag + "*", weight_bits=b, act_bits=b, grad_bits=b,
                     warn_stability=False),))
        self._emit({"type": "escalation", "step": step, "scope": tag,
                    "bits": b, "n": self.escalations})
        return self.policy
