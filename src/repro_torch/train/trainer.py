"""Train-step factory for one device.

Counterpart of the single-device path of ``repro/train/trainer.py``:
``TrainConfig``, ``make_grads_fn`` (gradients by autograd, with
microbatch accumulation) and ``make_train_step`` (gradients, then the
AdamW update).  PyTorch runs the step eagerly, so there is no
``jit_train_step``; the AdamW update writes the parameters and moments in
place, which is what the reference's buffer donation buys it.  The reference's quantized
parameter gather (``gather_bits > 0``, the state plane), its compressed
cross-pod step and its mesh set-up (the distributed slice) are not
ported yet and raise ``NotImplementedError``.  The reference folds a fresh PRNG key into each
microbatch; here the one ``key`` (a ``torch.Generator``) hands each
microbatch the next numbers of its stream.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.qpolicy import QuantLike
from repro_torch.train import optimizer as opt_lib

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_compress_bits: int = 0          # 0 = off (only one ported)
    gather_bits: int = 0                 # 0 = f32 params (only one ported)


def loss_and_grads(loss_fn: LossFn, params: Any, batch: dict, cfg,
                   qcfg: QuantLike, key):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch, cfg, qcfg,
    key)`` by autograd.  A parameter the loss does not reach gets a zero
    gradient, as under ``jax.grad``."""
    live = opt_lib.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    leaves = opt_lib.tree_leaves(live)
    loss, metrics = loss_fn(live, batch, cfg, qcfg, key)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = opt_lib.tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)])
    return loss.detach(), metrics, grads


def _split_micro(batch: dict, n: int) -> list:
    if any(v.shape[0] % n for v in batch.values()):
        raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} "
                         f"does not split into {n} microbatches")
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def make_grads_fn(loss_fn: LossFn, cfg, qcfg: QuantLike, microbatches: int):
    """``(params, batch, key) -> (grads, metrics)``; with microbatches > 1
    the gradients and the scalar metrics are the means over the
    microbatches (summed in f32, then scaled by 1/n, as the reference)."""

    def single(params, batch, key):
        loss, metrics, grads = loss_and_grads(loss_fn, params, batch, cfg,
                                              qcfg, key)
        return grads, {"loss": loss,
                       **{k: v.detach() for k, v in metrics.items()
                          if isinstance(v, torch.Tensor) and v.dim() == 0}}

    if microbatches <= 1:
        return single

    def accumulated(params, batch, key):
        grads = mets = None
        for mbatch in _split_micro(batch, microbatches):
            g, m = single(params, mbatch, key)
            if grads is None:
                grads, mets = g, m
            else:
                grads = opt_lib.tree_map(torch.add, grads, g)
                mets = {k: mets[k] + m[k] for k in mets}
        inv = 1.0 / microbatches
        return (opt_lib.tree_map(lambda g: g * inv, grads),
                {k: v * inv for k, v in mets.items()})

    return accumulated


def make_train_step(loss_fn: LossFn, cfg, qcfg: QuantLike,
                    opt_cfg: opt_lib.OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig(), *,
                    mesh=None, param_specs=None):
    """``step(params, opt_state, batch, key) -> (params, opt_state,
    metrics)``: gradients (integer forward and backward through the
    model's autograd Functions), then the AdamW update, in place: the
    returned trees are the tensors passed in."""
    if mesh is not None or param_specs is not None:
        raise NotImplementedError(
            "mesh set-up belongs to the distributed slice, not ported yet")
    if train_cfg.gather_bits > 0:
        raise NotImplementedError(
            "gather_bits > 0 (QTensor parameter gather) belongs to the state "
            "plane slice, not ported yet")
    if train_cfg.grad_compress_bits > 0:
        raise NotImplementedError(
            "grad_compress_bits > 0 belongs to the distributed slice (the "
            "compressed cross-pod step), not ported yet")
    grads_fn = make_grads_fn(loss_fn, cfg, qcfg, train_cfg.microbatches)

    def step(params, opt_state, batch, key):
        grads, metrics = grads_fn(params, batch, key)
        params, opt_state, om = opt_lib.update(opt_cfg, grads, opt_state,
                                               params)
        return params, opt_state, {**metrics, **om}

    return step


def make_compressed_train_step(*args, **kwargs):
    """The reference's int8 cross-pod gradient all-reduce step."""
    raise NotImplementedError(
        "the compressed cross-pod train step belongs to the distributed "
        "slice, not ported yet")
