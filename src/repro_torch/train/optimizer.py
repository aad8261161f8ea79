"""AdamW with FP32 master weights — the paper keeps the weight update in
FP32 while the layer compute is integer, so the params stay float32 under
every quantization preset.

Counterpart of ``repro/train/optimizer.py`` over nested dicts of tensors:
``init`` / ``update`` with global-norm clipping and a linear-warmup + cosine
or linear decay schedule, FP32 moments.  The reference's quantized moments
(``state_bits > 0``, QTensor state) belong to the state plane, which is not
ported yet: asking for them raises ``NotImplementedError``.  Leaves are
visited in sorted-key order, as ``jax.tree`` flattens a dict.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-5                  # paper's GLUE fine-tuning LR
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 0              # 0 => constant LR (paper: constant)
    schedule: str = "constant"        # constant | cosine | linear
    state_bits: int = 0               # 0 = FP32 moments (only one ported)


class OptState(NamedTuple):
    step: torch.Tensor                # int32 0-d, on the params' device
    m: Any
    v: Any


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict in sorted-key order (``jax.tree`` order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree: Any, leaves) -> Any:
    """A nested dict shaped like ``tree`` holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("trees do not match: keys "
                                 f"{sorted(tree)} vs "
                                 f"{sorted(r) if isinstance(r, dict) else r}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _no_quantized_state(cfg: Optional[OptimizerConfig]) -> None:
    if cfg is not None and cfg.state_bits > 0:
        raise NotImplementedError(
            "quantized optimizer moments (state_bits > 0) belong to the "
            "state plane, which is not ported yet")


def init(params: Any, cfg: Optional[OptimizerConfig] = None) -> OptState:
    """Zero FP32 moments."""
    _no_quantized_state(cfg)
    leaf = tree_leaves(params)[0]
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                    m=zeros, v=tree_map(torch.clone, zeros))


def _schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    s = step.to(torch.float32)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp((s + 1) / cfg.warmup_steps, max=1.0)
    if cfg.total_steps > 0 and cfg.schedule != "constant":
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.schedule == "cosine":
            lr = lr * 0.5 * (1 + torch.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            lr = lr * (1 - frac)
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def update(cfg: OptimizerConfig, grads: Any, state: OptState, params: Any
           ) -> Tuple[Any, OptState, dict]:
    """Returns ``(new_params, new_state, metrics)``; nothing is updated in
    place."""
    _no_quantized_state(cfg)
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=sf.device), sf)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        # FP32 master weight update (paper-kept op)
        newp = p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                         + cfg.weight_decay * p)
        return newp.to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, state.m, state.v)
    p, m, v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return p, OptState(step, m, v), {"grad_norm": gnorm, "lr": lr}
