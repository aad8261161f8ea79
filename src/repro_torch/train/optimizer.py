"""AdamW with FP32 master weights — the paper keeps the weight update in
FP32 while the layer compute is integer, so the params stay float32 under
every quantization preset.

Counterpart of ``repro/train/optimizer.py`` over nested dicts of tensors:
``init`` / ``update`` with global-norm clipping and a linear-warmup + cosine
or linear decay schedule.  Leaves are visited in sorted-key order, as
``jax.tree`` flattens a dict.

``state_bits=0`` keeps FP32 moments and updates them in place.  With
``state_bits > 0`` the moments are ``core.qtensor.QTensor``s: int8 limb
planes with one exponent per leading slice for a parameter of two or more
dimensions, one exponent for a vector.  Their EMA is computed in FP32 and
re-quantized with stochastic rounding (``qtensor.ema_update``), whose
noise is a function of ``(cfg.seed, step, leaf index, m | v)`` as the
reference's ``fold_in(PRNGKey(seed), step)`` keys are: a generator seeded
from those four numbers, so a run restored from a checkpoint draws what
the uninterrupted run drew.  The denominator is floored at one step of
``v``'s scale, ``max(v, 2^v.exp)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dfx, qtensor


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
    state_bits: int = 0               # 0 = FP32 moments; 8/16 = QTensor m, v
    seed: int = 0                     # SR stream for quantized-moment EMA


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
    return _build(tree, iter(leaves))


def _build(tree: Any, it) -> Any:
    # a module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, which kept the ``leaves`` (a whole
    # gradient tree) alive until the cyclic garbage collector ran
    if isinstance(tree, dict):
        return {k: _build(tree[k], it) for k in sorted(tree)}
    return next(it)


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


def init(params: Any, cfg: Optional[OptimizerConfig] = None) -> OptState:
    """Zero moments: FP32, or QTensors when ``cfg.state_bits > 0`` (one
    exponent per leading slice for ``ndim >= 2``, else one)."""
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if cfg is None or cfg.state_bits == 0:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return OptState(step=step, m=zeros, v=tree_map(torch.clone, zeros))

    def zq(p):
        return qtensor.zeros(p.shape, cfg.state_bits,
                             group_axis=0 if p.dim() >= 2 else None,
                             device=p.device)

    return OptState(step=step, m=tree_map(zq, params),
                    v=tree_map(zq, params))


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


def moment_generator(seed: int, step: int, leaf: int, which: str,
                     device) -> torch.Generator:
    """The generator of one quantized moment's stochastic rounding at one
    step: seeded from ``(seed, step, leaf index, m | v)``."""
    s = np.random.SeedSequence([seed, step, leaf, "mv".index(which)])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def _check_tree(name: str, tree: Any, params: Any) -> None:
    try:
        tree_map(lambda *_: None, params, tree)
    except ValueError as e:
        # pairing leaves of mismatched trees would update the wrong moments
        raise ValueError(f"{name} tree does not match the param tree ({e}); "
                         "build the optimizer state with "
                         "optimizer.init(params, cfg)") from None


NoiseFn = Callable[[int, int, str], Any]


@torch.no_grad()
def update(cfg: OptimizerConfig, grads: Any, state: OptState, params: Any,
           noise: Optional[NoiseFn] = None) -> Tuple[Any, OptState, dict]:
    """Returns ``(params, state, metrics)``: the same parameter tensors it
    was given, updated in place, leaf by leaf (the reference donates their
    buffers to its jitted step), and the moments — FP32 ones updated in
    place, QTensor ones new.  The gradients are left as they are: each
    leaf's clipped copy lives in a leaf-sized temporary.  Every product
    and sum is the out-of-place formula's, in its order (no fused
    multiply-add).

    ``noise(step, leaf index, "m" | "v")`` returns the key of a quantized
    moment's stochastic rounding (``dfx.uniform``'s: a generator or a
    callable handing in ``u``); by default ``moment_generator``."""
    _check_tree("gradient", grads, params)
    _check_tree("moment (m)", state.m, params)
    _check_tree("moment (v)", state.v, params)
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=sf.device), sf)
    quantized = any(qtensor.is_qtensor(m) for m in tree_leaves(state.m))
    at = int(state.step) if quantized else 0      # one read per step
    if quantized and noise is None:
        def noise(at, i, which):
            return moment_generator(cfg.seed, at, i, which, sf.device)

    def apply(p, m, v, ta, tb):
        # FP32 master weight update (paper-kept op):
        # p = p - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * p)
        torch.div(m, bc1, out=ta)
        torch.div(v, bc2, out=tb).sqrt_().add_(cfg.eps)
        ta.div_(tb)
        ta.add_(torch.mul(p, cfg.weight_decay, out=tb))
        p.sub_(ta.mul_(lr))

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        ta, tb = torch.empty_like(m), torch.empty_like(m)
        if scale is not None:
            g = torch.mul(g, scale, out=ta)
        # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g²
        torch.mul(g, 1 - b1, out=tb)
        m.mul_(b1).add_(tb)
        torch.square(g, out=tb).mul_(1 - b2)
        v.mul_(b2).add_(tb)
        apply(p, m, v, ta, tb)
        return m, v

    def upd_q(i, p, g, m, v):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        m = qtensor.ema_update(m, g, b1, noise(at, i, "m"))
        v = qtensor.ema_update(v, torch.square(g), b2, noise(at, i, "v"))
        del g
        mf, vf = qtensor.dequantize(m), qtensor.dequantize(v)
        # a b-bit v cannot hold entries below one step of its group's
        # scale: they round to 0, and m / (sqrt(0) + eps) explodes.  The
        # floor gives them a small update instead.
        torch.maximum(vf, dfx.pow2(v.exp), out=vf)
        apply(p, mf, vf, mf, vf)
        return m, v

    if quantized:
        out = [upd_q(i, p, g, m, v) for i, (p, g, m, v) in enumerate(zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
            tree_leaves(state.v)))]
        state = OptState(step, tree_unflatten(params, [o[0] for o in out]),
                         tree_unflatten(params, [o[1] for o in out]))
    else:
        tree_map(upd, params, grads, state.m, state.v)
        state = OptState(step, state.m, state.v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
