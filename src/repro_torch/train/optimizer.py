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
from those four numbers (and the layer, for each leading slice of a layer
stack's leaf), so a run restored from a checkpoint draws what the
uninterrupted run drew.  The denominator is floored at one step of
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


def tree_paths(tree: Any, path: str = "") -> list:
    """Each leaf's keys joined by ``/``, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{path}/{k}" if path else k)]
    return [path]


#: the layer stacks: a leaf below one of these keys has a leading layer axis
STACKS = ("blocks", "enc_blocks", "dec_blocks")


def is_stacked(path: str) -> bool:
    """Whether the leaf at ``path`` (``tree_paths``) is a layer stack's."""
    return any(c in STACKS for c in path.split("/")[:-1])


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
                     device, layer: Optional[int] = None) -> torch.Generator:
    """The generator of one quantized moment's stochastic rounding at one
    step: seeded from ``(seed, step, leaf index, m | v)``, and ``layer``
    for one leading slice of a stacked leaf."""
    s = np.random.SeedSequence([seed, step, leaf, "mv".index(which)]
                               + ([] if layer is None else [layer]))
    if torch.device(device).type == "meta":   # no meta generator: the CPU's
        device = "cpu"
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def _host_step(step: torch.Tensor) -> int:
    """The step counter's value on the host, which seeds the quantized
    moments' noise (one read a step).  A meta step (the dry-run's) holds
    no value: its draws take step 0's seeds, and only their shapes
    count there."""
    return 0 if step.device.type == "meta" else int(step)


def moment_noise(seed: int, step: int, leaf: int, which: str, device,
                 shape, stacked: bool, block=None):
    """``dfx.uniform``'s key for one quantized moment of logical ``shape``
    at one step.  A stacked leaf draws one leading slice (layer) at a
    time, each from its own ``moment_generator``, so no draw is larger than
    one layer; any other leaf draws whole from one generator.  ``block``:
    the slices of the rank's block of the logical tensor (a sharded
    moment), which keeps its block of each draw: the same numbers the
    one-device draw puts there."""
    shape = tuple(shape)
    if not stacked:
        gen = moment_generator(seed, step, leaf, which, device)
        if block is None:
            return gen
        return lambda _, dev: torch.rand(shape, generator=gen, device=dev,
                                         dtype=torch.float32)[block]
    block = block or tuple(slice(None) for _ in shape)
    rows = range(*block[0].indices(shape[0]))

    def draw(_, dev):
        out = None
        for j, layer in enumerate(rows):
            u = torch.rand(shape[1:], generator=moment_generator(
                seed, step, leaf, which, dev, layer), device=dev,
                dtype=torch.float32)[block[1:]]
            if out is None:
                out = torch.empty((len(rows),) + tuple(u.shape),
                                  dtype=torch.float32, device=dev)
            out[j] = u
        return out
    return draw


def _check_tree(name: str, tree: Any, params: Any) -> None:
    try:
        tree_map(lambda *_: None, params, tree)
    except ValueError as e:
        # pairing leaves of mismatched trees would update the wrong moments
        raise ValueError(f"{name} tree does not match the param tree ({e}); "
                         "build the optimizer state with "
                         "optimizer.init(params, cfg)") from None


NoiseFn = Callable[[int, int, str], Any]
ExpFn = Callable[[int, str, torch.Tensor], torch.Tensor]


@torch.no_grad()
def update(cfg: OptimizerConfig, grads: Any, state: OptState, params: Any,
           noise: Optional[NoiseFn] = None, *,
           grad_norm: Optional[torch.Tensor] = None,
           exp_fn: Optional[ExpFn] = None) -> Tuple[Any, OptState, dict]:
    """Returns ``(params, state, metrics)``: the same parameter tensors it
    was given, updated in place, leaf by leaf (the reference donates their
    buffers to its jitted step), and the moments — FP32 ones updated in
    place, QTensor ones new.  The gradients are left as they are: each
    leaf's clipped copy lives in a leaf-sized temporary.  Every product
    and sum is the out-of-place formula's, in its order (no fused
    multiply-add).

    ``noise(step, leaf index, "m" | "v")`` returns the key of a quantized
    moment's stochastic rounding (``dfx.uniform``'s: a generator or a
    callable handing in ``u``); by default ``moment_noise``'s.

    Sharded state (each rank's blocks, ``trainer.jit_train_step``):
    ``grad_norm`` is the logical gradients' global norm, and
    ``exp_fn(leaf index, "m" | "v", e)`` maps a block's own step exponents
    to the logical moment's."""
    _check_tree("gradient", grads, params)
    _check_tree("moment (m)", state.m, params)
    _check_tree("moment (v)", state.v, params)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
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
    at = _host_step(state.step) if quantized else 0
    if quantized and noise is None:
        stacked = [is_stacked(p) for p in tree_paths(params)]
        shapes = [p.shape for p in tree_leaves(params)]

        def noise(at, i, which):
            return moment_noise(cfg.seed, at, i, which, sf.device,
                                shapes[i], stacked[i])

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
        m = qtensor.ema_update(m, g, b1, noise(at, i, "m"), None if exp_fn
                               is None else lambda e: exp_fn(i, "m", e))
        v = qtensor.ema_update(v, torch.square(g), b2, noise(at, i, "v"),
                               None if exp_fn is None
                               else lambda e: exp_fn(i, "v", e))
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
