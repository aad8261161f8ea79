"""Train-step factory: one device, the SPMD step over a mesh, and the
compressed cross-pod step.

Counterpart of ``repro/train/trainer.py``:

* ``make_train_step`` — gradients by autograd (with microbatch
  accumulation), then the AdamW update, which writes the parameters and
  moments in place (what the reference's buffer donation buys it).
  ``gather_bits > 0`` lets the compute see each parameter's DFX image
  (``qtensor.fake_quant_ste``; straight-through gradient).
* ``jit_train_step`` — the step over a mesh, under the reference's name
  (the port has no jit).  Each rank holds its blocks of the parameters
  and moments (``init_train_state``, ``sharding.param_pspecs``).  A step
  computes on the rank's rows of the global batch under ``sharding.spmd``
  (every per-tensor exponent, and the loss's batch means, the logical
  tensor's, as XLA gives the reference).  The loss sees each layer
  stack's leaf as the rank's block, gathered one layer at a time inside
  the layer (FP32 ``all_gather``, or with ``gather_bits`` the int8 planes
  of the reference's image; ``sharding.layer_view``), and every other
  leaf gathered whole before the forward.  Each gather's backward SUMs
  its gradient over the batch axes and keeps the rank's block, so the
  gradients arrive as blocks (the backward is seeded with 1 / ranks, so
  the sum is the mean and every gradient tensor quantizes at one device's
  exponent); then the AdamW update runs on the blocks.  For every
  training stack (``sharding.tensor_parallel``; BERT / ViT fine-tuning
  aside) the gathers materialise the batch axes only and the ranks of one
  ``model`` group split every product (the model code's column- and
  row-parallel products, vocab-parallel embedding, head and loss; each
  split tensor's exponent the logical one's), and by default the residual
  stream between the products is the rank's rows of the sequence
  (``sharding.SEQUENCE_SHARDING``).  The result is one device's
  up to the f32 sum order.  During the step a
  rank holds its blocks, the non-stacked leaves (whole, or their model
  shards) and one layer's tensors and gradients.  With microbatches each
  one gathers every layer again and sums its gradients over the ranks.
* ``make_compressed_train_step`` — parameters, optimizer state and the
  error-feedback residuals replicated, the batch split over pod x data:
  an FP32 mean over ``data``, the int8 compressed mean over ``pod``
  (``core/grad_compress.py``), the metrics' mean, the update; every
  quantize takes the rank's own exponent (the reference's ``shard_map``
  body: ``sharding.manual_axes_active``).

The reference folds a fresh PRNG key into each microbatch; here the one
``key`` (a ``torch.Generator``) hands each microbatch the next numbers of
its stream.  Under a mesh each rank draws from its own generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.core import dfx, grad_compress, qtensor
from repro_torch.core.qpolicy import QuantLike
from repro_torch.train import optimizer as opt_lib

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
GradsFn = Callable[[Any, dict, Any], Tuple[Any, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_compress_bits: int = 0          # 0 = off; 8 = int8 cross-pod mean
    gather_bits: int = 0                 # 0 = f32 params; 8 = QTensor image


def gathered(params: Any, gather_bits: int) -> Any:
    """The parameters the compute sees: each one's ``gather_bits`` DFX
    image with a straight-through gradient, or the parameters (0)."""
    if not gather_bits:
        return params
    return opt_lib.tree_map(lambda p: qtensor.fake_quant_ste(p, gather_bits),
                            params)


def loss_and_grads(loss_fn: LossFn, params: Any, batch: dict, cfg,
                   qcfg: QuantLike, key, gather_bits: int = 0,
                   grad_scale: float = 1.0, view: Optional[Callable] = None):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch, cfg, qcfg,
    key)`` by autograd, the loss seeing ``gathered(params, gather_bits)``,
    or ``view(params)`` when given (a placement's).  A parameter the loss
    does not reach gets a zero gradient, as under ``jax.grad``.
    ``grad_scale``: the backward's seed (the gradients of ``grad_scale ·
    loss``)."""
    live = opt_lib.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    leaves = opt_lib.tree_leaves(live)
    seen = gathered(live, gather_bits) if view is None else view(live)
    loss, metrics = loss_fn(seen, batch, cfg, qcfg, key)
    seed = None if grad_scale == 1.0 else torch.full_like(loss, grad_scale)
    gs = torch.autograd.grad(loss, leaves, seed, allow_unused=True)
    grads = opt_lib.tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)])
    return loss.detach(), metrics, grads


def _split_micro(batch: dict, n: int) -> list:
    if any(v.shape[0] % n for v in batch.values()):
        raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} "
                         f"does not split into {n} microbatches")
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def _scalars(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0}


def make_grads_fn(loss_fn: LossFn, cfg, qcfg: QuantLike, microbatches: int,
                  gather_bits: int = 0, grad_scale: float = 1.0,
                  view: Optional[Callable] = None) -> GradsFn:
    """``(params, batch, key) -> (grads, metrics)``; with microbatches > 1
    the gradients and the scalar metrics are the means over the
    microbatches (summed in f32, then scaled by 1/n, as the reference).
    ``gather_bits`` / ``view``: what the loss sees; ``grad_scale``: the
    backward's seed (``loss_and_grads``)."""

    def single(params, batch, key):
        loss, metrics, grads = loss_and_grads(loss_fn, params, batch, cfg,
                                              qcfg, key, gather_bits,
                                              grad_scale, view)
        return grads, {"loss": loss, **_scalars(metrics)}

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


def local_rows(batch: dict, mesh: sharding.Mesh, microbatches: int = 1,
               axes: Optional[Tuple[str, ...]] = None) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors): of
    each of the ``microbatches`` consecutive row blocks, its share along
    the batch axes (``axes``), so microbatch i of the rank is its rows of
    the global microbatch i."""
    axes = sharding.batch_axes(mesh) if axes is None else axes
    n, i = mesh.count(axes), mesh.index(axes)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (microbatches * n):
            raise ValueError(f"batch of {B} rows does not split into "
                             f"{microbatches} microbatches over {n} ranks")
        rest = tuple(v.shape[1:])
        out[k] = v.reshape((microbatches, n, B // (microbatches * n))
                           + rest)[:, i].reshape((B // n,) + rest)
    return out


# =========================================================================
# Where a step's gradients come from and where its update goes
# =========================================================================

def _mean_metrics(metrics: dict, mesh: sharding.Mesh, axes) -> dict:
    """The scalar metrics' means over ``axes`` (one all-reduce); other
    entries as they are."""
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0]
    if not keys:
        return dict(metrics)
    s = sharding.all_reduce(
        torch.stack([metrics[k].to(torch.float32) for k in keys]), "sum",
        axes, mesh, tag="metric") / mesh.count(axes)
    return {**metrics, **dict(zip(keys, s.unbind()))}


class _Local:
    """One device: the loss sees ``gathered(params, gather_bits)``; the
    gradients and the update as they are."""

    scale = 1.0

    def __init__(self, gather_bits: int):
        self.gather_bits = gather_bits

    def view(self, params):
        return gathered(params, self.gather_bits)

    def grads(self, grads_fn: GradsFn, params, batch, key):
        return grads_fn(params, batch, key)

    def per_leaf(self, grads, fn) -> list:
        return [(fn(g), g.numel()) for g in opt_lib.tree_leaves(grads)]

    def global_norm(self, grads) -> torch.Tensor:
        return opt_lib.global_norm(grads)

    def update(self, opt_cfg, grads, opt_state, params):
        return opt_lib.update(opt_cfg, grads, opt_state, params)


class _Spmd:
    """A step over a mesh: each rank's blocks in, each rank's blocks out
    (the module docstring)."""

    INT32_MIN = -2 ** 31

    def __init__(self, mesh: sharding.Mesh, param_specs: Any,
                 gather_bits: int, microbatches: int = 1,
                 tp: Optional[sharding.TensorParallel] = None):
        if param_specs is None:
            raise ValueError("a step over a mesh needs the param_specs")
        self.mesh, self.specs, self.tp = mesh, param_specs, tp
        self.gather_bits, self.microbatches = gather_bits, microbatches
        self.axes = sharding.batch_axes(mesh)
        self.scale = 1.0 / mesh.count(self.axes)
        self._packed = None

    def view(self, params):
        """The loss's view of the blocks (``sharding.layer_view``; under
        tensor-parallel compute their model shards); a stack's int8 planes
        are made once a step."""
        return sharding.layer_view(params, self.specs, self.mesh,
                                   self.gather_bits, self._packed, self.tp)

    def grads(self, grads_fn: GradsFn, params, batch, key):
        """The rank's blocks of the logical gradients, and the metrics'
        means.  Each gradient reaches its block through its gather's
        backward (the SUM over the batch axes, the rank's block): a layer
        stack's a layer at a time."""
        batch = local_rows(batch, self.mesh, self.microbatches, self.axes)
        self._packed = {}
        try:
            with sharding.spmd(self.mesh, split=self.tp is not None,
                               sequence=self.tp is not None
                               and self.tp.sequence):
                grads, metrics = grads_fn(params, batch, key)
        finally:
            self._packed = None
        return grads, _mean_metrics(metrics, self.mesh, self.axes)

    def per_leaf(self, grads, fn) -> list:
        """``(fn(block), logical size)`` of each gradient leaf, ``fn``'s
        ``dfx`` reductions over the axes the leaf's spec shards, so that
        they are the logical tensor's."""
        out = []
        for g, spec in zip(opt_lib.tree_leaves(grads),
                           opt_lib.tree_leaves(self.specs)):
            axes = sharding.sharded_axes(spec, self.mesh)
            with sharding.spmd(self.mesh, axes):
                out.append((fn(g), g.numel() * self.mesh.count(axes)))
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """The logical gradients' global norm: each leaf's sum of squares
        over its blocks, then ``opt_lib.global_norm``'s sum."""
        sq = self.per_leaf(grads, lambda g: dfx.global_sum(
            torch.sum(torch.square(g.to(torch.float32)))))
        return torch.sqrt(torch.sum(torch.stack([s for s, _ in sq])))

    def _shapes(self, params):
        return [sharding.full_shape(p.shape, s, self.mesh)
                for p, s in zip(opt_lib.tree_leaves(params),
                                opt_lib.tree_leaves(self.specs))]

    def update(self, opt_cfg, grads, opt_state, params):
        """AdamW on the rank's blocks: the logical gradients' norm; a
        quantized moment takes the logical moment's exponents and the
        rank's part of its noise."""
        mesh = self.mesh
        specs = opt_lib.tree_leaves(self.specs)
        shapes = self._shapes(params)
        stacked = [opt_lib.is_stacked(p) for p in opt_lib.tree_paths(params)]
        gnorm = self.global_norm(grads)

        def noise(at, i, which):
            # the one-device draw, the rank's block of each slice of it
            return opt_lib.moment_noise(
                opt_cfg.seed, at, i, which, gnorm.device, shapes[i],
                stacked[i], sharding.local_slices(shapes[i], specs[i], mesh))

        def exp_fn(i, which, e):
            axes = sharding.sharded_axes(specs[i], mesh)
            if not axes:
                return e
            if e.dim() == 0:
                return sharding.all_reduce(e, "max", axes, mesh,
                                           tag="moment_exp")
            rows = sharding.local_slices(shapes[i], specs[i], mesh)[0]
            full = torch.full((shapes[i][0],) + tuple(e.shape[1:]),
                              self.INT32_MIN, dtype=torch.int32,
                              device=e.device)
            full[rows] = e
            return sharding.all_reduce(full, "max", axes, mesh,
                                       tag="moment_exp")[rows]

        return opt_lib.update(opt_cfg, grads, opt_state, params, noise,
                              grad_norm=gnorm, exp_fn=exp_fn)


def placement(mesh: Optional[sharding.Mesh] = None, param_specs: Any = None,
              *, gather_bits: int = 0, microbatches: int = 1,
              cfg: Any = None):
    """Where a step runs: one device (no ``mesh``), or the rank's blocks
    over ``mesh`` (``param_specs``: the blocks' specs; ``cfg``: the arch,
    whose training stack splits its products over a model axis,
    ``sharding.tensor_parallel``).  Its ``grads(grads_fn, params, batch,
    key)`` returns the gradients (blocks under a mesh) and the metrics,
    ``update(opt_cfg, grads, opt_state, params)`` the AdamW step,
    ``per_leaf(grads, fn)`` / ``global_norm(grads)`` the logical
    gradients' statistics; a gradient function for it takes its ``view``
    (what the loss sees of the parameters) and ``scale`` as its
    backward's seed."""
    if mesh is None:
        return _Local(gather_bits)
    return _Spmd(mesh, param_specs, gather_bits, microbatches,
                 sharding.tensor_parallel(cfg, mesh))


# =========================================================================
# Standard step and its SPMD form
# =========================================================================

@dataclasses.dataclass(frozen=True)
class TrainStep:
    """``make_train_step``'s step on one device; ``jit_train_step`` runs
    it over a mesh."""

    loss_fn: LossFn
    cfg: Any
    qcfg: QuantLike
    opt_cfg: opt_lib.OptimizerConfig
    train_cfg: TrainConfig

    def __call__(self, params, opt_state, batch, key):
        return self.on(placement(gather_bits=self.train_cfg.gather_bits))(
            params, opt_state, batch, key)

    def on(self, where):
        """``step(params, opt_state, batch, key)`` at ``where`` (a
        ``placement``)."""
        grads_fn = make_grads_fn(self.loss_fn, self.cfg, self.qcfg,
                                 self.train_cfg.microbatches,
                                 grad_scale=where.scale, view=where.view)

        def step(params, opt_state, batch, key):
            grads, metrics = where.grads(grads_fn, params, batch, key)
            params, opt_state, om = where.update(self.opt_cfg, grads,
                                                 opt_state, params)
            return params, opt_state, {**metrics, **om}

        return step


def make_train_step(loss_fn: LossFn, cfg, qcfg: QuantLike,
                    opt_cfg: opt_lib.OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig()) -> TrainStep:
    """``step(params, opt_state, batch, key) -> (params, opt_state,
    metrics)``: gradients (integer forward and backward through the
    model's autograd Functions; with ``gather_bits`` of the parameters'
    DFX images), then the AdamW update, in place: the returned params are
    the tensors passed in.  ``jit_train_step`` gives its SPMD form, where
    ``gather_bits`` moves the parameters as int8 planes
    (``sharding.layer_view``)."""
    return TrainStep(loss_fn, cfg, qcfg, opt_cfg, train_cfg)


def jit_train_step(step: TrainStep, mesh: sharding.Mesh, param_specs: Any,
                   *, donate: bool = True, opt_state_like: Any = None):
    """The SPMD form of a ``make_train_step`` step over ``mesh``:
    ``step(params, opt_state, batch, key)`` takes each rank's blocks and
    the global batch (every rank the same), and returns the updated blocks
    and the logical metrics.  ``donate`` and ``opt_state_like`` are the
    reference's: the update always runs in place, and the moments' layout
    follows the state passed in."""
    del donate, opt_state_like
    tcfg = step.train_cfg
    return step.on(placement(mesh, param_specs, gather_bits=tcfg.gather_bits,
                             microbatches=tcfg.microbatches, cfg=step.cfg))


# =========================================================================
# Compressed cross-pod step
# =========================================================================

def make_compressed_train_step(loss_fn: LossFn, cfg, qcfg: QuantLike,
                               opt_cfg: opt_lib.OptimizerConfig,
                               mesh: sharding.Mesh,
                               train_cfg: TrainConfig = TrainConfig()):
    """``step(params, opt_state, residuals, batch, key) -> (params,
    opt_state, residuals, metrics)`` whose cross-pod gradient mean is the
    int8 DFX all-reduce with error feedback.  Parameters, optimizer state
    and residuals are replicated; the global batch (every rank the same)
    is split over pod x data.  The gradient reduction is hierarchical: an
    FP32 mean over ``data``, then the compressed mean over ``pod``.  Every
    quantize takes the rank's own exponent; the model runs replicated over
    any ``model`` axis.  ``gather_bits`` takes the per-leaf
    straight-through form here."""
    if "pod" not in mesh.axis_names:
        raise ValueError("the compressed step needs the multi-pod mesh "
                         "(a 'pod' axis)")
    grads_fn = make_grads_fn(loss_fn, cfg, qcfg, train_cfg.microbatches,
                             train_cfg.gather_bits)
    bits = train_cfg.grad_compress_bits or 8
    has_data = "data" in mesh.axis_names and mesh.shape["data"] > 1

    def step(params, opt_state, residuals, batch, key):
        batch = local_rows(batch, mesh, train_cfg.microbatches)
        with sharding.manual_axes_active(mesh.axis_names):
            grads, metrics = grads_fn(params, batch, key)
            if has_data:
                n = mesh.shape["data"]
                grads = opt_lib.tree_map(
                    lambda g: sharding.all_reduce(g, "sum", "data", mesh,
                                                  tag="grad_sum") / n, grads)
            grads, residuals = grad_compress.compressed_psum_mean(
                grads, residuals, bits=bits, axis="pod", mesh=mesh)
            metrics = _mean_metrics(metrics, mesh, sharding.batch_axes(mesh))
            params, opt_state, om = opt_lib.update(opt_cfg, grads, opt_state,
                                                   params)
        return params, opt_state, residuals, {**metrics, **om}

    return step


# =========================================================================
# State initialization under a mesh
# =========================================================================

def init_train_state(init_fn, key, mesh: sharding.Mesh, *, fsdp: bool,
                     opt_cfg: Optional[opt_lib.OptimizerConfig] = None):
    """``(params, opt_state, pspecs)``: every rank builds the same full
    init (``init_fn(key)``, the same generator seed on every rank) and
    keeps its blocks (``sharding.param_pspecs``); the moments are made on
    the blocks, so QTensor moments shard as ``qtensor_pspecs`` says."""
    full = init_fn(key)
    pspecs = sharding.param_pspecs(full, mesh, fsdp=fsdp)
    params = sharding.shard(full, pspecs, mesh)
    del full
    return params, opt_lib.init(params, opt_cfg), pspecs
