"""The mesh, the parameter partition rules and the int8 parameter gather
over ``torch.distributed``.

Counterpart of ``repro/sharding.py``.  Axes (the reference's DESIGN.md §5):

* ``pod``   — outer data-parallel axis spanning pods (multi-pod mesh only)
* ``data``  — inner data-parallel / FSDP axis
* ``model`` — the tensor-parallel axis of the rules.  For every
  training stack (``tensor_parallel``: the dense, MoE, VLM, SSM and
  hybrid families and whisper's encoder-decoder) a step splits each
  integer product over the model group as GSPMD splits the reference's: a
  gather materialises the ``data`` axis only and the rank computes on its
  ``model`` shard (its attention or SSD heads, its part of the MLP's,
  each expert's and the Mamba2 inner width, its vocabulary rows;
  ``core/int_ops.py``'s column- and row-parallel products).  A k / v leaf
  whose split falls on no whole kv head is gathered over ``model`` too,
  and every rank computes the kv heads (Megatron's kv replication; tag
  ``gather_layer_kv``); so is the Mamba2 gated norm's gain, whose norm
  runs over the whole inner row (``gather_layer_norm``).  BERT / ViT
  fine-tuning computes replicated.

A step gathers the leaves of the layer stacks (``blocks/``, ``enc_blocks/``,
``dec_blocks/``) one layer at a time, inside the layer that uses them
(``layer_view`` / ``gather_layer``), as XLA partitions the reference's scan
over layers: a rank holds one layer's tensors (logical, or their model
shards) and their gradient beside its blocks.  Every other leaf is
gathered whole before the forward (``_Gather``), or to its model shard.

A :class:`Mesh` names the axes of the initialised world in row-major
order (rank ``r`` sits at ``unravel_index(r, shape)``) and holds one
process group for every subset of its axes.  Every rank keeps its block
of each parameter: a spec is a plain tuple per leaf, one entry per
dimension, an axis name or None (the reference's ``PartitionSpec``).

The collectives live here (``all_reduce`` with SUM or MAX, ``all_gather``,
``reduce_scatter``, ``barrier``): what both gloo and NCCL offer.  Under gloo a
CUDA tensor is staged through the host explicitly (the compute stays on
the card); under NCCL nothing is staged.  Each call is counted in
``STATS`` under a tag, with the bytes of its result, and the largest
single result by tag in ``LARGEST``.

A dry mesh (``Mesh(shape, names, rank=r, backend="dry")``, no process
group) is one rank of a mesh without a world, for the dry-run
(``launch/dryrun.py``): its collectives take ``meta`` tensors (any other
raises) and return ``meta`` tensors of the shapes a real group returns,
counted in ``STATS`` / ``LARGEST`` as a real call is; its ``barrier``
does nothing.

Sequence sharding (``SEQUENCE_SHARDING``, the reference's default): under
a step that splits its products, the ``(B, S, D)`` residual stream between
the products is ``(B, S / M, D)`` on each model rank, as the reference's
``constrain_tokens`` lays it out (Megatron's sequence parallelism;
``core/int_ops.py``'s ``gather_from_sequence`` / ``reduce_scatter_to_
sequence``).  A stream whose length the model axis does not divide stays
whole, as ``constrain`` leaves such a dim unsharded.

Not ported: ``constrain`` / ``constrain_batch`` / ``constrain_tokens``,
``make_mesh_compat`` and ``shard_map_compat`` — layout hints and version
shims for XLA; the port places every tensor explicitly.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dfx, qtensor
from repro_torch.train import optimizer as opt_lib

Spec = Tuple[Optional[str], ...]


class Mesh:
    """Axis names and sizes; with ``groups`` (``init_mesh``) also this
    rank's coordinates and a process group for every subset of the axes.
    Without them (``Mesh(shape, names)``) it only answers sizes, as the
    partition rules need; with ``rank`` and ``backend="dry"`` it is that
    rank of a mesh without a world (``dry_mesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None,
                 groups: Optional[Dict[Tuple[str, ...], Any]] = None,
                 backend: Optional[str] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = rank
        self.coords = (None if rank is None else dict(zip(
            self.axis_names, (int(c) for c in np.unravel_index(
                rank, tuple(self.shape.values()))))))
        self._groups = groups or {}
        self.backend = backend

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def axes(self, names) -> Tuple[str, ...]:
        """``names`` (a name, a tuple or None) that are axes of the mesh,
        in the mesh's order."""
        names = (names,) if isinstance(names, str) else tuple(names or ())
        return tuple(a for a in self.axis_names if a in names)

    def count(self, names) -> int:
        """Ranks along ``names``."""
        return math.prod(self.shape[a] for a in self.axes(names))

    def index(self, names) -> int:
        """This rank's row-major index over ``names`` (its rank in their
        group)."""
        idx = 0
        for a in self.axes(names):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, names):
        """The process group of the ranks that differ from this one only
        along ``names``."""
        return self._groups[self.axes(names)]


DRY = "dry"


def dry_mesh(shape: Sequence[int], axis_names: Sequence[str],
             rank: int = 0) -> Mesh:
    """Rank ``rank`` of a ``shape`` mesh with no world: its collectives
    return ``meta`` tensors of the shapes the group's would (the
    dry-run)."""
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} outside a {tuple(shape)} mesh")
    return Mesh(shape, axis_names, rank=rank, backend=DRY)


def init_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the initialised world (``prod(shape)`` ranks).  Every
    rank creates every group, in one order (``new_group`` is collective)."""
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the world has {world}")
    rank = dist.get_rank()
    names = tuple(axis_names)
    grid = np.arange(world).reshape(tuple(shape))
    groups = {}
    for n in range(1, len(names) + 1):
        for sub in itertools.combinations(range(len(names)), n):
            rest = [i for i in range(len(names)) if i not in sub]
            # rows: the ranks that share every coordinate outside ``sub``
            rows = np.transpose(grid, rest + list(sub)).reshape(
                -1, math.prod(shape[i] for i in sub))
            for row in rows:
                g = dist.new_group([int(r) for r in row])
                if rank in row:
                    groups[tuple(names[i] for i in sub)] = g
    return Mesh(shape, names, rank=rank, groups=groups,
                backend=dist.get_backend())


# ---------------------------------------------------------------------------
# Active mesh, the SPMD step's exponent sync and the manual bodies
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Mesh] = None

#: axes under manual control (the reference's ``shard_map`` bodies):
#: while any are, every reduction of a quantize is the rank's own
_MANUAL_AXES: frozenset = frozenset()


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def batch_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


class _Sync:
    """``dfx.Sync`` over the ranks along ``axes``: a step's tensors are
    split over the batch axes (a tensor the model ranks hold whole; the
    MAX over the world would be the same number, at more ranks' cost), a
    tensor split over the model group too over the batch and model axes
    (``suffix`` ``_model`` on its tags), a gradient block over the axes its
    spec shards.  ``ranks``: the ranks the rows are split over (the batch
    axes')."""

    def __init__(self, mesh: Mesh, axes: Tuple[str, ...],
                 ranks: Optional[int] = None, suffix: str = ""):
        self.mesh, self.axes, self.suffix = mesh, axes, suffix
        self.ranks = mesh.count(axes) if ranks is None else ranks

    def max(self, t: torch.Tensor) -> torch.Tensor:
        if not self.axes:            # every rank holds the whole tensor
            return t
        return all_reduce(t, "max", self.axes, self.mesh,
                          tag="exponent" + self.suffix)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if not self.axes:
            return t
        return all_reduce(t, "sum", self.axes, self.mesh,
                          tag="stat" + self.suffix)


class _ModelGroup:
    """``dfx.model`` for a step that splits its products over the model
    group: the rank's place in it, the SUM / MAX over it, and the
    reduction of a tensor split over the batch and model axes.
    ``sequence``: the step shards its residual streams' sequence over the
    group (``SEQUENCE_SHARDING``; a stream whose length ``size`` does not
    divide stays whole, ``int_ops.sequence_split``).  ``batch``: the axes
    the rows are split over (default the batch axes; none where every rank
    holds the whole batch, as a served batch the batch axes do not
    divide)."""

    def __init__(self, mesh: Mesh, sequence: bool = False,
                 batch: Optional[Tuple[str, ...]] = None):
        self.mesh, self.sequence = mesh, sequence
        self.size, self.index = mesh.count("model"), mesh.index("model")
        batch = mesh.axes(batch_axes(mesh) if batch is None else batch)
        self.sync = _Sync(mesh, mesh.axes(batch + ("model",)),
                          ranks=mesh.count(batch), suffix="_model")

    def sum(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        return all_reduce(t, "sum", "model", self.mesh, tag=tag)

    def max(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        return all_reduce(t, "max", "model", self.mesh, tag=tag)

    def gather(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """``(size, *t.shape)``: every rank's ``t``, in rank order."""
        return all_gather(t, "model", self.mesh, tag=tag)

    def reduce_scatter(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The SUM over the group of every rank's ``t[index]`` (``t``:
        ``(size, *block)``, a block a rank, in rank order)."""
        return reduce_scatter(t, "model", self.mesh, tag=tag)


@contextlib.contextmanager
def spmd(mesh: Mesh, axes=None, split: bool = False,
         sequence: bool = False):
    """The body of a distributed step: every per-tensor exponent, and the
    statistics and batch means that decide one, are the logical tensor's
    (``dfx.sync``), as in the reference's jit'd SPMD step; off inside
    ``manual_axes_active``.  ``axes``: the axes the tensors are split
    over (default the batch axes; none: nothing to reduce, unless the
    products split, whose split tensors still reduce over the model
    group).  ``split``: the step splits its products over the model group
    (``dfx.model``); ``sequence``: it also shards its residual streams'
    sequence there."""
    axes = mesh.axes(batch_axes(mesh) if axes is None else axes)
    prev, prev_model = dfx.sync, dfx.model
    tp = split and not _MANUAL_AXES and mesh.count("model") > 1
    dfx.sync = (None if _MANUAL_AXES or not (axes or tp)
                else _Sync(mesh, axes))
    dfx.model = _ModelGroup(mesh, sequence, axes) if tp else None
    try:
        yield
    finally:
        dfx.sync, dfx.model = prev, prev_model


@contextlib.contextmanager
def manual_axes_active(axes):
    """Mark ``axes`` manual (the reference's ``shard_map`` bodies): every
    quantize in the block takes the exponent of the rank's own tensor, and
    nothing is split over the model group."""
    global _MANUAL_AXES
    prev, prev_sync, prev_model = _MANUAL_AXES, dfx.sync, dfx.model
    _MANUAL_AXES = prev | frozenset(axes)
    dfx.sync = dfx.model = None
    try:
        yield
    finally:
        _MANUAL_AXES = prev
        dfx.sync, dfx.model = prev_sync, prev_model


# ---------------------------------------------------------------------------
# Tensor-parallel compute
# ---------------------------------------------------------------------------

#: sequence-parallel residual sharding (the reference's Megatron-SP layout
#: and default): under a step that splits its products over the model
#: group, the residual stream between the products is split over the group
#: along the sequence.  The reference's dry-run ``no_sp`` variant sets it
#: False to measure what it costs; so do the tests that hold the layout
#: without it.
SEQUENCE_SHARDING = True

#: the decoder-only families whose products split over the model group:
#: the attention stacks (``lm._attn_block``), the SSM stack (Mamba2) and
#: the hybrid (Mamba2 + the shared attention block); an enc-dec config
#: (whisper) splits too
TP_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")

#: the leaves a step under tensor-parallel compute gathers over ``model``
#: too, whole on every rank of the group: a kv leaf where the kv heads do
#: not split whole (Megatron's kv replication; tag ``gather_layer_kv``) and
#: the Mamba2 gated norm's gain, whose norm runs over the whole inner row
#: (tag ``gather_layer_norm``)
_KV_LEAF = r"(^|/)(wk|wv|bk|bv)$"
_NORM_LEAF = r"(^|/)norm_g$"


class TensorParallel:
    """A step that splits its products over a model group of ``size``
    ranks.  ``kv_split``: the kv heads split whole over the group; else
    every rank computes all of them from the k / v leaves gathered over
    ``model`` too (Megatron's kv replication), and attends with the one
    its query heads read.  ``sequence``: the residual streams between the
    products are split over the group along the sequence
    (``SEQUENCE_SHARDING``)."""

    def __init__(self, size: int, kv_split: bool, sequence: bool = False):
        self.size, self.kv_split, self.sequence = size, kv_split, sequence

    def keep(self, path: str) -> Tuple[str, ...]:
        """The axes a leaf's gather leaves sharded: ``model``, but for a
        replicated kv leaf and the gated norm's gain."""
        if ((not self.kv_split and re.search(_KV_LEAF, path))
                or re.search(_NORM_LEAF, path)):
            return ()
        return ("model",)

    @staticmethod
    def whole_tag(path: str) -> str:
        """The collective tag of a stack leaf gathered whole over
        ``model`` (``keep`` empty)."""
        return ("gather_layer_norm" if re.search(_NORM_LEAF, path)
                else "gather_layer_kv")


def tensor_parallel(cfg: Any, mesh: Mesh) -> Optional[TensorParallel]:
    """How a step of ``cfg`` on ``mesh`` splits its products: None where
    it computes replicated (no model axis of more than one rank; BERT / ViT
    fine-tuning, whose families are not in ``TP_FAMILIES``, runs one
    device's step on every rank).  The split dimensions: the query heads,
    the MLP's or an expert's inner width, the shared expert's and the
    padded vocabulary; for a Mamba2 stack (``ssm``, ``hybrid``) its SSD
    heads and inner width (the hybrid's shared block and whisper's layers
    as the attention stacks').  Raises where the model axis divides one of
    them unevenly, or the kv heads when the ranks' query heads do not each
    read one kv head.  The step shards the sequence as
    ``SEQUENCE_SHARDING`` says when it is called."""
    M = mesh.shape.get("model", 1)
    family = getattr(cfg, "family", None)
    if M == 1 or not (getattr(cfg, "enc_dec", False)
                      or family in TP_FAMILIES):
        return None
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dims = {"the padded vocabulary": -(-cfg.vocab // 256) * 256}
    if family in ("ssm", "hybrid"):
        dims.update(ssm_nheads=cfg.ssm_nheads, d_inner=cfg.d_inner)
    if family != "ssm":
        dims.update(n_heads=H, d_ff=cfg.d_ff)
    if cfg.moe_shared_dff:
        dims["moe_shared_dff"] = cfg.moe_shared_dff
    bad = {k: v for k, v in dims.items() if v % M}
    if family != "ssm" and not bad and KV % M and (H // KV) % (H // M):
        bad["n_kv_heads"] = KV
    if bad:
        raise ValueError(f"{cfg.name}: a model axis of {M} ranks does not "
                         f"split {bad} (tensor-parallel compute)")
    return TensorParallel(M, family == "ssm" or KV % M == 0,
                          SEQUENCE_SHARDING)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

#: (tag, "calls" | "bytes") -> count: every collective this process ran,
#: with the bytes of its result (the gathered or the reduced tensor)
STATS: collections.Counter = collections.Counter()
#: tag -> the bytes of the largest single result under the tag
LARGEST: collections.Counter = collections.Counter()
#: (kind, "calls" | "bytes") -> count, as ``STATS`` by the collective's
#: kind: ``all-reduce``, ``all-gather`` or ``reduce-scatter``
KINDS: collections.Counter = collections.Counter()


#: the active trace recorder (``analysis/walker.py``'s ``Recorder``), told
#: of every collective; None when nothing records
observer = None


def reset_stats() -> None:
    STATS.clear()
    LARGEST.clear()
    KINDS.clear()


def _count(tag: str, t: torch.Tensor, kind: str,
           src: torch.Tensor) -> None:
    """Count one collective of ``kind`` under ``tag``: ``t`` its counted
    result, ``src`` the rank's tensor it was called on."""
    if observer is not None:
        observer.collective(kind, tag, src, t)
    n = t.numel() * t.element_size()
    STATS[(tag, "calls")] += 1
    STATS[(tag, "bytes")] += n
    LARGEST[tag] = max(LARGEST[tag], n)
    KINDS[(kind, "calls")] += 1
    KINDS[(kind, "bytes")] += n


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A copy of ``t`` where the backend moves it: gloo's CUDA collectives
    are not all there (nor for every dtype), so a CUDA payload goes
    through the host, explicitly; NCCL moves CUDA tensors only, so a host
    payload (a generator's state) goes to the rank's card."""
    t = t.detach()
    if mesh.backend == "gloo" and t.is_cuda:
        return t.cpu()
    if mesh.backend == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t.clone()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _dry(t: torch.Tensor, mesh: Mesh) -> bool:
    """True on a dry mesh, whose collectives take ``meta`` tensors only."""
    if mesh.backend != DRY:
        return False
    if t.device.type != "meta":
        raise ValueError(f"a dry mesh's collectives take meta tensors, got "
                         f"one on {t.device}")
    return True


def all_reduce(t: torch.Tensor, op: str, axes, mesh: Mesh, *,
               tag: str = "all_reduce") -> torch.Tensor:
    """SUM or MAX of ``t`` over the ranks along ``axes`` (a new tensor).
    Ring cost per rank: ``2 (n - 1) / n`` of its bytes sent."""
    if _dry(t, mesh):
        buf = torch.empty_like(t)
    else:
        buf = _wire(t, mesh)
        dist.all_reduce(buf, _OPS[op], group=mesh.group(axes))
    _count(tag, buf, "all-reduce", t)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, axes, mesh: Mesh, *,
               tag: str = "all_gather") -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` along ``axes``, in their
    row-major order.  Ring cost per rank: ``(n - 1)`` times its bytes
    sent."""
    if _dry(t, mesh):
        out = t.new_empty((mesh.count(axes),) + tuple(t.shape))
    else:
        src = _wire(t, mesh).contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.count(axes))]
        dist.all_gather(parts, src, group=mesh.group(axes))
        out = torch.stack(parts)
    _count(tag, out, "all-gather", t)
    return out.to(t.device)


def reduce_scatter(t: torch.Tensor, axes, mesh: Mesh, *,
                   tag: str = "reduce_scatter") -> torch.Tensor:
    """The SUM over the ranks along ``axes`` of their blocks ``t[i]``,
    where ``i`` is this rank's row-major index (``t``: ``(n, *block)``):
    the rank's block of the reduced tensor (a new tensor).  Counted with
    the bytes of ``t``, the whole tensor reduced, as ``all_gather`` counts
    its whole result: both send ``(n - 1) / n`` of the counted bytes per
    rank on a ring, an ``all_reduce`` twice that."""
    if _dry(t, mesh):
        src, out = t, t.new_empty(tuple(t.shape[1:]))
    else:
        src = _wire(t, mesh).contiguous()
        out = torch.empty_like(src[0])
        dist.reduce_scatter(out, list(src.unbind(0)), _OPS["sum"],
                            group=mesh.group(axes))
    _count(tag, src, "reduce-scatter", t)
    return out.to(t.device)


def barrier(mesh: Mesh) -> None:
    if mesh.backend != DRY:
        dist.barrier(group=mesh.group(mesh.axis_names))


# ---------------------------------------------------------------------------
# Parameter partition rules
# ---------------------------------------------------------------------------
# (path-suffix regex, preferred spec per dim). "model" entries are checked
# for divisibility; "data" is the FSDP fallback dim.

_RULES = [
    # embeddings / unembedding
    (r"embed$", ("model", "data")),
    (r"lm_head$", ("data", "model")),
    (r"pos_embed$", (None, "data")),
    # attention
    (r"wq$", ("data", "model")),
    (r"wk$", ("data", "model")),
    (r"wv$", ("data", "model")),
    (r"wo$", ("model", "data")),
    (r"b[qkv]$", ("model",)),
    # dense MLP (SwiGLU + gelu variants)
    (r"wg$", ("data", "model")),
    (r"wu$", ("data", "model")),
    (r"wd$", ("model", "data")),
    (r"w1$", ("data", "model")),
    (r"w2$", ("model", "data")),
    (r"b1$", ("model",)),
    (r"b2$", (None,)),
    # MoE: expert weights shard on model only (the data axis is the
    # dispatch buffer's token rows in the reference)
    (r"router$", (None, None)),
    (r"(wg|wu)_e$", (None, None, "model")),
    (r"wd_e$", (None, "model", None)),
    # mamba2
    (r"wz$", ("data", "model")),
    (r"wx$", ("data", "model")),
    (r"wBC$", ("data", None)),
    (r"wdt$", ("data", "model")),
    (r"conv_x$", (None, "model")),
    (r"conv_BC$", (None, None)),
    (r"out_proj$", ("model", "data")),
    (r"norm_g$", ("model",)),
    (r"(A_log|dt_bias|D_skip)$", (None,)),
    # norms and misc small params
    (r"(^|/)g$", (None,)),
    (r"(^|/)b$", (None,)),
    (r"head$", ("data", "model")),
]

def spec_for(path: str, shape, mesh: Mesh, fsdp: bool,
             stacked: bool) -> Spec:
    """The spec of one parameter (``path``: its keys joined by ``/``).
    ``stacked``: a leading layer axis (never sharded)."""
    dims = list(shape)[1:] if stacked else list(shape)
    rule = next((spec for pat, spec in _RULES if re.search(pat, path)),
                (None,) * len(dims))
    out, used = [], set()
    for dim, want in zip(dims, rule):
        take = None
        for cand in (want if isinstance(want, (list, tuple)) else [want]):
            if cand is None or (cand == "data" and not fsdp):
                continue
            if (cand in mesh.axis_names and cand not in used
                    and dim % mesh.shape[cand] == 0):
                take = cand
                break
        out.append(take)
        if take:
            used.add(take)
    # the reference zips the rule with the dims: a rule shorter than the
    # leaf leaves the trailing dims out of the spec (unsharded)
    return tuple([None] + out if stacked else out)


def _map_with_path(fn, tree: Any, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params: Any, mesh: Mesh, *, fsdp: bool) -> Any:
    """A spec per leaf of ``params`` (tensors, or anything with a
    logical ``.shape``)."""
    def one(path, leaf):
        return spec_for(path, leaf.shape, mesh, fsdp,
                        opt_lib.is_stacked(path))
    return _map_with_path(one, params)


def qtensor_pspecs(like: Any, param_specs: Any, mesh: Mesh) -> Any:
    """Specs for a state tree that may hold QTensors: a QTensor node gets
    ``QTensor(m=(None, *spec), exp=(), bits)`` — its planes shard like the
    logical tensor, the exponent vector is the reference's replicated
    ``P()`` (the port keeps each rank's rows of it: ``exp_spec``); other
    leaves keep their parameter's spec."""
    del mesh

    def one(q, spec):
        if not qtensor.is_qtensor(q):
            return spec
        return qtensor.QTensor(m=(None, *spec), exp=(), bits=q.bits)
    return opt_lib.tree_map(one, like, param_specs)


def exp_spec(q: qtensor.QTensor, spec: Spec) -> Spec:
    """How the port stores a sharded QTensor's exponent: a per-slice
    ``(E, 1, ..., 1)`` vector is split like the parameter's leading dim
    (each rank keeps the rows of its planes), one exponent is whole."""
    if q.exp.dim() == 0:
        return ()
    return (spec[0],) + (None,) * (q.exp.dim() - 1)


def _fsdp_dim(spec) -> Optional[int]:
    """Index of the dim sharded over the ``data`` axis, or None."""
    for i, s in enumerate(tuple(spec)):
        names = (s,) if isinstance(s, str) else tuple(s or ())
        if "data" in names:
            return i
    return None


# ---------------------------------------------------------------------------
# Blocks: a rank's part of a logical tensor
# ---------------------------------------------------------------------------

def sharded_axes(spec: Spec, mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in the mesh's order."""
    return mesh.axes(tuple(a for s in spec for a in mesh.axes(s)))


def local_slices(shape, spec: Spec, mesh: Mesh) -> Tuple[slice, ...]:
    """This rank's block of a logical tensor of ``shape``."""
    out = []
    for d, size in enumerate(shape):
        names = mesh.axes(spec[d]) if d < len(spec) else ()
        n = mesh.count(names)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {names}")
        i, step = mesh.index(names), size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def full_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The logical shape of a block of ``shape``."""
    return tuple(d * mesh.count(spec[i] if i < len(spec) else None)
                 for i, d in enumerate(shape))


def map_state(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a state tree (dicts, NamedTuples such as the
    optimizer's ``OptState``) beside a tree of specs; a leaf is a tensor
    or a QTensor (which takes its parameter's spec).  Where ``specs`` is
    None the subtree is replicated and stays as it is."""
    if specs is None:
        return tree
    if isinstance(tree, dict):
        return {k: map_state(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_state(fn, a, b)
                            for a, b in zip(tree, specs)))
    return fn(tree, specs)


def shard(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """Each rank's blocks of a state tree of logical tensors (copies)."""
    def one(x, spec):
        if qtensor.is_qtensor(x):
            es = exp_spec(x, spec)
            return qtensor.QTensor(
                m=x.m[(slice(None),) + local_slices(x.shape, spec,
                                                     mesh)].clone(),
                exp=x.exp[local_slices(x.exp.shape, es, mesh)].clone(),
                bits=x.bits)
        return x[local_slices(x.shape, spec, mesh)].clone()
    return map_state(one, tree, specs)


def unshard(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The logical state tree of a tree of blocks (QTensors: planes and
    per-slice exponents gathered as they are stored)."""
    def one(x, spec):
        if qtensor.is_qtensor(x):
            return qtensor.QTensor(
                m=gather_full(x.m, (None, *spec), mesh, tag="gather_state"),
                exp=gather_full(x.exp, exp_spec(x, spec), mesh,
                                tag="gather_state"),
                bits=x.bits)
        return gather_full(x, spec, mesh, tag="gather_state")
    return map_state(one, tree, specs)


def empty_full(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """Uninitialised logical tensors shaped as a tree of blocks' logical
    tensors (a checkpoint restore's ``like``)."""
    def empty(t, spec):
        return torch.empty(full_shape(t.shape, spec, mesh), dtype=t.dtype,
                           device=t.device)

    def one(x, spec):
        if qtensor.is_qtensor(x):
            return qtensor.QTensor(m=empty(x.m, (None, *spec)),
                                   exp=empty(x.exp, exp_spec(x, spec)),
                                   bits=x.bits)
        return empty(x, spec)
    return map_state(one, tree, specs)


def _assemble(blocks: torch.Tensor, spec: Spec, axes: Tuple[str, ...],
              mesh: Mesh) -> torch.Tensor:
    """The logical tensor from its blocks ``(n, *local)``, ``n`` the
    row-major product over ``axes`` (a group's rank order)."""
    local = tuple(blocks.shape[1:])
    sizes = [mesh.shape[a] for a in axes]
    b = blocks.reshape(tuple(sizes) + local)
    order, full = [], []
    for d, size in enumerate(local):
        names = mesh.axes(spec[d]) if d < len(spec) else ()
        order += [axes.index(a) for a in names] + [len(axes) + d]
        full.append(size * mesh.count(names))
    return b.permute(order).reshape(full)


def gather_full(x: torch.Tensor, spec: Spec, mesh: Mesh, *,
                tag: str = "gather_f32") -> torch.Tensor:
    """The logical tensor of a block: one FP32 ``all_gather`` over the
    axes the spec shards (none: ``x`` itself)."""
    axes = sharded_axes(spec, mesh)
    if not axes:
        return x
    return _assemble(all_gather(x, axes, mesh, tag=tag), spec, axes, mesh)


# ---------------------------------------------------------------------------
# The int8 QTensor parameter gather
# ---------------------------------------------------------------------------

def _without(spec: Spec, keep: Tuple[str, ...]) -> Spec:
    """``spec`` less the axes of ``keep``: what a gather that leaves
    ``keep`` sharded materialises."""
    if not keep:
        return tuple(spec)
    out = []
    for s in spec:
        names = tuple(a for a in ((s,) if isinstance(s, str)
                                  else tuple(s or ())) if a not in keep)
        out.append(names[0] if len(names) == 1 else (names or None))
    return tuple(out)


def _gathered_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh,
                   bits: int) -> torch.Tensor:
    """int8 all-gather of one FSDP leaf over the axes ``spec`` shards.
    Wire format per block: ``L`` int8 limb planes and one int32 step
    exponent (each block of the data x model grid dequantizes against its
    own exponent: no cross-block MAX).  Under tensor-parallel compute
    ``spec`` leaves ``model`` out, so the rank gets its model shard, as
    the reference's output keeps its ``model`` sharding; else the port
    gathers every axis the spec shards, in one gather."""
    axes = sharded_axes(spec, mesh)
    with manual_axes_active(mesh.axis_names):
        t = qtensor.quantize(x, bits)                 # the rank's block
    m = all_gather(t.m, axes, mesh, tag="gather_int8")      # (n, L, *local)
    e = all_gather(t.exp, axes, mesh, tag="gather_int8")    # (n,)
    shards = qtensor.dequantize(qtensor.QTensor(
        m=m.transpose(0, 1), exp=e.reshape((-1,) + (1,) * x.dim()),
        bits=bits))                                          # (n, *local)
    return _assemble(shards, spec, axes, mesh)


class _Gather(torch.autograd.Function):
    """A leaf's logical tensor, or with ``keep`` its shard along those
    axes, from the rank's block (``bits`` 0: FP32; see ``gather_params``).
    Backward: the logical identity, the
    reference's straight-through ``custom_vjp``.  Each rank's cotangent
    is its term of the logical one (the step's loss is the mean of the
    ranks' losses, its backward seeded with 1 / ranks), so the backward
    SUMs the terms over the batch axes and keeps the rank's block: what
    XLA's reduce-scatter does to the reference's cotangent.  Wire cost: an
    ``all_reduce`` and a slice, ``2 (n - 1) / n`` of the leaf's bytes sent
    per rank on a ring, against ``(n - 1) / n`` for a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, spec, mesh, bits, keep=()):
        spec = _without(spec, keep)
        ctx.mesh, ctx.sharded = mesh, bool(sharded_axes(spec, mesh))
        ctx.slices = local_slices(full_shape(x.shape, spec, mesh), spec,
                                  mesh)
        if bits and "data" not in mesh.axis_names:
            # no FSDP axis: the single-host straight-through form
            return qtensor.fake_quant_ste(gather_full(x, spec, mesh), bits)
        if bits and _fsdp_dim(spec) is not None:
            return _gathered_leaf(x, spec, mesh, bits)
        return gather_full(x, spec, mesh) if ctx.sharded else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axes = batch_axes(ctx.mesh)
        if ctx.mesh.count(axes) > 1:
            g = all_reduce(g, "sum", axes, ctx.mesh, tag="grad_sum")
        return (g[ctx.slices].clone() if ctx.sharded else g), None, None, \
            None, None


def gather_params(params: Any, pspecs: Any, mesh: Mesh, bits: int = 0
                  ) -> Any:
    """The logical parameters of the rank's blocks, each leaf through one
    ``_Gather``: with ``bits`` a ``data``-sharded leaf moves as ``bits``-bit
    limb planes and per-block exponents (``4 / L`` times fewer bytes than
    FP32), dequantized per block; a leaf without a ``data`` dim is not
    quantized (the reference passes it through in FP32): gathered in FP32
    where it is ``model``-sharded, itself where replicated.  Without a
    ``data`` axis every leaf takes the straight-through fake-quant."""
    return opt_lib.tree_map(lambda p, s: _Gather.apply(p, s, mesh, bits),
                            params, pspecs)


# ---------------------------------------------------------------------------
# Per-layer gathering: a layer stack's leaves inside the layer loop
# ---------------------------------------------------------------------------

class Stack:
    """A layer stack's leaf as a step's loss sees it: the rank's block
    ``(L, *local)`` (the autograd leaf), its spec, the mesh, and with the
    int8 gather ``packed``: the block's ``bits``-bit limb planes, quantized
    once per step at one exponent (the reference's image,
    ``_gathered_leaf``), and every rank's exponent.  ``unbind(0)`` (what
    ``blocks.unstack`` calls) gives one ``Layer`` a layer;
    ``gather_layer`` turns it into the layer's logical tensor inside the
    layer."""

    def __init__(self, block: torch.Tensor, spec: Spec, mesh: Mesh,
                 packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 bits: int = 0, keep: Tuple[str, ...] = (),
                 tag: str = "gather_layer"):
        self.block, self.spec, self.mesh = block, spec, mesh
        self.packed, self.bits, self.tag = packed, bits, tag
        #: the spec a gather materialises (``keep`` stays sharded)
        self.gspec = _without(spec, keep)

    def unbind(self, dim: int = 0) -> list:
        # one unbind of the layer axis: the block gradient is stacked once
        return [Layer(self, i, x) for i, x in enumerate(self.block.unbind(0))]


class Layer(collections.namedtuple("Layer", "stack index block")):
    """Layer ``index`` of a ``Stack``: ``block`` is its view of the rank's
    block."""


def _pack(block: torch.Tensor, spec: Spec, mesh: Mesh, bits: int,
          tag: str = "gather_layer"):
    """A stacked block's int8 wire form, once per step: its planes at one
    exponent over all its layers (the sync off, as ``_gathered_leaf``) and
    the exponents of every rank along the axes ``spec`` shards (the
    gathered spec: a kept axis does not travel)."""
    with manual_axes_active(mesh.axis_names):
        t = qtensor.quantize(block.detach(), bits)
    e = all_gather(t.exp, sharded_axes(spec, mesh), mesh, tag=tag + "_exp")
    return t.m, e


class _GatherLayer(torch.autograd.Function):
    """One layer's tensor — logical, or its shard along the axes the stack
    keeps — from the rank's block of it: the int8 planes of the layer
    (``Stack.packed``) gathered and dequantized per block, or its FP32
    block gathered where the gathered spec shards it, or the block itself.
    Backward: ``_Gather``'s, for the layer — the SUM over the batch axes,
    the rank's block."""

    @staticmethod
    def forward(ctx, x, stack, i):
        spec, mesh = stack.gspec[1:], stack.mesh
        axes = sharded_axes(spec, mesh)
        ctx.mesh, ctx.sharded = mesh, bool(axes)
        ctx.slices = local_slices(full_shape(x.shape, spec, mesh), spec,
                                  mesh)
        if stack.packed is not None:
            planes, e = stack.packed
            m = all_gather(planes[:, i], axes, mesh,
                           tag=stack.tag + "_int8")  # (n, limbs, *local)
            shards = qtensor.dequantize(qtensor.QTensor(
                m=m.transpose(0, 1), exp=e.reshape((-1,) + (1,) * x.dim()),
                bits=stack.bits))
            return _assemble(shards, spec, axes, mesh)
        if axes:
            return gather_full(x, spec, mesh, tag=stack.tag + "_f32")
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axes = batch_axes(ctx.mesh)
        if ctx.mesh.count(axes) > 1:
            g = all_reduce(g, "sum", axes, ctx.mesh, tag="grad_sum_layer")
        return (g[ctx.slices].clone() if ctx.sharded else g), None, None


def gather_layer(tree: Any) -> Any:
    """One layer's params as the layer computes with them: each ``Layer``
    of a ``Stack`` its logical tensor (``_GatherLayer``), every tensor as
    it is (one device, or a whole-model image: nothing to do).  The models
    call it inside the function their remat checkpoints, so the recompute
    gathers again and nothing gathered outlives the layer."""
    if isinstance(tree, dict):
        return {k: gather_layer(v) for k, v in tree.items()}
    if isinstance(tree, Layer):
        return _GatherLayer.apply(tree.block, tree.stack, tree.index)
    return tree


def layer_view(params: Any, pspecs: Any, mesh: Mesh, bits: int = 0,
               packed: Optional[dict] = None,
               tp: Optional[TensorParallel] = None) -> Any:
    """What a step's loss sees of the rank's blocks: each layer stack's
    leaf a ``Stack`` (gathered a layer at a time, inside the layer), every
    other leaf its logical tensor through ``_Gather`` (``gather_params``).
    ``packed``: a dict the caller keeps for one step, where a stack's int8
    wire form is made at its first use and found by every later
    microbatch.  Without a ``data`` axis ``bits`` takes the straight-through
    form over whole leaves, so every leaf is gathered whole there.  ``tp``
    (tensor-parallel compute): each leaf is gathered to its model shard,
    a replicated kv leaf and the gated norm's gain whole
    (``TensorParallel.keep``; their stacks' collectives under
    ``gather_layer_kv`` / ``gather_layer_norm``)."""
    leaves, specs = opt_lib.tree_leaves(params), opt_lib.tree_leaves(pspecs)
    packed = {} if packed is None else packed
    out = []
    for i, (path, p, spec) in enumerate(zip(opt_lib.tree_paths(params),
                                            leaves, specs)):
        keep = tp.keep(path) if tp is not None else ()
        if not opt_lib.is_stacked(path) or (
                bits and "data" not in mesh.axis_names):
            out.append(_Gather.apply(p, spec, mesh, bits, keep))
            continue
        tag = (tp.whole_tag(path) if tp is not None and not keep
               and "model" in sharded_axes(spec, mesh) else "gather_layer")
        if bits and _fsdp_dim(spec) is not None and i not in packed:
            packed[i] = _pack(p, _without(spec, keep), mesh, bits, tag)
        out.append(Stack(p, spec, mesh, packed.get(i), bits, keep, tag))
    return opt_lib.tree_unflatten(params, out)


def quantized_all_gather(params: Any, mesh: Mesh, *, bits: int,
                         pspecs: Any = None) -> Any:
    """``gather_params`` at ``bits``: the reference's int8 FSDP gather.
    Gradients pass straight through (``_Gather``).  ``pspecs``: the
    leaves' specs (the port's parameters are the rank's blocks, whose
    logical shapes it cannot infer)."""
    if pspecs is None:
        raise TypeError("quantized_all_gather needs the blocks' pspecs")
    return gather_params(params, pspecs, mesh, bits)


# ---------------------------------------------------------------------------
# Serving under a mesh: the decode cache's layout and the serving step
# ---------------------------------------------------------------------------

#: a cache spec's entry for the kv head axis where the model axis does not
#: split the kv heads whole: the rank keeps the one kv head its query heads
#: read (``blocks.replicated_kv_head``), not an even block
KV_HEAD = "kv_head"


def kv_head_index(cfg: Any, mesh: Mesh) -> int:
    """The kv head the rank's ``H / M`` query heads read under the kv
    replication (``blocks.replicated_kv_head`` at this mesh's model
    index)."""
    H, M = cfg.n_heads, mesh.count("model")
    return mesh.index("model") * (H // M) // (H // cfg.n_kv_heads)


def cache_pspecs(cache: Dict[str, Any], mesh: Mesh, cfg: Any) -> Dict[str,
                                                                      Spec]:
    """The spec of each decode-cache leaf (the counterpart of the
    reference's ``dryrun._cache_shardings`` / ``lm._constrain_cache``):

    * ``k`` / ``v`` (L, B, S, KV, hd): the batch over the batch axes, the
      **kv heads** over ``model``, or, where the model axis does not split
      them whole, ``KV_HEAD``: the rank's one head.  The reference splits
      ``hd`` over ``model`` instead (kv counts like 8 do not divide a
      16-way axis; ``hd`` does).  The port's tensor-parallel attention
      gives each rank whole heads (``models/blocks.py``), so a cache split
      on ``hd`` would need an all-to-all of the whole cache every step;
      the rank's heads are what it computes with.  Where KV < M that
      cache is ``M / KV`` times the reference's per rank.
    * ``ssm`` (L, B, H, P, N): the SSD heads over ``model``.
    * ``conv_x`` (L, B, K-1, DI): the channels over ``model``.
    * ``conv_BC`` (L, B, K-1, 2N): whole over ``model`` (the reference
      splits its channels): the port's split Mamba2 layer projects and
      convolves B / C whole on every rank (``models/ssm.py``).
    * ``index``: the per-row (B,) positions as the rank's rows (the
      reference replicates the vector and each device reads its rows);
      the enc-dec's scalar whole.

    A dim the named axes do not divide stays whole, as in the reference's
    ``clean`` loop (a batch of 1 is every rank's)."""
    batch = batch_axes(mesh)
    tp = tensor_parallel(cfg, mesh)
    heads = "model" if tp is None or tp.kv_split else KV_HEAD
    raw = {"k": (None, batch, None, heads, None),
           "v": (None, batch, None, heads, None),
           "ssm": (None, batch, "model", None, None),
           "conv_x": (None, batch, None, "model"),
           "conv_BC": (None, batch, None, None),
           "index": (batch,)}

    def clean(name, leaf):
        if leaf.dim() == 0:
            return ()
        out = []
        for dim, want in zip(leaf.shape, raw[name]):
            if want == KV_HEAD:
                out.append(want)
                continue
            names = mesh.axes(want)
            out.append((names[0] if len(names) == 1 else names)
                       if names and dim % mesh.count(names) == 0 else None)
        return tuple(out)
    return {name: clean(name, leaf) for name, leaf in cache.items()}


def cache_slices(shape, spec: Spec, mesh: Mesh, cfg: Any
                 ) -> Tuple[slice, ...]:
    """The rank's block of a logical cache leaf of ``shape``: its
    ``local_slices``, the kv head axis at ``KV_HEAD`` the one head
    ``kv_head_index`` names."""
    out = list(local_slices(shape, tuple(None if s == KV_HEAD else s
                                         for s in spec), mesh))
    for d, s in enumerate(spec):
        if s == KV_HEAD:
            h = kv_head_index(cfg, mesh)
            out[d] = slice(h, h + 1)
    return tuple(out)


def cache_block_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of the rank's block of a cache leaf of ``shape``."""
    return tuple(1 if s == KV_HEAD else d // mesh.count(s)
                 for d, s in zip(shape, tuple(spec) + (None,) * len(shape)))


def cache_zeros(like: Dict[str, Any], mesh: Mesh, cfg: Any,
                device) -> Dict[str, torch.Tensor]:
    """The rank's cache: zeros of the block of each leaf of the logical
    cache ``like`` (meta tensors), on ``device``."""
    specs = cache_pspecs(like, mesh, cfg)
    return {k: torch.zeros(cache_block_shape(v.shape, specs[k], mesh),
                           dtype=v.dtype, device=device)
            for k, v in like.items()}


def serve_blocks(params: Any, like: Any, mesh: Mesh) -> Tuple[Any, Any]:
    """``(blocks, specs)`` of the parameters a server holds on ``mesh``:
    ``params`` as given where they are the rank's blocks under the rules
    without FSDP or with it (``param_pspecs``), or, where they are the
    logical tensors (``like``'s shapes: every rank holds them whole), the
    rank's blocks of them under the rules without FSDP."""
    for fsdp in (False, True):
        specs = param_pspecs(like, mesh, fsdp=fsdp)
        shapes = [tuple(local_slices(l.shape, sp, mesh))
                  for l, sp in zip(opt_lib.tree_leaves(like),
                                   opt_lib.tree_leaves(specs))]
        if all(tuple(p.shape) == tuple(s.stop - s.start for s in sl)
               for p, sl in zip(opt_lib.tree_leaves(params), shapes)):
            return params, specs
    if all(tuple(p.shape) == tuple(l.shape) for p, l in zip(
            opt_lib.tree_leaves(params), opt_lib.tree_leaves(like))):
        specs = param_pspecs(like, mesh, fsdp=False)
        return shard(params, specs, mesh), specs
    raise ValueError("the parameters are neither the logical tensors nor "
                     "the rank's blocks of them on this mesh")


class Serving:
    """A prefill or decode step of ``cfg`` on ``mesh`` over a batch of
    ``batch`` rows, the reference's serving layout: the parameters the
    rank's blocks (``pspecs``), gathered as a training step gathers them
    (``view``: ``layer_view``, a layer stack's leaves a layer at a time
    inside the layer, to their model shards under tensor-parallel
    compute); the rows split over the batch axes where they divide
    ``batch`` (``rows``), else whole on every rank; the cache the rank's
    (``cache_pspecs``); every product split over the model group as a
    training step splits it (``tensor_parallel``), a stream the group
    divides sequence-sharded (``SEQUENCE_SHARDING``); the logits the
    rank's rows and vocabulary columns, ``logits`` the whole ones."""

    def __init__(self, mesh: Mesh, pspecs: Any, cfg: Any, batch: int):
        self.mesh, self.pspecs, self.cfg = mesh, pspecs, cfg
        self.tp = tensor_parallel(cfg, mesh)
        axes = mesh.axes(batch_axes(mesh))
        self.batch = axes if batch % mesh.count(axes) == 0 else ()

    def view(self, params: Any) -> Any:
        return layer_view(params, self.pspecs, self.mesh, tp=self.tp)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``t`` (dim 0 the batch)."""
        n, i = self.mesh.count(self.batch), self.mesh.index(self.batch)
        step = t.shape[0] // n
        return t[i * step:(i + 1) * step]

    def logits(self, z: torch.Tensor) -> torch.Tensor:
        """The whole (B, S, V) logits on every rank from the rank's rows
        and vocabulary columns: gathered over ``model`` (tag
        ``serve_logits``), then over the batch axes (tag ``serve_rows``)."""
        if self.tp is not None:
            parts = all_gather(z.contiguous(), "model", self.mesh,
                               tag="serve_logits")
            z = parts.movedim(0, -2).reshape(tuple(z.shape[:-1]) + (-1,))
        if self.mesh.count(self.batch) > 1:
            z = all_gather(z.contiguous(), self.batch, self.mesh,
                           tag="serve_rows").flatten(0, 1)
        return z


@contextlib.contextmanager
def serving(mesh: Mesh, pspecs: Any, cfg: Any, batch: int):
    """The body of a prefill or decode step over ``mesh`` (``Serving``):
    every per-tensor exponent the logical batch's (``spmd`` over the axes
    the rows are split over), every product split over the model group.
    Yields the ``Serving``; the entry points (``lm.lm_prefill``,
    ``lm_prefill_cache``, ``lm_decode_step``, ``encdec.encode``,
    ``encdec_precompute_cross``, ``encdec_decode_step``) take its
    ``view`` of the rank's blocks, its ``rows`` of the batch and the
    rank's cache (``lm.init_cache(..., mesh=)``)."""
    s = Serving(mesh, pspecs, cfg, batch)
    with spmd(mesh, axes=s.batch, split=s.tp is not None,
              sequence=s.tp is not None and s.tp.sequence):
        yield s
