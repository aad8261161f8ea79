"""Dry-run of every (arch x input-shape) cell: one rank's step of the
production mesh, run on the ``meta`` device, with no card and no world.

Counterpart of ``repro/launch/dryrun.py``.  For every cell:

    mesh     = rank 0 of the 16 x 16 or 2 x 16 x 16 mesh (sharding.dry_mesh)
    fn, args = build_cell(...)        # the rank's arguments, meta tensors
    fn(*args) under a tracker         # the rank's real call sequence
    record   memory, matmul flops, collective bytes, kernel calls

The reference lowers and compiles each cell with XLA; the port runs it.
Every tensor is a ``meta`` tensor (shape and dtype, no storage), the
collectives are the dry mesh's (``sharding.all_reduce`` & co. return meta
tensors of the shapes the group's would, counted in ``sharding.STATS``
by tag) and every kernel wrapper takes its shape-only path (it allocates
what its CUDA launch allocates and counts the call and its integer
products' flops, ``kernels/_lib.py``).  A ``TorchDispatchMode``
(``LiveBytes``) sees every op: it counts each storage once, from the op
that makes it to its release, and the flops of every FP32 product
(``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm``).  So a record is what
the rank holds and runs, forward, backward and recompute, at full depth
(the port's layer loops are Python loops: the reference's loop-once
extrapolation is not needed).

A record's keys are the reference's, ``trace_s`` in place of ``lower_s``
/ ``compile_s``:

* ``memory``: ``argument_bytes_per_device`` (the rank's parameter blocks,
  optimizer state and batch rows; a decode cell's cache), ``output_bytes_
  per_device``, ``temp_bytes_per_device`` (the peak of live bytes less the
  arguments) and ``alias_bytes_per_device`` (what the step updates in
  place, as XLA's donation aliases it); these are predictions of the
  port's allocations (``torch.cuda.max_memory_allocated`` on a card is
  held against them by ``chip_smoke.py`` phase 16), not times;
* ``cost``: ``flops`` (the kernel wrappers' integer products plus the
  FP32 ones, 2 x output elements x contraction a product) and its two
  parts ``int_flops`` / ``fp32_flops``;
* ``collectives``: bytes by kind (the reference's names), ``total``, and
  ``by_tag`` (``sharding.STATS``: calls and bytes);
* ``launches``: the kernel wrappers' calls by name;
* ``model_params``, ``active_params``, ``status``, ``trace_s``.

A prefill or decode cell runs one rank's step under ``sharding.serving``
as the reference lays it out: the parameters by ``param_pspecs(fsdp=
registry.use_fsdp(arch))``, the batch over the batch axes where they
divide it (else whole on every rank, the reference's ``_batch_sharding``),
the decode cache by ``sharding.cache_pspecs`` (the rank's kv heads where
the reference splits ``hd``; its docstring says why), the enc-dec's cross
K/V the rank's rows and kv heads, every product split over ``model``; the
rank's logits are its rows and vocabulary columns.  A cell whose model
axis splits a head records ``not_ported`` (``UNEVEN_HEADS``), a serving
cell too.

Not ported: ``collective_bytes``, ``dot_flops``, ``extrapolated_costs``
and ``analysis_configs`` (XLA's HLO text parsers and its loop-once
workaround; the trace counts each call directly).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells, both meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod-only
Results land in experiments/dryrun/<mesh>/<arch>__<shape>[__variant].json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import sharding, utils
from repro_torch.configs import registry
from repro_torch.core.qconfig import QuantConfig
from repro_torch.core.qpolicy import PolicyScopeError
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, lm
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer

#: the reference's collective kinds; the port's collectives are the first
#: three (``sharding.KINDS``)
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: the reason a cell whose model axis splits a head records
UNEVEN_HEADS = ("the port's tensor-parallel compute gives each model rank "
                "whole heads (GSPMD splits a head's columns): ROADMAP §1 "
                "item 15, uneven head splits")


# ---------------------------------------------------------------------------
# The tracker
# ---------------------------------------------------------------------------

def _tensors(tree: Any):
    """Every tensor in ``tree`` (dicts, lists, tuples and NamedTuples such
    as ``OptState`` or ``QTensor``)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storages(tree: Any) -> dict:
    """``{storage key: bytes}`` of every tensor in ``tree``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree)}


_MM = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_BMM = {torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


class LiveBytes(TorchDispatchMode):
    """Every storage an op makes, counted once from the op to its release
    (a weak reference on the storage), the peak of the live bytes, and the
    FP32 products' flops.  ``hold(tree)`` counts storages made before the
    mode (the arguments) as live."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self.now = self.peak = 0
        self.fp32_flops = 0

    def hold(self, tree: Any) -> None:
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live or st.nbytes() == 0:
            return
        self.live[key] = st.nbytes()
        self.now += st.nbytes()
        self.peak = max(self.peak, self.now)
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)
        self._refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MM or func in _BMM:
            a, b = (args[1], args[2]) if func in (
                torch.ops.aten.addmm.default,
                torch.ops.aten.baddbmm.default) else args[:2]
            self.fp32_flops += 2 * out.numel() * a.shape[-1]
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One rank's entry point of a cell: ``fn(*args)``, the argument
    positions it updates in place (``donate``, as the reference's
    ``donate_argnums``), and the rank's share of the batch (``rows``: what
    the argument bytes count of it; the port hands every rank the global
    batch, the reference each device its rows)."""
    fn: Any
    args: tuple
    donate: tuple
    rows: Any = None
    batch_at: Optional[int] = None


def _batch(specs: dict, batch) -> dict:
    """The train / prefill batch of ``specs`` (meta tensors), or at
    ``batch`` = (rows, seq) instead of the shape's (a VLM's text is the
    sequence less its prefix, as the reference's)."""
    if batch is None:
        return specs
    B, S = batch
    out = {}
    for k, v in specs.items():
        shape = (B,) + tuple(v.shape[1:])
        if k in ("tokens", "labels", "frames"):
            shape = (B, S) + tuple(v.shape[2:])
        out[k] = torch.empty(shape, dtype=v.dtype, device="meta")
    return out


def build_cell(arch: str, shape: str, mesh: sharding.Mesh, qcfg,
               cfg=None, *, batch=None, opt_cfg=None, train_cfg=None,
               fsdp: Optional[bool] = None) -> Cell:
    """The rank's entry point of the cell and its arguments, meta tensors.

    train: ``trainer.make_train_step`` -> ``jit_train_step`` over
    ``sharding.param_pspecs(..., fsdp=registry.use_fsdp(arch))``, with the
    rank's blocks, their optimizer state (``opt_cfg``, default
    ``OptimizerConfig()``), the global batch and a CPU generator (the
    draws land on ``meta``).  prefill: ``lm_prefill`` (enc-dec: ``encode``
    + ``encdec_precompute_cross``).  decode: ``lm_decode_step`` over the
    rank's bfloat16 cache (enc-dec: ``encdec_decode_step`` over the
    rank's bfloat16 cache and cross K/V).  Both under ``sharding.serving``
    with the rank's blocks under the same specs, the global batch handed
    in (the rank takes its rows).  ``cfg`` / ``batch`` (rows, seq) /
    ``train_cfg`` / ``fsdp`` override the arch's, the shape's,
    ``TrainConfig()`` and ``registry.use_fsdp(arch)``."""
    cfg = cfg or registry.get_config(arch)
    S, B, kind = SHAPES[shape]
    init_fn, loss_fn = ((encdec.encdec_init, encdec.encdec_loss)
                        if cfg.enc_dec else (lm.lm_init, lm.lm_loss))
    gen = torch.Generator().manual_seed(0)
    specs_in = registry.input_specs(cfg, shape)

    if kind == "train":
        opt_cfg = opt_cfg or opt_lib.OptimizerConfig()
        step = trainer.make_train_step(loss_fn, cfg, qcfg, opt_cfg,
                                       train_cfg or trainer.TrainConfig())
        params, opt, pspecs = trainer.init_train_state(
            lambda g: init_fn(g, cfg, device="meta"), gen, mesh,
            fsdp=registry.use_fsdp(arch) if fsdp is None else fsdp,
            opt_cfg=opt_cfg)
        fn = trainer.jit_train_step(step, mesh, pspecs)
        b = _batch(specs_in, batch)
        rows = trainer.local_rows(b, mesh, step.train_cfg.microbatches)
        return Cell(fn, (params, opt, b, gen), (0, 1), rows, 2)

    logical = init_fn(gen, cfg, device="meta")
    pspecs = sharding.param_pspecs(
        logical, mesh, fsdp=registry.use_fsdp(arch) if fsdp is None else fsdp)
    params = sharding.shard(logical, pspecs, mesh)
    del logical

    def serving(rows: int):
        return sharding.serving(mesh, pspecs, cfg, rows)

    if kind == "prefill":
        b = _batch(specs_in, batch)
        B = next(iter(b.values())).shape[0]
        if cfg.enc_dec:
            def fn(params, batch):
                with torch.no_grad(), serving(B) as s:
                    view = s.view(params)
                    enc = encdec.encode(view, s.rows(batch["frames"]), cfg,
                                        qcfg, None)
                    return enc, encdec.encdec_precompute_cross(
                        view, enc, cfg, qcfg)
        else:
            def fn(params, batch):
                pe = batch.get("patch_embeds")
                with torch.no_grad(), serving(B) as s:
                    return lm.lm_prefill(
                        s.view(params), s.rows(batch["tokens"]), cfg, qcfg,
                        prefix_embeds=None if pe is None else s.rows(pe))[0]
        rows = sharding.Serving(mesh, pspecs, cfg, B)
        return Cell(fn, (params, b), (), {k: rows.rows(v)
                                          for k, v in b.items()}, 1)

    # decode: the rank's cache (and the enc-dec's cross K/V, laid out as
    # the cache's k)
    token = specs_in["token"]
    B = token.shape[0]
    cspecs = sharding.cache_pspecs(specs_in["cache"], mesh, cfg)

    def block(t, spec):
        return t[sharding.cache_slices(t.shape, spec, mesh, cfg)].clone()
    cache = {k: block(v, cspecs[k]) for k, v in specs_in["cache"].items()}
    if cfg.enc_dec:
        cross = tuple(block(t, cspecs["k"]) for t in specs_in["cross_kv"])

        def fn(params, token, cache, cross):
            with torch.no_grad(), serving(B) as s:
                return encdec.encdec_decode_step(s.view(params),
                                                 s.rows(token), cache, cross,
                                                 cfg, qcfg)
        args = (params, token, cache, cross)
    else:
        def fn(params, token, cache):
            with torch.no_grad(), serving(B) as s:
                return lm.lm_decode_step(s.view(params), s.rows(token), cache,
                                         cfg, qcfg)
        args = (params, token, cache)
    rows = sharding.Serving(mesh, pspecs, cfg, B).rows(token)
    return Cell(fn, args, (2,), rows, 1)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

VARIANTS = ("baseline", "remat_dots", "no_sp", "q_gather",
            "remat_dots+q_gather")


def _apply_variant(variant: str):
    """Flip the knobs of ``variant``; returns ``(restore, train_cfg)``:
    ``remat_dots`` sets ``utils.CHECKPOINT_POLICY = "dots"``, ``no_sp``
    ``sharding.SEQUENCE_SHARDING = False``, ``q_gather`` the int8
    parameter gather (``TrainConfig.gather_bits = 8``, the counterpart of
    the reference's ``QUANTIZED_WEIGHT_GATHER``)."""
    parts = variant.split("+")
    unknown = set(parts) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variant part(s) {sorted(unknown)}")
    prev = (utils.CHECKPOINT_POLICY, sharding.SEQUENCE_SHARDING)
    if "remat_dots" in parts:
        utils.CHECKPOINT_POLICY = "dots"
    if "no_sp" in parts:
        sharding.SEQUENCE_SHARDING = False
    tcfg = trainer.TrainConfig(gather_bits=8 if "q_gather" in parts else 0)

    def restore():
        utils.CHECKPOINT_POLICY, sharding.SEQUENCE_SHARDING = prev

    return restore, tcfg


def _bytes(tree: Any) -> int:
    return sum(_storages(tree).values())


def trace(cell: Cell) -> Dict[str, Any]:
    """Run ``cell`` once under the tracker: memory, cost, collectives and
    kernel calls of one rank."""
    args = cell.args
    held = _storages(args)
    rows = cell.rows if cell.batch_at is not None else None
    rest = [a for i, a in enumerate(args) if i != cell.batch_at]
    arguments = _bytes(rest) + (0 if rows is None else sum(
        t.numel() * t.element_size() for t in _tensors(rows)))
    sharding.reset_stats()
    _lib.reset_dry()
    mode = LiveBytes()
    mode.hold(args)
    base = mode.now
    with mode:
        out = cell.fn(*args)
    outs = _storages(out)
    donated = _storages([args[i] for i in cell.donate])
    kinds = {k: sharding.KINDS[(k, "bytes")] for k in _COLLECTIVES}
    kinds["total"] = sum(kinds.values())
    by_tag: Dict[str, Dict[str, int]] = {}
    for (tag, what), v in sorted(sharding.STATS.items()):
        by_tag.setdefault(tag, {})[what] = int(v)
    int_flops = sum(_lib.DRY_FLOPS.values())
    return {
        "memory": {
            "argument_bytes_per_device": arguments,
            "output_bytes_per_device": sum(outs.values()),
            "temp_bytes_per_device": mode.peak - base,
            "alias_bytes_per_device": sum(
                n for k, n in outs.items() if k in donated and k in held),
        },
        "cost": {"flops": int_flops + mode.fp32_flops,
                 "int_flops": int_flops, "fp32_flops": mode.fp32_flops},
        "collectives": {**kinds, "by_tag": by_tag,
                        "calls": {k: sharding.KINDS[(k, "calls")]
                                  for k in _COLLECTIVES}},
        "launches": dict(sorted(_lib.DRY_CALLS.items())),
    }


def run_cell(arch: str, shape: str, mesh: sharding.Mesh, mesh_name: str,
             qcfg, outdir: Optional[str], variant: str = "baseline", *,
             cfg=None, batch=None, opt_cfg=None,
             fsdp: Optional[bool] = None) -> Dict[str, Any]:
    """Trace one cell (``build_cell``'s overrides: ``cfg``, ``batch``,
    ``opt_cfg``, ``fsdp``) and write its record under ``outdir`` (None:
    return it only).  A cell the skip rule or the quantization policy
    leaves out is ``skipped``; a cell whose model axis splits a head is
    ``not_ported``; a failure is an ``error`` (the sweep goes on)."""
    cfg = cfg or registry.get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "quant": dataclass_dict(qcfg), "variant": variant}
    if not ok:
        rec.update(status="skipped", reason=why)
        return _write(rec, outdir)
    try:
        sharding.tensor_parallel(cfg, mesh)
    except ValueError as e:
        rec.update(status="not_ported", reason=f"{e}: {UNEVEN_HEADS}")
        return _write(rec, outdir)
    t0 = time.time()
    restore_variant, tcfg = _apply_variant(variant)
    try:
        cell = build_cell(arch, shape, mesh, qcfg, cfg, batch=batch,
                          opt_cfg=opt_cfg, train_cfg=tcfg, fsdp=fsdp)
        got = trace(cell)
        rec.update(status="ok", trace_s=round(time.time() - t0, 2), **got,
                   model_params=cfg.param_count(),
                   active_params=cfg.active_param_count())
    except PolicyScopeError as e:
        # documented (policy x arch) incompatibility, not a failure
        rec.update(status="skipped", reason=str(e))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    finally:
        restore_variant()
    return _write(rec, outdir)


def dataclass_dict(qcfg) -> Dict[str, Any]:
    if isinstance(qcfg, QuantConfig):
        return dataclasses.asdict(qcfg)
    return json.loads(qcfg.to_json())          # QuantPolicy


def _path(outdir: str, arch: str, shape: str, variant: str) -> str:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(outdir, f"{arch}__{shape}{suffix}.json")


def _write(rec: Dict[str, Any], outdir: Optional[str]) -> Dict[str, Any]:
    if outdir is None:
        return rec
    os.makedirs(outdir, exist_ok=True)
    with open(_path(outdir, rec["arch"], rec["shape"],
                    rec.get("variant", "baseline")), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(registry.ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--quant", default="int8",
                    choices=list(registry.quant_ids()))
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--analysis-only", action="store_true",
                    help="recompute the cost / collective / launch fields "
                         "of existing ok JSONs that have a cost (the port "
                         "traces the cell again: one trace gives every "
                         "field)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists with status "
                         "ok / skipped / not_ported")
    args = ap.parse_args(argv)

    qcfg = registry.get_quant(args.quant)
    archs = [args.arch] if args.arch else list(registry.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(("pod16x16", make_production_mesh(dry=True)))
    if not args.single_pod_only:
        meshes.append(("pods2x16x16",
                       make_production_mesh(multi_pod=True, dry=True)))

    n = dict.fromkeys(("ok", "skipped", "not_ported", "error"), 0)
    for mesh_name, mesh in meshes:
        outdir = os.path.join(args.outdir, mesh_name)
        for arch in archs:
            for shape in shapes:
                pre = _path(outdir, arch, shape, args.variant)
                old = (json.load(open(pre)) if os.path.exists(pre)
                       else None)
                if args.analysis_only:
                    if (old is None or old.get("status") != "ok"
                            or old.get("cost") is None):
                        continue
                    rec = run_cell(arch, shape, mesh, mesh_name, qcfg, None,
                                   args.variant)
                    if rec["status"] != "ok":
                        print(f"[{mesh_name}] {arch:24s} {shape:12s} "
                              f"REANALYSIS ERROR {rec.get('error')}",
                              flush=True)
                        n["error"] += 1
                        continue
                    for k in ("cost", "collectives", "launches"):
                        old[k] = rec[k]
                    _write(old, outdir)
                    print(f"[{mesh_name}] {arch:24s} {shape:12s} reanalyzed "
                          f"flops/dev={old['cost']['flops']:.3g}", flush=True)
                    n["ok"] += 1
                    continue
                if args.resume and old is not None and old.get("status") in (
                        "ok", "skipped", "not_ported"):
                    print(f"[{mesh_name}] {arch:24s} {shape:12s} cached",
                          flush=True)
                    n[old["status"]] += 1
                    continue
                rec = run_cell(arch, shape, mesh, mesh_name, qcfg, outdir,
                               args.variant)
                tag = rec["status"]
                n[tag] += 1
                extra = ""
                if tag == "ok":
                    mem = rec["memory"]
                    extra = (f"trace={rec['trace_s']}s "
                             f"flops/dev={rec['cost']['flops']:.3g} "
                             f"coll={rec['collectives']['total']:.3g}B "
                             f"peak={(mem['argument_bytes_per_device'] + mem['temp_bytes_per_device']) / 2**30:.2f}GiB")
                elif tag == "error":
                    extra = rec["error"][:120]
                print(f"[{mesh_name}] {arch:24s} {shape:12s} {tag:10s} "
                      f"{extra}", flush=True)
    print(f"done: ok={n['ok']} skipped={n['skipped']} "
          f"not_ported={n['not_ported']} errors={n['error']}")
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
