"""The FP32 parameter and gradient bytes a rank holds during a training
step over a mesh, with every leaf gathered whole before the forward and
with each layer stack gathered one layer at a time inside the layer loop
(``sharding.layer_view``), and under split compute, for every arch of
``registry.FSDP_ARCHS`` at full size: from the partition rules
(``sharding.param_pspecs``) at the logical shapes, on meta tensors
(nothing is allocated).

* whole model: every leaf's logical image and gradient, plus the rank's
  blocks and their gradients;
* per layer: the non-stacked leaves' images and gradients, the largest
  layer's (all its stack leaves), plus the blocks and their gradients;
* split compute: the same, each leaf gathered over ``data`` only to the
  rank's ``model`` shard where the arch's products split over the model
  axis (``sharding.tensor_parallel``: every training stack; a replicated
  kv leaf and the Mamba2 gated norm's gain whole), as the port's step
  does.

Int8 planes are left out; the FP32 moments (two a parameter, on the
blocks) are printed beside.  A second table gives the FP32 activations a
rank holds in a step (``activations``) at a per-rank batch of 8 rows of
``ROW_TOKENS`` tokens (the VLM's patch prefix in front; whisper's encoder
over its 1500 frames), with the residual stream whole on every model rank
and sequence-sharded (``sharding.SEQUENCE_SHARDING``): each layer's input,
which its remat checkpoint keeps, and one layer's residual, norm input and
norm output, in the recompute.

These figures are counted by hand from the rules.  The dry-run
(``python -m repro_torch.launch.dryrun``) runs the step itself for one
rank on meta tensors and reports what that rank holds at its peak and
the collectives it runs; ``chip_smoke.py`` phase 16 holds its prediction
against the card.

    PYTHONPATH=src python tools/fsdp_footprint.py
"""
import functools

import torch

from repro_torch import sharding
from repro_torch.configs import registry
from repro_torch.launch import train as launch_train
from repro_torch.train import optimizer as opt_lib

MESHES = {"data 8": ((8, 1), ("data", "model")),
          "16 x 16": ((16, 16), ("data", "model"))}


def _meta(fn):
    @functools.wraps(fn)
    def on_meta(*args, generator=None, device=None, **kw):
        return fn(*args, device="meta", **kw)
    return on_meta


def logical_params(arch: str) -> dict:
    """The arch's parameter tree as meta tensors of the logical shapes."""
    cfg = registry.get_config(arch)
    saved = torch.randn, torch.rand
    torch.randn, torch.rand = _meta(torch.randn), _meta(torch.rand)
    try:
        return launch_train._model(cfg)[0](torch.Generator(), cfg,
                                           device="meta")
    finally:
        torch.randn, torch.rand = saved


def footprint(params: dict, cfg, shape, names) -> dict:
    """GB a rank holds: whole-model, per-layer and under split compute,
    and its FP32 moments; ``raises`` where the model axis does not split
    the arch (its split compute then as per layer)."""
    mesh = sharding.Mesh(shape, names)
    specs = sharding.param_pspecs(params, mesh, fsdp=True)
    try:
        tp, raises = sharding.tensor_parallel(cfg, mesh), False
    except ValueError:
        tp, raises = None, True
    total = whole = local = whole_tp = 0
    layer, layer_tp = {}, {}
    for path, p, spec in zip(opt_lib.tree_paths(params),
                             opt_lib.tree_leaves(params),
                             opt_lib.tree_leaves(specs)):
        n = p.numel()
        total += n
        axes = sharding.sharded_axes(spec, mesh)
        local += n // mesh.count(axes)
        # what the gather leaves sharded: the model shard under tp
        kept = n // mesh.count(tuple(a for a in axes if tp is not None
                                     and a in tp.keep(path)))
        if opt_lib.is_stacked(path):
            stack = path.split("/")[0]
            layer[stack] = layer.get(stack, 0) + n // p.shape[0]
            layer_tp[stack] = layer_tp.get(stack, 0) + kept // p.shape[0]
        else:
            whole += n
            whole_tp += kept
    gb = 2 * 4 / 1e9                    # an image and a gradient, f32
    return {"params": total, "raises": raises,
            "before": gb * (total + local),
            "after": gb * (whole + max(layer.values()) + local),
            "split": gb * (whole_tp + max(layer_tp.values()) + local),
            "layer": max(layer.values()), "whole": whole,
            "layer_tp": max(layer_tp.values()), "whole_tp": whole_tp,
            "moments": gb * local}


#: where the arch's split dimensions do not divide over 16 model ranks
#: (whisper's 20 heads: ``tensor_parallel`` raises), its split compute on
#: the 256 ranks as 64 x 4
FALLBACK = ((64, 4), ("data", "model"))


#: the per-rank batch of the activation table: rows, tokens a row, and
#: whisper's encoder frames a row (30 s of audio)
ROWS, ROW_TOKENS, ENC_FRAMES = 8, 256, 1500
#: the tensors of the stream's width one layer holds beside the
#: checkpoints: its residual, a norm's input and its output
LAYER_TENSORS = 3


def _streams(cfg) -> list:
    """(layer inputs checkpointed, positions a row) of each residual
    stream of a step of ``cfg``: the decoder-only stack (the hybrid's
    shared block checkpointed at each of its calls), or whisper's encoder
    and decoder."""
    if cfg.enc_dec:
        return [(cfg.n_enc_layers, ENC_FRAMES),
                (cfg.n_layers, ROW_TOKENS)]
    calls = cfg.n_layers // cfg.hybrid_attn_every if (
        cfg.family == "hybrid") else 0
    return [(cfg.n_layers + calls, ROW_TOKENS + cfg.vlm_prefix)]


def activations(cfg, model: int) -> dict:
    """GB of FP32 activations a rank holds in a step of ``cfg`` over a
    model axis of ``model`` ranks: ``ckpt`` the layer inputs, ``layer``
    one layer's ``LAYER_TENSORS``, each whole on every model rank
    (``*_whole``) and sequence-sharded (``*_sp``: a stream whose length
    the axis does not divide stays whole, as in the step)."""
    out = dict.fromkeys(("ckpt_whole", "ckpt_sp", "layer_whole",
                         "layer_sp"), 0.0)
    for layers, S in _streams(cfg):
        t = ROWS * S * cfg.d_model * 4 / 1e9            # one stream tensor
        sp = t / model if S % model == 0 else t
        out["ckpt_whole"] += layers * t
        out["ckpt_sp"] += layers * sp
        out["layer_whole"] = max(out["layer_whole"], LAYER_TENSORS * t)
        out["layer_sp"] = max(out["layer_sp"], LAYER_TENSORS * sp)
    return out


def main() -> None:
    print("| arch | parameters | mesh | whole model GB | per layer GB "
          "(one layer, non-stacked leaves) | split compute GB (the same) | "
          "FP32 moments GB |")
    print("|---|---|---|---|---|---|---|")
    for arch in sorted(registry.FSDP_ARCHS):
        params = logical_params(arch)
        cfg = registry.get_config(arch)
        for label, (shape, names) in MESHES.items():
            f = footprint(params, cfg, shape, names)
            if f["raises"]:
                g = footprint(params, cfg, *FALLBACK)
                f.update({k: g[k] for k in ("split", "layer_tp", "whole_tp")},
                         split_on=" on 64 x 4 (model 16 raises)")
            print(f"| {arch} | {f['params'] / 1e9:.3f} B | {label} | "
                  f"{f['before']:.2f} | {f['after']:.2f} "
                  f"({f['layer'] / 1e9:.3f} B, {f['whole'] / 1e9:.3f} B) | "
                  f"{f['split']:.2f} ({f['layer_tp'] / 1e9:.3f} B, "
                  f"{f['whole_tp'] / 1e9:.3f} B){f.get('split_on', '')} | "
                  f"{f['moments']:.2f} |")
    print()
    print(f"| arch | mesh | layer inputs GB, whole → sequence-sharded | "
          f"+ one layer's {LAYER_TENSORS} GB | total GB |")
    print("|---|---|---|---|---|")
    for arch in sorted(registry.FSDP_ARCHS):
        cfg = registry.get_config(arch)
        for label, (shape, names) in MESHES.items():
            mesh, on = sharding.Mesh(shape, names), ""
            try:
                sharding.tensor_parallel(cfg, mesh)
            except ValueError:
                mesh, on = sharding.Mesh(*FALLBACK), " (on 64 x 4)"
            a = activations(cfg, mesh.shape["model"])
            print(f"| {arch} | {label}{on} | {a['ckpt_whole']:.2f} → "
                  f"{a['ckpt_sp']:.2f} | {a['layer_whole']:.2f} → "
                  f"{a['layer_sp']:.2f} | "
                  f"{a['ckpt_whole'] + a['layer_whole']:.2f} → "
                  f"{a['ckpt_sp'] + a['layer_sp']:.2f} |")


if __name__ == "__main__":
    main()
