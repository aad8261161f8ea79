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

Activations, int8 planes and the moments are left out; the FP32 moments
(two a parameter, on the blocks) are printed beside.

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


if __name__ == "__main__":
    main()
