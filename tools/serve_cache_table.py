"""The dry-run's serving cells on the production mesh, one rank each: the
argument and peak bytes the trace records, and the rank's decode cache
under the port's layout (``sharding.cache_pspecs``: the kv heads over
``model``, or the one kv head) beside the reference's (``repro/launch/
dryrun.py::_cache_shardings``: ``hd`` over ``model``, the SSM heads and
both conv states' channels over ``model``, ``index`` replicated).

    PYTHONPATH=src python tools/serve_cache_table.py [--multi-pod]

Prints a markdown table (GiB = 2^30 bytes).  Meta tensors only: no card,
~1 minute on a CPU host.
"""
from __future__ import annotations

import argparse
import math

from repro_torch import sharding
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES, shape_applicable

GIB = float(2 ** 30)


def reference_cache_bytes(cache: dict, mesh: sharding.Mesh) -> int:
    """The rank's cache bytes under the reference's ``_cache_shardings``
    (a dim its axes do not divide stays whole)."""
    batch = sharding.batch_axes(mesh)
    raw = {"k": (None, batch, None, None, "model"),
           "v": (None, batch, None, None, "model"),
           "ssm": (None, batch, "model", None, None),
           "conv_x": (None, batch, None, "model"),
           "conv_BC": (None, batch, None, "model")}
    total = 0
    for name, leaf in cache.items():
        shape = list(leaf.shape)
        for d, want in enumerate(raw.get(name, ())):
            n = mesh.count(want)
            if n > 1 and shape[d] % n == 0:
                shape[d] //= n
        total += math.prod(shape) * leaf.element_size()
    return total


def port_cache_bytes(cache: dict, mesh: sharding.Mesh, cfg) -> int:
    specs = sharding.cache_pspecs(cache, mesh, cfg)
    return sum(math.prod(sharding.cache_block_shape(v.shape, specs[k], mesh))
               * v.element_size() for k, v in cache.items())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=args.multi_pod, dry=True)
    q = registry.get_quant("int8")
    print(f"mesh {mesh.shape}, rank 0")
    print("| arch | cell | status | argument GiB | peak GiB | cache GiB "
          "port | cache GiB reference layout | port / reference |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch)
        for shape in SHAPES:
            if SHAPES[shape][2] == "train" or not shape_applicable(
                    cfg, shape)[0]:
                continue
            rec = dryrun.run_cell(arch, shape, mesh, "prod", q, None)
            row = [arch, shape, rec["status"]]
            if rec["status"] != "ok":
                print("| " + " | ".join(row) + " | | | | | |")
                continue
            mem = rec["memory"]
            arg = mem["argument_bytes_per_device"]
            row += [f"{arg / GIB:.3f}",
                    f"{(arg + mem['temp_bytes_per_device']) / GIB:.3f}"]
            if SHAPES[shape][2] == "decode":
                cache = registry.input_specs(cfg, shape)["cache"]
                port = port_cache_bytes(cache, mesh, cfg)
                ref = reference_cache_bytes(cache, mesh)
                row += [f"{port / GIB:.3f}", f"{ref / GIB:.3f}",
                        f"{port / ref:.2f}"]
            else:
                row += ["", "", ""]
            print("| " + " | ".join(row) + " |", flush=True)


if __name__ == "__main__":
    main()
