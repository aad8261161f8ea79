#!/usr/bin/env python3
"""How the SSM and hybrid stacks' numerics change with depth, at full width
and random init.

    PYTHONPATH=src python3 tools/ssm_depth.py --arch mamba2-370m \\
        --layers 2 12 48 [--seq 64] [--device cpu] [--reference] \\
        [--fp32-rule '*mamba.norm_g' ...]

For each depth (the published config with ``n_layers`` cut), from the
port's seeded init, batch 2 x ``--seq`` tokens:

- FP32 decode against ``lm_prefill``: 8 tokens stepped through the cache,
  the largest difference of the last logits and the logits' size;
- one ``lm_loss`` step's gradient norm per parameter under FP32, int8
  rounding to nearest and int8 with stochastic gradient rounding (a
  seeded generator), and each int8 gradient's distance from the FP32 one
  relative to the FP32 norm; with ``--fp32-rule PATTERN`` also int8
  rounding to nearest with the leaves matching PATTERN at FP32 (a
  ``QuantPolicy`` rule ``enabled=False``), one run per pattern;
- the forward, layer by layer: each layer's int8 output against its FP32
  output from the same FP32 input (relative to the layer's residual
  update), and the int8 trajectory's distance from the FP32 one.

``--reference`` also prints the JAX package's FP32 and int8 (pallas,
round to nearest) gradient norms per parameter at the same depths, from
its own seeded init (CPU only, the kernels in interpret mode: minutes at
48 layers).  It imports the JAX package, as the tests do; without the
flag the tool imports only ``torch`` and the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def port(arch: str, layers: int, seq: int, device: str,
         fp32_rules=()) -> None:
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.core.qpolicy import QuantPolicy, ensure_scope, rule
    from repro_torch.models import blocks, lm
    from repro_torch.train import trainer
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers)
    dev = torch.device(device)
    p = lm.lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                   device=dev)
    toks = torch.randint(0, cfg.vocab, (2, seq),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    q32 = QuantConfig.fp32()
    rn = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    with torch.no_grad():
        pre, _ = lm.lm_prefill(p, toks[:, :8], cfg, q32)
        cache = lm.init_cache(cfg, 2, 16, device=dev)
        for t in range(8):
            dec, cache = lm.lm_decode_step(p, toks[:, t:t + 1], cache, cfg,
                                           q32)
    print(f"{arch}, {layers} layers: FP32 decode against prefill, 8 tokens: "
          f"max|err| {(pre - dec).abs().max().item():.3e}, max|logits| "
          f"{pre.abs().max().item():.3e}", flush=True)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grads = {}
    runs = [("fp32", q32, None), ("int8 RN", rn, None),
            ("int8 SR", QuantConfig.int8(),
             torch.Generator(device=dev).manual_seed(5))]
    runs += [(f"int8 RN, {pat} fp32",
              QuantPolicy(rn, (rule(pat, enabled=False),)), None)
             for pat in fp32_rules]
    for name, q, key in runs:
        t0 = time.perf_counter()
        loss, _, g = trainer.loss_and_grads(lm.lm_loss, p, batch, cfg, q,
                                            key)
        grads[name] = dict(_flat(g))
        print(f"  {name}: loss {float(loss):.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for leaf, g32 in grads["fp32"].items():
        n = g32.norm().item()
        print(f"  {leaf:28s} fp32 {n:.4e}" + "".join(
            f"; {k} {grads[k][leaf].norm().item():.4e} (distance "
            f"{(grads[k][leaf] - g32).norm().item() / n:.3e})"
            for k in grads if k != "fp32"))
    if cfg.family != "ssm":
        return
    layers_p = blocks.unstack(p["blocks"], layers)
    with torch.no_grad():
        x32 = lm._embed(p, toks, cfg, q32, None)
        x8 = x32.clone()
        for i in range(layers):
            sc8 = ensure_scope(rn).child("blocks").child(str(i))
            sc32 = ensure_scope(q32).child("blocks").child(str(i))
            one8 = lm._mamba_layer(layers_p[i], x32, cfg, sc8, None)
            n32 = lm._mamba_layer(layers_p[i], x32, cfg, sc32, None)
            x8 = lm._mamba_layer(layers_p[i], x8, cfg, sc8, None)
            h = (n32 - x32).norm().item()
            print(f"  layer {i:2d}: |x| {x32.norm().item():.3e}, |h| {h:.3e};"
                  f" int8 layer error {(one8 - n32).norm().item() / h:.3e} "
                  f"of |h|; int8 trajectory "
                  f"{(x8 - n32).norm().item() / n32.norm().item():.3e} of |x|")
            x32 = n32


def reference(arch: str, layers: int, seq: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import registry as jregistry
    from repro.core.qconfig import QuantConfig as JQuantConfig
    from repro.models import lm as jlm
    cfg = dataclasses.replace(jregistry.get_config(arch), n_layers=layers)
    p = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, seq)).astype(
        np.int32)
    batch = {"tokens": jnp.asarray(toks),
             "labels": jnp.asarray(np.roll(toks, -1, 1))}
    for name, q in (("fp32", JQuantConfig.fp32()),
                    ("int8 RN", dataclasses.replace(
                        JQuantConfig.int8(), backend="pallas",
                        stochastic_grad=False))):
        t0 = time.perf_counter()
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.lm_loss(p, b, cfg, q, None), has_aux=True))(
            p, batch)
        print(f"reference {arch}, {layers} layers, {name}: loss "
              f"{float(loss):.6f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        for path, v in jax.tree_util.tree_flatten_with_path(g)[0]:
            print(f"  {jax.tree_util.keystr(path):40s} "
                  f"{float(jnp.linalg.norm(v)):.4e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 12, 48])
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--fp32-rule", action="append", default=[])
    args = ap.parse_args(argv)
    for n in args.layers:
        port(args.arch, n, args.seq, args.device, args.fp32_rule)
        if args.reference:
            reference(args.arch, n, args.seq)


if __name__ == "__main__":
    main()
