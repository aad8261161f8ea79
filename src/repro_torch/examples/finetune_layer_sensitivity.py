"""Per-layer bit-width sensitivity sweep — the experiment the paper's §4
invites but a single global QuantConfig cannot express.

Counterpart of ``examples/finetune_layer_sensitivity.py``.  For each scope
(embeddings, attention, MLPs, norms, head, and every individual
transformer block) the sweep builds a ``QuantPolicy`` that keeps the whole
model at the uniform base width and drops ONLY that scope to 8-bit,
fine-tunes on the synthetic proxy task (``train.finetune``), and reports
the metric delta against the uniform baselines.  Scopes whose resolved
leaf violates the paper's stability constraint (weight_bits == 8 with
act_bits < 12 — the Fig. 4 divergence regime) are flagged ``UNSTABLE``.
``--policy-out`` writes each scope's policy (``QuantPolicy.to_json``, which
the reference's ``from_json`` reads) beside its metric and flag, so a
scope found insensitive can be trained with that policy.

A second, orthogonal axis (``--kept-ops``) sweeps the integer kept-ops
swap the same way: the whole model stays at the paper's int8 with the kept
FP32 ops, and ONE scope at a time swaps its kept ops (softmax exp,
GeLU/SiLU, norm rsqrt, pooler tanh) for the ``core/iapprox.py``
fixed-point forms.

    python -m repro_torch.examples.finetune_layer_sensitivity --steps 80
    python -m repro_torch.examples.finetune_layer_sensitivity \\
        --task span --paper-int8   # drop scopes to w8-a12-g8 instead
    python -m repro_torch.examples.finetune_layer_sensitivity --kept-ops
    PYTHONPATH=src python -m repro_torch.examples.finetune_layer_sensitivity \\
        --steps 2 --batch 4 --blocks 1 --eval-n 16 --device cpu
"""
import argparse
import dataclasses
import json

from repro_torch.core.qconfig import QuantConfig, stability_violated
from repro_torch.core.qpolicy import QuantPolicy, rule
from repro_torch.train.finetune import FtConfig, finetune

#: (label, glob pattern, representative concrete path) — the sweep's scopes
#: over the proxy BERT / ViT paths.  Patterns use the policy grammar: "*"
#: crosses dot boundaries, "[12]" is a character class, block indices may
#: be negative (blocks.-1 = last layer).  The concrete path is what the
#: stability probe resolves.
SCOPES = [
    ("embeddings", "*embed*", "embed"),     # embed, type_embed, embed_ln
    ("attention", "*.attn.*", "blocks.1.attn.wq"),
    ("mlp", "*.mlp.*", "blocks.1.mlp.w1"),
    ("block norms", "*.ln[12]", "blocks.1.ln1"),
    ("head", "*head*", "head"),    # head (cls/img) and span_head (span)
]

#: (label, glob pattern) — the kept-op call sites of the proxy models: the
#: attention softmax exp resolves at ``attn.qk``, GeLU / SiLU at
#: ``mlp.act`` (and the BERT pooler tanh at ``pooler.act``), the norm
#: rsqrt at the ``ln*`` leaves.
KEPT_SCOPES = [
    ("softmax exp", "*.attn.qk"),
    ("activations", "*.act*"),
    ("norm rsqrt", "*ln*"),
    ("everything", "*"),
]


def block_scopes(n_layers: int) -> list:
    return [(f"block {i}", f"blocks.{i}.*", f"blocks.{i}.attn.wq")
            for i in range(n_layers)]


def scopes(task: str, n_blocks: int) -> list:
    """The bit-width axis's scopes for ``task`` (ViT: the patch embedding
    in place of the token embeddings)."""
    out = SCOPES + block_scopes(n_blocks)
    if task == "img":
        out = [("patch embed", "patch_embed", "patch_embed")] + out[1:]
    return out


def drop_overrides(paper_int8: bool) -> dict:
    """The per-scope 8-bit override: naive w8-a8-g8 by default (the Fig. 4
    regime, which makes per-scope sensitivity visible), or the paper's
    stable w8-a12-g8.  ``warn_stability`` is off in the override: the
    sweep reports the violation itself, as its UNSTABLE column."""
    if paper_int8:
        return dict(weight_bits=8, act_bits=12, grad_bits=8)
    return dict(weight_bits=8, act_bits=8, grad_bits=8, warn_stability=False)


def scope_policy(base: QuantConfig, pattern: str, paper_int8: bool
                 ) -> QuantPolicy:
    return QuantPolicy(base=base, rules=(rule(pattern,
                                              **drop_overrides(paper_int8)),))


def unstable(policy: QuantPolicy, probe_path: str) -> bool:
    """The UNSTABLE flag: the scope's representative leaf violates the
    w8 => act >= 12 constraint."""
    return stability_violated(policy.resolve(probe_path))


def kept_ops_sweep(args, ft) -> dict:
    """The --kept-ops axis: the int8 body everywhere; ONE scope at a time
    swaps its kept FP32 ops for the iapprox integer forms."""
    base = dataclasses.replace(QuantConfig.int8(), kept_ops="fp32")
    print(f"kept-ops axis (task={args.task}, {args.steps} steps/point, "
          "body uniform w8-a12-g8):")
    ref, _ = finetune(args.task, base, ft, device=args.device)
    all_int, _ = finetune(args.task, dataclasses.replace(
        base, kept_ops="integer"), ft, device=args.device)
    print(f"  {'fp32 kept ops (paper)':22s} metric={ref:6.2f}")
    print(f"  {'integer kept ops (all)':22s} metric={all_int:6.2f} "
          f"({all_int - ref:+.2f})")
    print(f"\n  {'scope':12s} {'pattern':12s} {'metric':>7s} {'delta':>7s}")
    out = {"fp32": ref, "integer": all_int}
    for label, pattern in KEPT_SCOPES:
        policy = QuantPolicy(base=base, rules=(
            rule(pattern, kept_ops="integer"),))
        metric, _ = finetune(args.task, policy, ft, device=args.device)
        out[label] = metric
        print(f"  {label:12s} {pattern:12s} {metric:7.2f} "
              f"{metric - ref:+7.2f}")
    print("\nnote: deltas the size of the fp32-vs-int8 gap mean the iapprox "
          "approximation error is visible to the proxy task; near-zero "
          "deltas mean the swap is metric-neutral at these bounds.")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="cls", choices=["cls", "span", "img"])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--eval-n", type=int, default=256,
                    help="held-out samples a point is scored on")
    ap.add_argument("--base", default="int16",
                    help="uniform base preset the body stays at")
    ap.add_argument("--paper-int8", action="store_true",
                    help="drop scopes to the paper's stable w8-a12-g8 "
                         "instead of naive w8-a8-g8")
    ap.add_argument("--blocks", type=int, default=4,
                    help="number of per-block scopes to sweep "
                         "(the proxy models have 4 layers)")
    ap.add_argument("--kept-ops", action="store_true",
                    help="sweep the integer kept-ops axis instead of the "
                         "bit-width axis")
    ap.add_argument("--policy-out", default=None,
                    help="write every scope's policy JSON, metric and "
                         "flag to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ft = FtConfig(steps=args.steps, batch=args.batch, eval_n=args.eval_n)
    if args.kept_ops:
        return kept_ops_sweep(args, ft)
    base = QuantConfig.preset(args.base)
    if not isinstance(base, QuantConfig):
        raise SystemExit(f"--base must be a uniform config preset "
                         f"(fp32/int16/...), got policy preset {args.base!r}")

    print(f"uniform baselines (task={args.task}, {args.steps} steps/point):")
    baselines = {}
    for name in dict.fromkeys(("fp32", args.base, "int8")):
        metric, _ = finetune(args.task, QuantConfig.preset(name), ft,
                             device=args.device)
        baselines[name] = metric
        print(f"  {name:10s} metric={metric:6.2f}")
    ref = baselines[args.base]

    drop = "w8-a12-g8" if args.paper_int8 else "w8-a8-g8"
    print(f"\nper-scope sensitivity: base={args.base}, one scope dropped to "
          f"{drop} at a time (delta vs uniform {args.base}):")
    print(f"  {'scope':12s} {'pattern':14s} {'metric':>7s} {'delta':>7s}"
          "  stability")
    rows, any_unstable = [], False
    for label, pattern, probe_path in scopes(args.task, args.blocks):
        policy = scope_policy(base, pattern, args.paper_int8)
        flag = unstable(policy, probe_path)
        any_unstable |= flag
        metric, _ = finetune(args.task, policy, ft, device=args.device)
        rows.append((label, pattern, metric, flag, policy.to_json()))
        note = "UNSTABLE (w8, act<12 — Fig. 4 regime)" if flag else "ok"
        print(f"  {label:12s} {pattern:14s} {metric:7.2f} "
              f"{metric - ref:+7.2f}  {note}")
    if any_unstable:
        print("\nnote: UNSTABLE scopes violate the paper's w8 => act>=12 "
              "constraint (QuantConfig.StabilityWarning); expect Fig. 4-"
              "style divergence at scale even where the proxy metric "
              "holds up.")
    if args.policy_out:
        with open(args.policy_out, "w") as f:
            json.dump([{"scope": r[0], "pattern": r[1], "metric": r[2],
                        "unstable": r[3], "policy": json.loads(r[4])}
                       for r in rows], f, indent=1)
    return {"baselines": baselines, "scopes": rows}


if __name__ == "__main__":
    main()
