"""quantlint CLI — record a registry config's step under a quantization
preset and run every trace/policy rule on its forward and backward.

Counterpart of ``repro/analysis/lint.py``:

    python -m repro_torch.analysis.lint --config bert_base --preset int8
    python -m repro_torch.analysis.lint --config all --preset all --json
    python -m repro_torch.analysis.lint --config all --device cpu

The reference traces ``jax.grad`` of the loss and reads the jaxpr; the
port runs the loss and its ``.backward()`` once under a ``Recorder``
(``walker.py``), on the card by default (``--device cpu`` runs the
kernels' plain versions, whose ops the recorder marks as the kernels'),
and proves the integer-training invariants on the recorded trace —
integer closure (QL001), PRNG key discipline (QL002), policy hygiene
(QL003), stability regime (QL005), accumulator budgets (QL006) and wire
format (QL007).  The dispatch budget (QL004) compares *against a pinned
baseline* and so lives with the gate, ``analysis/dispatch.py``.

The cells are the reference's: the same configs and presets at the same
reduced sizes (bert and vit 4 layers at d 64; every registry arch
``reduced()`` with B 2, S 32), with a generator seeded 0 as the key.

Exit status is 1 when any finding is reported, 0 otherwise; ``--json``
emits one document (one entry per ``config × preset`` cell).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

import torch

#: paper-subject configs built through ``models/paper_models.py`` (the
#: registry archs are built through the lm / encdec stacks)
PAPER_CONFIGS = ("bert_base", "vit_base")

#: preset cells the lint sweeps
DEFAULT_PRESETS = ("int8", "int16", "int8_embed16")


def all_configs() -> Tuple[str, ...]:
    from repro_torch.configs import registry
    return PAPER_CONFIGS + tuple(registry.ARCH_IDS)


def _policy(preset: str):
    """Preset name -> QuantPolicy."""
    from repro_torch.core import qpolicy
    return qpolicy.as_policy(qpolicy.get(preset))


def trainable(params):
    """``params`` with every float leaf a fresh leaf that requires grad."""
    if isinstance(params, dict):
        return {k: trainable(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.detach().requires_grad_(True)
    return params


def _loss_thunk(config: str, policy, device: torch.device):
    """Build ``(loss_of_params, fwd_of_params, params)`` for one config,
    policy closed over.  ``fwd_of_params`` is the *inference* forward —
    the subject of the kept-ops invariant (QL008): the model apply for the
    paper subjects, a decode step for the serving stacks.  Reduced dims
    everywhere — the invariants are structural, so the tiny variant proves
    the same properties as the published shape."""
    def key():
        return torch.Generator(device=device).manual_seed(0)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if config == "bert_base":
        from repro_torch.models import paper_models as pm
        cfg = pm.bert_config(n_layers=4, d_model=64, n_heads=4, d_ff=128,
                             vocab=128, name="bert-lint")
        params = pm.bert_init(key(), cfg, num_labels=4, device=device)
        batch = {"tokens": zeros(2, 16), "labels": zeros(2)}
        return (lambda p: pm.bert_cls_loss(p, batch, cfg, policy, key())[0],
                lambda p: pm.bert_apply(p, batch["tokens"], cfg, policy,
                                        key()),
                params)

    if config == "vit_base":
        from repro_torch.models import paper_models as pm
        cfg = pm.vit_config(n_layers=4, d_model=64, n_heads=4, d_ff=128,
                            img=32, patch=16, name="vit-lint")
        params = pm.vit_init(key(), cfg, num_classes=4, img=32, patch=16,
                             device=device)
        batch = {"images": zeros(2, 32, 32, 3, dtype=torch.float32),
                 "labels": zeros(2)}
        return (lambda p: pm.vit_cls_loss(p, batch, cfg, policy, key(),
                                          patch=16)[0],
                lambda p: pm.vit_apply(p, batch["images"], cfg, policy,
                                       key(), patch=16),
                params)

    from repro_torch.configs import registry
    from repro_torch.models import encdec, lm
    cfg = registry.get_config(config).reduced()
    loss_fn = encdec.encdec_loss if cfg.enc_dec else lm.lm_loss
    init_fn = encdec.encdec_init if cfg.enc_dec else lm.lm_init
    params = init_fn(key(), cfg, device=device)
    B, S = 2, 32
    batch = {"tokens": zeros(B, S), "labels": zeros(B, S)}
    if cfg.enc_dec:
        batch["frames"] = zeros(B, S, cfg.d_model, dtype=torch.float32)
    if cfg.vlm_prefix:
        batch["patch_embeds"] = zeros(B, cfg.vlm_prefix, cfg.d_model,
                                      dtype=torch.float32)
    tok1 = zeros(B, 1)
    if cfg.enc_dec:
        def fwd(p):
            enc = encdec.encode(p, batch["frames"], cfg, policy, key())
            cross = encdec.encdec_precompute_cross(p, enc, cfg, policy)
            cache = encdec.encdec_init_cache(cfg, B, S, device=device)
            return encdec.encdec_decode_step(p, tok1, cache, cross, cfg,
                                             policy)[0]
    else:
        def fwd(p):
            cache = lm.init_cache(cfg, B, S, dtype=torch.float32,
                                  device=device)
            return lm.lm_decode_step(p, tok1, cache, cfg, policy)[0]
    return (lambda p: loss_fn(p, batch, cfg, policy, key())[0], fwd, params)


def lint_cell(config: str, preset: str, device="cuda") -> Dict[str, Any]:
    """Record one ``config × preset`` cell's step on ``device`` (the card
    unless the caller asks for ``cpu``) and run every rule on it.

    QL008 (kept-op escape) is a *forward-pass* property: the paper's
    kept-ops set covers the inference ops (softmax exp, GeLU/SiLU, norm
    rsqrt, pooler tanh), while the training loss head's ``log_softmax`` is
    the documented training-only exemption (DESIGN.md §10).  So the
    step's trace runs the rule battery with QL008 off, and the rule is
    applied to the inference forward's trace instead whenever the policy
    carries ``kept_ops="integer"``.
    """
    from repro_torch.analysis import rules, walker
    from repro_torch.core import qpolicy
    from repro_torch.models.lm import resolve_device

    device = resolve_device(device)
    policy = _policy(preset)
    loss, fwd, params = _loss_thunk(config, policy, device)
    params = trainable(params)
    with qpolicy.record_resolutions() as recs:
        _, trace = walker.record(lambda: loss(params).backward())
    paths = [p for pol, p in recs if pol == policy]
    findings = rules.run_rules(trace, policy=policy, resolutions=paths,
                               kept_ops=False)
    if rules._policy_wants_integer_kept_ops(policy):
        with torch.no_grad():
            _, ftrace = walker.record(fwd, params)
        findings = findings + rules.check_kept_ops(ftrace)
    return {
        "config": config,
        "preset": preset,
        "findings": [f.to_dict() for f in findings],
        "launches": rules.dispatch_counts(trace),
        "resolutions": len(paths),
        "paths": sorted({p for tup in paths for p in tup}),
    }


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="verify the integer-training invariants on a recorded "
                    "train step")
    ap.add_argument("--config", action="append", default=None,
                    metavar="NAME",
                    help="registry config or paper subject (repeatable; "
                         "'all' sweeps every config; default bert_base)")
    ap.add_argument("--preset", action="append", default=None,
                    metavar="NAME",
                    help="quantization preset (repeatable; 'all' = "
                         f"{'/'.join(DEFAULT_PRESETS)}; default int8)")
    ap.add_argument("--device", default="cuda",
                    help="device of the recorded step (default cuda; "
                         "raises without a card unless cpu is asked for)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of text")
    args = ap.parse_args(argv)

    configs = args.config or ["bert_base"]
    if "all" in configs:
        configs = list(all_configs())
    presets = args.preset or ["int8"]
    if "all" in presets:
        presets = list(DEFAULT_PRESETS)

    results = []
    n_findings = 0
    for config in configs:
        for preset in presets:
            cell = lint_cell(config, preset, device=args.device)
            cell.pop("paths")
            results.append(cell)
            n_findings += len(cell["findings"])
            if not args.json:
                status = ("clean" if not cell["findings"]
                          else f"{len(cell['findings'])} finding(s)")
                print(f"{config} x {preset}: {status} "
                      f"(launches {cell['launches']['effective']} "
                      f"effective, {cell['resolutions']} resolutions)")
                for f in cell["findings"]:
                    loc = f" [{f['where']}]" if f["where"] else ""
                    print(f"  {f['code']} {f['rule']}: {f['message']}{loc}")
    if args.json:
        json.dump({"results": results, "findings": n_findings},
                  sys.stdout, indent=2)
        print()
    elif n_findings:
        print(f"FAIL: {n_findings} finding(s)")
    else:
        print("OK: all cells clean")
    return 1 if n_findings else 0


if __name__ == "__main__":
    sys.exit(main())
