"""Kernel-dispatch regression gate — quantlint QL004.

Counterpart of ``benchmarks/check_dispatch.py``.  Counts the kernel
wrapper calls of every integer-layer entry point — the quantity the
single-dispatch limb fusion minimized — by recording each call
(``walker.record``) and compares them against the checked-in baseline
``analysis/dispatch_baseline.json``.  The sections and entries are the
reference's at the reference's shapes: the linears, the norms and the
fused attention forward, forward+backward and decode at int8 / int12 /
int16, the ``policy`` section's four bert steps, and the ``serve``
section's prompt admission.  Every entry is a plain int, kernel calls
per call: the port's layer loops are Python loops, so each call's count
is the reference's ``effective`` one.  Any count ABOVE baseline fails
the gate; counts below are reported as improvements (refresh with
``--update`` to lock them in).

    PYTHONPATH=src python -m repro_torch.analysis.dispatch --device cpu
    PYTHONPATH=src python -m repro_torch.analysis.dispatch --device cpu --update

``tests/test_torch_lint_parity.py`` runs the same comparison as a test.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from repro_torch.analysis import rules, walker
from repro_torch.analysis.lint import trainable

BASELINE_PATH = os.path.join(os.path.dirname(__file__),
                             "dispatch_baseline.json")


def _cfg(preset: str):
    from repro_torch.core.qconfig import QuantConfig
    return dataclasses.replace(QuantConfig.preset(preset),
                               stochastic_grad=False)


def _count(fn, *args) -> int:
    """Kernel calls of ``fn(*args)``."""
    _, trace = walker.record(fn, *args)
    return walker.count_kernels(trace)


def _grad_count(loss, *args) -> int:
    """Kernel calls of ``loss(*args)`` and its backward to every arg."""
    args = [a.detach().requires_grad_(True) for a in args]
    return _count(lambda: loss(*args).backward())


def _fwd_count(fn, *args) -> int:
    with torch.no_grad():
        return _count(fn, *args)


def layer_counts(preset: str, device) -> dict:
    """One preset's layer entries."""
    from repro_torch.core import int_ops

    cfg = _cfg(preset)
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x, w = rand(4, 8, 32), rand(32, 16, scale=0.1)
    xb, wb = rand(4, 8, 32), rand(4, 32, 16, scale=0.1)
    d = rand(16, 64)
    gm = torch.ones((64,), device=device)
    bt = torch.zeros((64,), device=device)

    def lin(x, w):
        return int_ops.int_linear(x, w, None, None, cfg)

    def bl(x, w):
        return int_ops.int_batched_linear(x, w, None, cfg)

    def ln(x):
        return int_ops.int_layernorm(x, gm, bt, None, cfg)

    def rn(x):
        return int_ops.int_rmsnorm(x, gm, None, cfg)

    # fused integer flash attention: fwd is 3 quantizes + 1 kernel,
    # fwd+bwd adds the grad quantize and the dq / dkv kernels, decode
    # (Sq=1 over a cache) must match the fwd count — one fused launch
    # per direction, never a per-chunk or per-token dispatch loop
    qa, ka, va = rand(2, 16, 2, 2, 32), rand(2, 16, 2, 32), rand(2, 16, 2, 32)
    q1 = rand(2, 1, 2, 2, 32)

    def att(q, k, v):
        return int_ops.int_attention(q, k, v, 0, None, cfg, cfg, True, None)

    def dec(q, k, v):
        return int_ops.int_attention(q, k, v, 7, None, cfg, cfg, True, None)

    def sq(f):
        return lambda *a: (f(*a) ** 2).sum()

    return {
        "linear_fwd": _fwd_count(lin, x, w),
        "linear_fwd_bwd": _grad_count(sq(lin), x, w),
        "batched_linear_fwd": _fwd_count(bl, xb, wb),
        "batched_linear_fwd_bwd": _grad_count(sq(bl), xb, wb),
        "layernorm_fwd": _fwd_count(ln, d),
        "layernorm_fwd_bwd": _grad_count(sq(ln), d),
        "rmsnorm_fwd": _fwd_count(rn, d),
        "rmsnorm_fwd_bwd": _grad_count(sq(rn), d),
        "attention_fwd": _fwd_count(att, qa, ka, va),
        "attention_fwd_bwd": _grad_count(sq(att), qa, ka, va),
        "attention_decode": _fwd_count(dec, q1, ka, va),
    }


def policy_counts(device) -> dict:
    """Model-level kernel calls of a bert train step under mixed-precision
    policies: a policy whose rules only touch non-stacked scopes
    (``int8_embed16``) or that splits the layer stack
    (``int8_firstlast16``), and integer kept ops, must launch exactly the
    uniform int8 step's count.  Explicit ``QuantPolicy`` objects
    throughout."""
    from repro_torch.core.qpolicy import QuantPolicy, preset_rules
    from repro_torch.models import paper_models as pm

    gen = torch.Generator(device=device).manual_seed(0)
    cfg = pm.bert_config(n_layers=4, d_model=64, n_heads=4, d_ff=128,
                         vocab=128, name="bert-gate")
    params = pm.bert_init(gen, cfg, num_labels=4, device=device)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                                     device=device),
             "labels": torch.zeros((2,), dtype=torch.int32, device=device)}
    base = _cfg("int8")

    def step(policy):
        p = trainable(params)
        return _count(lambda: pm.bert_cls_loss(p, batch, cfg, policy,
                                               None)[0].backward())

    return {
        "bert_step_int8": step(QuantPolicy(base=base)),
        "bert_step_int8_embed16": step(
            QuantPolicy(base=base, rules=preset_rules("int8_embed16"))),
        "bert_step_int8_firstlast16": step(
            QuantPolicy(base=base, rules=preset_rules("int8_firstlast16"))),
        "bert_step_int8_keptint": step(QuantPolicy(
            base=dataclasses.replace(base, kept_ops="integer"))),
    }


def serve_counts(device) -> dict:
    """Kernel calls of one prompt's admission on the serve path: one
    ``lm_prefill_cache`` call whatever the prompt's length, never a
    per-token loop."""
    from repro_torch.configs import registry
    from repro_torch.models import lm

    gen = torch.Generator(device=device).manual_seed(0)
    cfg = registry.get_config("smollm-135m").reduced()
    params = lm.lm_init(gen, cfg, device=device)
    cache = lm.init_cache(cfg, 2, 32, dtype=torch.float32, device=device)
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=gen,
                           device=device)
    qcfg = _cfg("int8")
    with torch.no_grad():
        return {"lm_prefill_len8": _count(
            lambda: lm.lm_prefill_cache(params, tokens, cache, cfg, qcfg))}


def current_counts(device="cuda") -> dict:
    """Kernel calls per call of every entry, on ``device`` (the card
    unless the caller asks for ``cpu``)."""
    from repro_torch.models.lm import resolve_device
    device = resolve_device(device)
    counts: dict = {p: layer_counts(p, device)
                    for p in ("int8", "int12", "int16")}
    counts["policy"] = policy_counts(device)
    counts["serve"] = serve_counts(device)
    return counts


def compare(current: dict, baseline: dict) -> tuple:
    """Returns (QL004 findings, improvements): delegates to
    ``rules.check_dispatch_budget`` — any count above baseline, a
    baseline entry with no derived counterpart ("MISSING"), or a derived
    entry the baseline does not pin ("UNPINNED") is a finding."""
    return rules.check_dispatch_budget(current, baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.dispatch")
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--device", default="cuda",
                    help="device of the counted calls (default cuda; "
                         "raises without a card unless cpu is asked for)")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline with the current counts")
    args = ap.parse_args(argv)

    current = current_counts(args.device)
    if args.update:
        with open(args.baseline, "w") as f:
            json.dump(current, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.baseline}")
        return 0

    with open(args.baseline) as f:
        baseline = json.load(f)
    findings, improvements = compare(current, baseline)
    for key, base, cur in improvements:
        print(f"IMPROVED  {key}: {base} -> {cur} (run --update to pin)")
    if findings:
        for f in findings:
            print(f"REGRESSED {f}", file=sys.stderr)
        return 1
    print(f"dispatch counts OK ({sum(len(v) for v in baseline.values())} "
          "entries at or below baseline)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
