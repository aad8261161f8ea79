"""Paper reproduction driver: the bit-width sweep (Tables 1-3, Figs. 3-4)
on the synthetic GLUE / SQuAD / CIFAR proxies, on the card.

Counterpart of ``examples/finetune_bitwidth_sweep.py``.  Besides the
metric sweep it prints each integer preset's kernel launches per training
step and its best step time, beside int8's: one launch per matmul
direction whatever the limb count, so the launches are the same at every
bit-width and 16-bit pays no launch overhead over int8.

    python -m repro_torch.examples.finetune_bitwidth_sweep --task span \\
        --steps 200
    PYTHONPATH=src python -m repro_torch.examples.finetune_bitwidth_sweep \\
        --task cls --steps 4 --device cpu     # CPU: no launches to count
"""
import argparse

from repro_torch.core.qconfig import QuantConfig
from repro_torch.train.finetune import FtConfig, finetune, step_stats, sweep


def dispatch_report(task: str, presets, ft: FtConfig, device) -> None:
    """Per-step kernel launches and best step time, against the narrowest
    preset's."""
    print("per-step kernel launches / wall-clock:")
    rows = {p: step_stats(task, QuantConfig.preset(p), ft, device=device)
            for p in presets}
    base = rows[presets[-1]]          # narrowest width = launch baseline
    for p, s in rows.items():
        d_calls = s["launches"] - base["launches"]
        d_us = s["step_us"] - base["step_us"]
        print(f"  {p:7s} launches/step={s['launches']:4d} "
              f"(delta vs {presets[-1]}: {d_calls:+d})  "
              f"step={s['step_us']:9.0f}us (delta {d_us:+9.0f}us)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="cls", choices=["cls", "span", "img"])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--fig4", action="store_true",
                    help="activation-bit-width sweep at w8/g8 (paper Fig. 4)")
    ap.add_argument("--no-dispatch-report", action="store_true",
                    help="skip the per-step launch/wall-clock table")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ft = FtConfig(steps=args.steps)
    if args.fig4:
        print("Fig. 4 — w8/g8, varying activation bits on the span task:")
        for ab in (8, 10, 12, 16):
            q = QuantConfig(weight_bits=8, act_bits=ab, grad_bits=8)
            metric, _ = finetune("span", q, ft, device=args.device)
            print(f"  act_bits={ab:<3d} EM={metric:.2f}")
        return
    presets = ["fp32", "int16", "int12", "int10", "int8"]
    if not args.no_dispatch_report:
        dispatch_report(args.task, presets[1:], ft, args.device)
    print(f"bit-width sweep on task={args.task} ({args.steps} steps/point):")
    res = sweep(args.task, presets, ft, device=args.device)
    base = res["fp32"]
    for p, m in res.items():
        print(f"  {p:7s} metric={m:6.2f} drop={base - m:+.2f}")


if __name__ == "__main__":
    main()
