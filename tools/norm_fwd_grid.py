#!/usr/bin/env python3
"""Device time of the norm forwards' register path over its launch grids.

    python3 tools/norm_fwd_grid.py

At ``chip_smoke.py`` phase 2's norm forward shapes (int16 mantissas at
a12, FP32 body), times ``csrc/int_norm.cu``'s register path through the
C entry points at every rows-a-block ``gpb`` the kernel takes and at
grids of 8-32 resident warps a SM (and of one block for each ``gpb``
rows), beside the plan ``int_norm.fwd_blocks`` picks, the
any-shape body and the byte bound; each grid's outputs are held bit for
bit against the any-shape body.  Device ms per call through
``chip_smoke.device_ms``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = (("9 ln bert-base cls", True, 4096, 768),
          ("9b ln bert-base span", True, 4608, 768),
          ("11 rms prefill", False, 256, 1024),
          ("11b rms qwen1.5-0.5b", False, 2048, 1024),
          ("11c rms qwen2-moe-a2.7b", False, 2048, 2048),
          ("11d rms decode", False, 4, 1024),
          ("rms smollm-135m", False, 2048, 576))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("norm_fwd_grid: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _lib, int_norm
    lib = _lib.load()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    xe = torch.tensor(-9, dtype=torch.int32, device=dev)
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs", flush=True)

    for label, ln, R, D in SHAPES:
        xm = torch.randint(-2047, 2048, (R, D), generator=gen, device=dev,
                           dtype=torch.int16)
        gamma = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((D,), generator=gen, device=dev)
        wr = int_norm.fwd_warps_per_row(D, True)
        y = torch.empty((R, D), device=dev)
        mu, rstd = (torch.empty((R, 1), device=dev) for _ in range(2))
        st = _lib.stream_of(xm)

        def launch(wr, gpb, nb):
            if ln:
                err = lib.int_layernorm_fwd_launch(
                    xm.data_ptr(), 2, xe.data_ptr(), gamma.data_ptr(),
                    beta.data_ptr(), y.data_ptr(), mu.data_ptr(),
                    rstd.data_ptr(), R, D, 1e-5, 0, wr, gpb, nb, st)
            else:
                err = lib.int_rmsnorm_fwd_launch(
                    xm.data_ptr(), 2, xe.data_ptr(), gamma.data_ptr(),
                    y.data_ptr(), rstd.data_ptr(), R, D, 1e-6, 0, wr, gpb,
                    nb, st)
            _lib.check(err, label)

        def outputs(wr, gpb, nb):
            launch(wr, gpb, nb)
            return [t.clone() for t in ((y, mu, rstd) if ln else (y, rstd))]
        ref = outputs(0, 0, 0)
        bound = cs.bound_ms(cs.nbytes(xm, gamma, *ref)
                            + (cs.nbytes(beta) if ln else 0), 0)[0]
        plan = int_norm.fwd_blocks(R, wr, sms)
        res = []
        for gpb in (g for g in (1, 2, 4, 8) if g * wr <= 8):
            need = -(-R // gpb)
            grids = {min(need, -(-w * sms // (wr * gpb)))
                     for w in (8, 12, 16, 20, 24, 32)} | {need}
            for nb in sorted(grids):
                if not all(torch.equal(a, b)
                           for a, b in zip(outputs(wr, gpb, nb), ref)):
                    raise AssertionError(f"{label}: gpb {gpb} nb {nb} differs "
                                         "from the any-shape body")
                res.append((cs.device_ms(lambda: launch(wr, gpb, nb)), gpb,
                            nb))
        res.sort()
        mine = next(ms for ms, g, n in res if (g, n) == plan)
        print(f"{label} {R}x{D}: bound {bound:.4f} ms; any-shape body "
              f"{cs.device_ms(lambda: launch(0, 0, 0)):.4f}; plan gpb "
              f"{plan[0]} nb {plan[1]} "
              f"({plan[0] * plan[1] * wr / sms:.1f} warps a SM) {mine:.4f} "
              f"(rank {[(g, n) for _, g, n in res].index(plan) + 1} of "
              f"{len(res)}); by time: "
              + ", ".join(f"{g}/{n} {ms:.4f}" for ms, g, n in res),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
