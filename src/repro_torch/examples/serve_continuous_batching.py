"""Serving example: integer-layer decode with continuous batching.

Counterpart of ``examples/serve_continuous_batching.py``: reduced
smollm-135m, int8 weights and int12 activations, eight requests on four
slots through ``ContinuousBatcher``.

    python -m repro_torch.examples.serve_continuous_batching
    PYTHONPATH=src python -m repro_torch.examples.serve_continuous_batching \\
        --requests 3 --new-tokens 4 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.qconfig import QuantConfig
from repro_torch.models import lm
from repro_torch.serve.engine import ContinuousBatcher, Engine, ServeConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = lm.resolve_device(args.device)
    cfg = registry.get_config("smollm-135m").reduced()
    params = lm.lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    engine = Engine(params, cfg, QuantConfig.int8(),
                    ServeConfig(max_seq=128, batch_slots=args.slots),
                    device=device)
    batcher = ContinuousBatcher(engine)

    rng = np.random.default_rng(0)
    t0 = time.time()
    ids = [batcher.submit(rng.integers(0, cfg.vocab, args.prompt),
                          args.new_tokens) for _ in range(args.requests)]
    results = batcher.run_until_drained()
    dt = time.time() - t0
    tok = sum(len(v) for v in results.values())
    print(f"{args.requests} requests x {args.new_tokens} tokens on "
          f"{args.slots} slots: {tok} tokens in {dt:.1f}s "
          f"({tok / dt:.1f} tok/s, int8 weights / int12 activations)")
    for rid in ids[:2]:
        print(f"  request {rid}: {results[rid]}")
    return results


if __name__ == "__main__":
    main()
