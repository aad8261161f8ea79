"""Serving launcher: continuous batching with the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --device cuda --requests 6 --prompt-len 16 --max-new 24

Weights are random (normal · 0.02) from ``--seed``; prompts are random
token ids from the same seed.  Runs on the card unless ``--device cpu``.

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) every rank joins the
world (gloo for the CPU, NCCL for the card) and installs the reference's
host mesh, ``launch.mesh.make_host_mesh()``: the data axis over the world,
a model axis of 1.  The engine reads that mesh: each rank serves its rows
of the slots, and every rank prints the same results.  A model group is
reached through ``Engine`` under a ``sharding.set_mesh`` of a mesh with a
model axis, as in the reference (whose serving launcher has no model
flag either)::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m \
        repro_torch.launch.serve --reduced --device cpu
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.serve.engine import ContinuousBatcher, Engine, ServeConfig

log = logging.getLogger("repro_torch.serve")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=sorted(registry.PORTED))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="int8")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.enc_dec:
        raise SystemExit("the serving engine runs decoder-only archs; decode "
                         "an enc-dec arch through models/encdec.py (encode, "
                         "encdec_precompute_cross, encdec_decode_step)")
    device = lm.resolve_device(args.device)
    world = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if world:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", "0")) % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        sharding.set_mesh(make_host_mesh())
    params = lm.lm_init(torch.Generator(device=device).manual_seed(args.seed),
                        cfg, device=device)
    engine = Engine(params, cfg, registry.get_quant(args.quant),
                    ServeConfig(max_seq=args.max_seq, batch_slots=args.slots),
                    device=device)
    batcher = ContinuousBatcher(engine)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    ids = [batcher.submit(rng.integers(0, cfg.vocab, args.prompt_len),
                          args.max_new)
           for _ in range(args.requests)]
    results = batcher.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in results.values())
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s) on %s",
             len(results), total_tokens, dt, total_tokens / dt,
             torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    for rid in ids[:3]:
        log.info("req %d -> %s", rid, results[rid][:16])
    if world:
        sharding.set_mesh(None)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
