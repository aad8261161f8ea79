"""End-to-end driver: train the ~135M-parameter smollm-135m at its full
published config with int8 integer layers, checkpoints, the
fault-tolerant step loop and the resumable data pipeline.

Counterpart of ``examples/train_100m_e2e.py``, through
``repro_torch.launch.train`` in this process.  On the card a step of the
default batch takes well under a second; on the CPU (``--device cpu``)
expect seconds per step.  A second run with the same ``--ckpt-dir``
resumes from its newest checkpoint.

    python -m repro_torch.examples.train_100m_e2e --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m_e2e \\
        --steps 4 --batch 2 --seq 32 --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as launch_train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cmd = ["--arch", "smollm-135m",            # full config (no --reduced)
           "--quant", "int8",
           "--steps", str(args.steps),
           "--batch", str(args.batch),
           "--seq", str(args.seq),
           "--lr", "3e-4",
           "--ckpt-dir", args.ckpt_dir,
           "--ckpt-every", "100",
           "--log-every", "10",
           "--device", args.device]
    print("launch.train", " ".join(cmd))
    return launch_train.main(cmd)


if __name__ == "__main__":
    main()
