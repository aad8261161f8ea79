"""A distributed ``launch.train`` run resumed from its own checkpoint.

Under ``torchrun`` on two gloo CPU ranks (reduced qwen1.5-0.5b, data 2,
the int8 preset, whose gradients round stochastically from each rank's
generator): 4 steps straight, then 2 steps with a checkpoint every step
and a second run that restores step 2 and trains 2 more.  Each rank
restores its own row of the checkpoint's generator states (``Run.load``).
Both ranks of every run exit 0, and the resumed run's losses at steps 2
and 3 equal the straight run's bit for bit, as
``test_torch_chaos.py`` holds a resumed run's end state in one process.
"""
import json
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

#: each rank writes the losses ``launch.train.main`` returns, at full
#: precision (the log prints 6 decimals)
_DRIVER = r'''
import json, os, sys
from repro_torch.launch import train
losses = train.main(sys.argv[2:])
with open(os.path.join(sys.argv[1], f"losses{os.environ['RANK']}.json"),
          "w") as f:
    json.dump(losses, f)
'''


def _run(tmp_path, out: str, steps: int, *extra) -> list:
    """``launch.train`` on two gloo ranks; both ranks' losses."""
    driver = tmp_path / "driver.py"
    driver.write_text(_DRIVER)
    out_dir = tmp_path / out
    out_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
            "--steps", str(steps), *extra]
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(driver), str(out_dir), *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = p.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    assert p.returncode == 0, err[-4000:]
    return [json.loads((out_dir / f"losses{r}.json").read_text())
            for r in range(2)]


def test_resumed_distributed_run_replays_the_straight_run(tmp_path):
    straight = _run(tmp_path, "straight", 4)
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "1"]
    first = _run(tmp_path, "first", 2, *ckpt)
    resumed = _run(tmp_path, "resumed", 2, *ckpt)
    assert (tmp_path / "ckpt").is_dir()
    for r in range(2):
        assert len(straight[r]) == 4
        assert first[r] == straight[r][:2], r
        # steps 2 and 3 after the restore of step 2, bit for bit
        assert resumed[r] == straight[r][2:], r
