"""Chaos harness: deterministic, seeded fault injectors for the step loop.

Counterpart of ``repro/train/chaos.py``.  Every injector is driven by
``ChaosConfig`` step lists and a seed; each fault fires **once** per (kind,
step), so a restored-and-replayed step does not fire it again — recovery
converges, and because a step is a function of (state, step) and the
checkpoint holds the run's generator, a chaos run that recovers through
``fault.run_with_recovery`` ends at the clean run's state exactly.

Injectors:

* ``preempt_at``      — raise :class:`Preemption` before the step; recovery
  is restore + replay.
* ``drop_psum_at``    — raise :class:`CollectiveTimeout` (a collective
  participant that dropped out); the same recovery.
* ``bitflip_at``      — flip one random bit of a QTensor limb plane (or of
  the largest float leaf) in a copy of the state, then raise
  :class:`StateCorruption` (the detected-corruption model: checksums or
  ECC flag it); the live state is left alone and recovery restores from
  disk.
* ``corrupt_exp_at``  — shift a QTensor's scale exponent in a copy, then
  raise :class:`StateCorruption`.
* ``nan_grad_at``     — :meth:`ChaosMonkey.nan_flag` returns 1.0, which the
  sentinel step adds as a NaN to the gradients: exactly one skipped step.
* ``straggle_at``     — sleep ``straggle_s`` before the step (a slow host);
  exercises the straggler monitor, no exception.
* ``corrupt_ckpt_at`` — flip bytes of the newest on-disk checkpoint leaf,
  then raise :class:`StateCorruption`: restore must find the bad checksum
  and fall back to the previous retained checkpoint.
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Any, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import qtensor


class Preemption(RuntimeError):
    """Injected preemption (SIGTERM / maintenance event)."""


class CollectiveTimeout(RuntimeError):
    """Injected dropped-participant timeout on a collective."""


class StateCorruption(RuntimeError):
    """Injected detected corruption (bad checksum / ECC flag)."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    seed: int = 0
    preempt_at: Tuple[int, ...] = ()
    bitflip_at: Tuple[int, ...] = ()
    corrupt_exp_at: Tuple[int, ...] = ()
    drop_psum_at: Tuple[int, ...] = ()
    nan_grad_at: Tuple[int, ...] = ()
    straggle_at: Tuple[int, ...] = ()
    straggle_s: float = 0.05
    corrupt_ckpt_at: Tuple[int, ...] = ()
    ckpt_dir: str = ""                    # target of corrupt_ckpt_at


def _flip_bit_array(a: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One random bit-flip in any array's raw bytes (a copy)."""
    out = np.array(a)
    u = out.view(np.uint8).reshape(-1)
    i = int(rng.integers(u.size))
    u[i] ^= np.uint8(1 << int(rng.integers(8)))
    return out


def _flip_bit(t: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    return torch.from_numpy(_flip_bit_array(t.detach().cpu().numpy(),
                                            rng)).to(t.device)


def corrupt_qtensor(t: qtensor.QTensor, rng: np.random.Generator,
                    *, exponent: bool = False) -> qtensor.QTensor:
    """A copy of ``t`` with one flipped mantissa bit (or, with
    ``exponent=True``, one scale exponent shifted by 1-7: a stale shard
    exponent)."""
    if exponent:
        e = t.exp.detach().cpu().numpy().copy()
        flat = e.reshape(-1)
        j = int(rng.integers(flat.size))
        flat[j] += int(rng.integers(1, 8))
        return qtensor.QTensor(m=t.m, exp=torch.from_numpy(e).to(
            t.exp.device), bits=t.bits)
    return qtensor.QTensor(m=_flip_bit(t.m, rng), exp=t.exp, bits=t.bits)


def _flatten(tree: Any) -> list:
    """Leaves of nested dicts (sorted keys), tuples and lists, a QTensor
    a leaf and None none: ``jax.tree``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [] if tree is None else [tree]


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, it) for v in tree]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else type(tree)(vals))
    return None if tree is None else next(it)


def corrupt_leaf(tree: Any, rng: np.random.Generator,
                 *, exponent: bool = False) -> Any:
    """A copy of ``tree`` with one corrupted leaf: a random QTensor when
    any exist (the quantized state plane), else the largest float leaf
    gets a bit-flip.  ``tree`` itself is left as it was."""
    flat = _flatten(tree)
    qidx = [i for i, x in enumerate(flat) if qtensor.is_qtensor(x)]
    if qidx:
        i = qidx[int(rng.integers(len(qidx)))]
        flat[i] = corrupt_qtensor(flat[i], rng, exponent=exponent)
    else:
        sizes = [x.numel() if isinstance(x, torch.Tensor) else 0
                 for x in flat]
        i = int(np.argmax(sizes))
        flat[i] = _flip_bit(flat[i], rng)
    return _rebuild(tree, iter(flat))


def corrupt_file(path: str, rng: np.random.Generator,
                 n_bytes: int = 4) -> None:
    """Flip ``n_bytes`` random bytes of an on-disk file in place."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        for _ in range(n_bytes):
            off = int(rng.integers(max(size - 1, 1)))
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x41]))


def _newest_leaf_file(ckpt_dir: str) -> Optional[str]:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and ".tmp" not in d)
    if not steps:
        return None
    full = os.path.join(ckpt_dir, steps[-1])
    leaves = sorted(f for f in os.listdir(full) if f.endswith(".npy"))
    return os.path.join(full, leaves[0]) if leaves else None


class ChaosMonkey:
    """Stateful injector: consult it at the top of every step.

    ``wrap(step_fn)`` is the usual integration — the wrapped step runs
    ``before_step`` (which may sleep, corrupt, or raise) and then the real
    step.  Each fault fires once per (kind, step): a replayed step after
    recovery passes clean.
    """

    def __init__(self, cfg: ChaosConfig, writer: bool = True):
        self.cfg = cfg
        #: whether this process corrupts the checkpoint file (one rank of
        #: a distributed run: the others read what it did)
        self.writer = writer
        self.fired: Set[Tuple[str, int]] = set()

    def _rng(self, kind: str, step: int) -> np.random.Generator:
        # zlib.crc32, not hash(): str hashes are per-process randomized
        return np.random.default_rng(
            [self.cfg.seed, step, zlib.crc32(kind.encode())])

    def _fire(self, kind: str, plan: Sequence[int], step: int) -> bool:
        if step in plan and (kind, step) not in self.fired:
            self.fired.add((kind, step))
            return True
        return False

    def nan_flag(self, step: int) -> float:
        """The sentinel step's ``inject_nan`` (fires once)."""
        return 1.0 if self._fire("nan", self.cfg.nan_grad_at, step) else 0.0

    def before_step(self, state: Any, step: int) -> Any:
        c = self.cfg
        if self._fire("straggle", c.straggle_at, step):
            time.sleep(c.straggle_s)
        if self._fire("preempt", c.preempt_at, step):
            raise Preemption(f"injected preemption at step {step}")
        if self._fire("drop_psum", c.drop_psum_at, step):
            raise CollectiveTimeout(
                f"injected dropped collective participant at step {step}")
        if self._fire("ckpt", c.corrupt_ckpt_at, step):
            leaf = _newest_leaf_file(c.ckpt_dir) if c.ckpt_dir else None
            if leaf is not None and self.writer:
                corrupt_file(leaf, self._rng("ckpt", step))
            raise StateCorruption(
                f"injected checkpoint corruption at step {step}")
        if self._fire("bitflip", c.bitflip_at, step):
            corrupt_leaf(state, self._rng("bitflip", step))
            raise StateCorruption(f"injected bit-flip at step {step}")
        if self._fire("exp", c.corrupt_exp_at, step):
            corrupt_leaf(state, self._rng("exp", step), exponent=True)
            raise StateCorruption(
                f"injected stale shard exponent at step {step}")
        return state

    def wrap(self, step_fn):
        def wrapped(state, step):
            state = self.before_step(state, step)
            return step_fn(state, step)
        return wrapped
