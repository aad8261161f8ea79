"""Fault-tolerant checkpointing.

Counterpart of ``repro/train/checkpoint.py``, in its on-disk format, so a
checkpoint written by either package restores in the other:

* one ``.npy`` per leaf (``leaf_00000.npy`` ...), a ``manifest.json``
  with each leaf's ``file``, ``dtype``, ``shape`` and ``crc32`` under its
  dotted name — the reference's ``_flatten_with_names``: dict keys in
  sorted order, ``NamedTuple`` fields (``opt.step``, ``opt.m.<param>``),
  sequence indices, and a ``QTensor``'s two fields (``opt.m.<param>.m``,
  ``.exp``);
* **atomic** — written into ``step_K.tmp-<pid>-<ms>/`` then
  ``os.replace``d to ``step_K/``, so a crash mid-write never leaves a
  broken newest checkpoint;
* **keep-k retention**, never deleting the newest complete step;
* restore checks every leaf's crc32 (flipped bytes raise
  :class:`CheckpointCorruption`, and so does **any** failure to parse a
  leaf: flipped bytes in a ``.npy`` header make ``np.load`` raise more
  than ``OSError`` / ``ValueError``), its shape, and that its dtype casts
  ``same_kind`` into the ``like`` leaf's (an FP32-moment checkpoint does
  not load into int8 planes); tensors land on the ``like`` leaves'
  devices.  Leaves are read by the names of the ``like`` tree, so extra
  leaves in a checkpoint (the port's launcher saves its generator's state
  as ``rng``) are ignored.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import qtensor

log = logging.getLogger("repro_torch.checkpoint")

_MANIFEST = "manifest.json"


class CheckpointCorruption(RuntimeError):
    """A saved leaf fails its manifest checksum (flipped bytes on disk) or
    cannot be parsed — restore from an older retained step."""


def _named_leaves(tree: Any, prefix: str = "") -> list:
    """``[(dotted name, leaf)]`` in ``jax.tree`` order."""
    def join(k):
        return f"{prefix}.{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k],
                                                               join(k))]
    if qtensor.is_qtensor(tree):
        return [(join("m"), tree.m), (join("exp"), tree.exp)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _named_leaves(getattr(tree, f), join(f))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, join(i))]
    return [] if tree is None else [(prefix, tree)]


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if qtensor.is_qtensor(tree):
        return qtensor.QTensor(m=next(it), exp=next(it), bits=tree.bits)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), it)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return None if tree is None else next(it)


def _as_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    # crc32 of the raw array bytes, as the reference's tobytes(), without
    # a copy of a contiguous array
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _np_dtype(ref: Any):
    if isinstance(ref, torch.Tensor):
        return torch.empty((), dtype=ref.dtype).numpy().dtype
    return getattr(ref, "dtype", None)


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         *, keep: int = 3) -> str:
    """state: dict of trees (e.g. {"params": ..., "opt": ..., "data": ...})
    of tensors, QTensors, numpy arrays and Python numbers."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + f".tmp-{os.getpid()}-{int(time.time() * 1e3)}"
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "treedef": sorted(state)}
    for i, (name, leaf) in enumerate(_named_leaves(state)):
        arr = _as_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {"file": fname, "dtype": str(arr.dtype),
                                    "shape": list(arr.shape),
                                    "crc32": _crc(arr)}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # leaked temp dirs from crashed writers
    for d in os.listdir(ckpt_dir):
        if ".tmp-" in d:
            full = os.path.join(ckpt_dir, d)
            if time.time() - os.path.getmtime(full) > 3600:
                shutil.rmtree(full, ignore_errors=True)


def _steps_on_disk(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and ".tmp" not in d)


def verify_manifest(ckpt_dir: str, step: int) -> bool:
    """Structural check of one checkpoint: the manifest parses and every
    listed leaf file exists (the full crc check happens at restore)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        for name, entry in manifest["leaves"].items():
            fname = entry["file"] if isinstance(entry, dict) else entry
            if not os.path.isfile(os.path.join(path, fname)):
                return False
    except (OSError, ValueError, KeyError, TypeError):
        return False
    return True


def latest_step(ckpt_dir: str, *, verify: bool = True) -> Optional[int]:
    """Newest step whose manifest verifies (``verify=False``: newest by
    name)."""
    for step in reversed(_steps_on_disk(ckpt_dir)):
        if not verify or verify_manifest(ckpt_dir, step):
            return step
        log.warning("checkpoint step %d fails manifest verification; "
                    "skipping", step)
    return None


def _load_leaf(path: str, step: int, name: str, fname: str) -> np.ndarray:
    try:
        return np.load(os.path.join(path, fname), mmap_mode="r")
    except Exception as e:     # noqa: BLE001 — any unparseable leaf
        # flipped bytes can land in the .npy header as well as the data,
        # and the header parser raises more than OSError / ValueError
        raise CheckpointCorruption(
            f"step {step} leaf {name!r} ({fname}): unreadable "
            f"({type(e).__name__}: {e})") from e


def restore(ckpt_dir: str, step: int, like: Dict[str, Any], *,
            verify: bool = True) -> Dict[str, Any]:
    """Restore into the structure of ``like``: tensors on the ``like``
    leaves' devices and dtypes, numpy arrays, Python numbers.  With
    ``verify`` (default) every leaf's bytes are checked against the
    manifest's crc32; a mismatch raises :class:`CheckpointCorruption`
    (``restore_latest`` then falls back to an older step)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    out = []
    for name, ref in _named_leaves(like):
        entry = manifest["leaves"].get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        fname = entry["file"] if isinstance(entry, dict) else entry
        arr = _load_leaf(path, step, name, fname)
        if verify and isinstance(entry, dict) and "crc32" in entry:
            crc = _crc(arr)
            if crc != entry["crc32"]:
                raise CheckpointCorruption(
                    f"step {step} leaf {name!r} ({fname}): stored crc32 "
                    f"{entry['crc32']:#010x} != on-disk {crc:#010x} — "
                    "bytes flipped since save")
        shape = getattr(ref, "shape", None)
        if shape is not None and tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: saved {arr.shape} != expected "
                             f"{tuple(shape)}")
        dt = _np_dtype(ref)
        if (dt is not None and arr.dtype != dt
                and not np.can_cast(arr.dtype, dt, casting="same_kind")):
            raise ValueError(
                f"{name}: saved dtype {arr.dtype} cannot restore into {dt} "
                "— the checkpoint's state layout does not match (e.g. FP32 "
                "moments into a quantized state_bits optimizer); restore "
                "with the matching OptimizerConfig or re-init the "
                "optimizer state")
        if isinstance(ref, torch.Tensor):
            out.append(torch.from_numpy(np.array(arr, dtype=dt)).to(
                ref.device))
        elif isinstance(ref, (bool, int, float)):
            out.append(type(ref)(arr.item()))
        else:
            out.append(np.array(arr) if dt is None
                       else np.array(arr, dtype=dt))
    return _rebuild(like, iter(out))


def restore_latest(ckpt_dir: str, like: Dict[str, Any],
                   on_event: Optional[Callable[[dict], None]] = None
                   ) -> Optional[tuple]:
    """Restore the newest checkpoint that verifies, walking backwards over
    retained steps on corruption.  Returns ``(state, step)`` or ``None``
    when no usable checkpoint exists.  Emits
    ``{"type": "ckpt-corrupt", "step": k}`` per rejected step."""
    for step in reversed(_steps_on_disk(ckpt_dir)):
        if not verify_manifest(ckpt_dir, step):
            log.warning("checkpoint step %d: manifest broken; trying "
                        "previous", step)
            if on_event is not None:
                on_event({"type": "ckpt-corrupt", "step": step})
            continue
        try:
            return restore(ckpt_dir, step, like), step
        except CheckpointCorruption as e:
            log.warning("checkpoint step %d corrupt (%s); trying previous",
                        step, e)
            if on_event is not None:
                on_event({"type": "ckpt-corrupt", "step": step})
    return None
