"""Numerics health counters — the runtime sentinel's eyes.

Counterpart of ``repro/core/health.py``.  Integer call sites of the model
report the health of the tensor they are about to quantize
(``dfx.health_stats``: clip rate at the quantizer's saturation point,
mantissa zero-fraction, step exponent, non-finite count).  The counters
are plain PyTorch reductions over tensors already on the device: no
kernel launch.

``collect()`` installs a sink for a block; ``probe()`` records into it and
does nothing at all when no sink is installed or probes are suspended.
Tags are the call site's scope path with layer indices wildcarded
(``blocks.3.attn`` → ``blocks.*.attn``), so every layer of a run reports
under one key, reduced as ``REDUCTIONS`` says.

The reference also has ``frame`` / ``harvest`` / ``record_stacked``: a
value computed inside a ``lax.scan`` or ``jax.checkpoint`` body cannot
leave it through a Python global, so its layers return their counters as
the scan's output.  The port's layer loop is plain Python and its probes
go straight to the sink, so those have no counterpart.  A per-layer remat
recompute (``lm._remat``) runs under ``suspend()``, so a layer is
counted once (``nonfinite`` is a sum).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import dfx

__all__ = ["collect", "suspend", "active", "probe", "merge", "summarize",
           "canonical_tag", "stats", "REDUCTIONS"]

#: counter name -> how two observations of one tag combine
REDUCTIONS = {"clip": torch.maximum, "zero": torch.maximum,
              "nonfinite": torch.add, "exp": torch.maximum}

Stats = Dict[str, torch.Tensor]

_SINK: Optional[Dict[str, Stats]] = None
_SUSPENDED: int = 0

#: counters of quantizing a tensor (the quantizer's own clip / step rule)
stats = dfx.health_stats


def active() -> bool:
    """True when a probe would record (a sink installed, not suspended)."""
    return _SINK is not None and _SUSPENDED == 0


def _merge_into(sink: Dict[str, Stats], tag: str, s: Stats) -> None:
    prev = sink.get(tag)
    sink[tag] = dict(s) if prev is None else {
        k: REDUCTIONS[k](prev[k], s[k]) for k in REDUCTIONS}


def canonical_tag(path: Tuple[str, ...]) -> str:
    """Dotted tag with layer indices wildcarded (``blocks.3`` and
    ``blocks.-1`` → ``blocks.*``)."""
    def wild(seg: str) -> str:
        s = seg[1:] if seg.startswith("-") else seg
        return "*" if s.isdigit() else seg
    return ".".join(wild(s) for s in path)


def probe(path: Tuple[str, ...], x: torch.Tensor, bits: int) -> None:
    """Record the counters of ``x`` at ``bits`` under ``path``; nothing
    when inactive."""
    if not active():
        return
    _merge_into(_SINK, canonical_tag(path), stats(x, bits))


class collect:
    """Install a health sink for the block; yields the tag -> stats dict."""

    def __enter__(self) -> Dict[str, Stats]:
        global _SINK
        self._prev = _SINK
        self.health: Dict[str, Stats] = {}
        _SINK = self.health
        return self.health

    def __exit__(self, *exc):
        global _SINK
        _SINK = self._prev
        return False


class suspend:
    """Mask probes for the block (a remat recompute)."""

    def __enter__(self):
        global _SUSPENDED
        _SUSPENDED += 1
        return self

    def __exit__(self, *exc):
        global _SUSPENDED
        _SUSPENDED -= 1
        return False


def merge(a: Dict[str, Stats], b: Dict[str, Stats]) -> Dict[str, Stats]:
    """Merge two health dicts (the probes' reductions)."""
    out = {t: dict(s) for t, s in a.items()}
    for t, s in b.items():
        _merge_into(out, t, s)
    return out


def summarize(health: Dict[str, Stats]) -> Stats:
    """Whole-model scalars: max clip / zero rate, total non-finite count."""
    if not health:
        z = torch.zeros((), dtype=torch.float32)
        return {"clip": z, "zero": z, "nonfinite": z}
    vals = list(health.values())
    return {"clip": torch.stack([s["clip"] for s in vals]).max(),
            "zero": torch.stack([s["zero"] for s in vals]).max(),
            "nonfinite": torch.stack([s["nonfinite"] for s in vals]).sum()}
