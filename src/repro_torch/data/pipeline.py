"""Deterministic, resumable token pipeline (numpy).

Counterpart of ``repro/data/pipeline.py``: the same two sources behind one
iterator interface, numpy copies of the reference's, so both packages see
the same batches from the same seed.

* ``SyntheticLM`` — a deterministic pseudo-corpus made from (seed, index):
  repeated 8-token motifs with 10% noise, so a model can lower its loss.
* ``MmapTokens`` — a memory-mapped flat ``int32`` token file.

Example ``i`` belongs to host ``i % num_hosts``; each call yields a batch
of ``tokens`` and next-token ``labels`` (B, seq_len) int32.  The iterator
state is a small dict (``{"index": ...}``), so a run can resume mid-epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    batch_size: int                 # per-host batch
    seq_len: int
    vocab: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Mixture of repeated n-gram motifs (pure uniform tokens would have no
    learnable structure)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._state = {"index": 0}

    def state(self) -> Dict[str, int]:
        return dict(self._state)

    def restore(self, state: Dict[str, int]) -> None:
        self._state = dict(state)

    def _example(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, idx))
        motif_len = 8
        n_motifs = 16
        motifs = np.random.default_rng(cfg.seed).integers(
            0, cfg.vocab, size=(n_motifs, motif_len))
        picks = rng.integers(0, n_motifs, size=cfg.seq_len // motif_len + 2)
        seq = motifs[picks].reshape(-1)[: cfg.seq_len + 1]
        noise = rng.random(cfg.seq_len + 1) < 0.1
        seq = np.where(noise, rng.integers(0, cfg.vocab, cfg.seq_len + 1), seq)
        return seq.astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        base = self._state["index"]
        rows = [self._example((base + i) * cfg.num_hosts + cfg.host_id)
                for i in range(cfg.batch_size)]
        self._state["index"] = base + cfg.batch_size
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


class MmapTokens:
    """Flat token-file reader."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.n_seqs = (len(self.data) - 1) // cfg.seq_len
        self._state = {"index": 0, "epoch": 0}

    def state(self) -> Dict[str, int]:
        return dict(self._state)

    def restore(self, state: Dict[str, int]) -> None:
        self._state = dict(state)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        for i in range(cfg.batch_size):
            gidx = (self._state["index"] + i) * cfg.num_hosts + cfg.host_id
            if gidx >= self.n_seqs:
                self._state = {"index": 0, "epoch": self._state["epoch"] + 1}
                gidx = i * cfg.num_hosts + cfg.host_id
            off = gidx * cfg.seq_len
            seq = np.asarray(self.data[off: off + cfg.seq_len + 1])
            if len(seq) < cfg.seq_len + 1:
                seq = np.pad(seq, (0, cfg.seq_len + 1 - len(seq)))
            rows.append(seq.astype(np.int32))
        self._state["index"] += cfg.batch_size
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
