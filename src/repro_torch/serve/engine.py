"""Batched serving engine: chunked prefill + decode over a KV cache and a
continuous-batching slot scheduler.

Counterpart of ``repro/serve/engine.py`` (dense family).  The reference
jits ``lm_prefill_cache`` / ``lm_decode_step``; here they run eagerly under
``torch.no_grad()``, and the KV cache is updated in place, so admission
snapshots the cache by copy where the reference keeps the old immutable
value.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.qpolicy import QuantLike
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 2048
    batch_slots: int = 8
    temperature: float = 0.0          # 0 => greedy
    eos_id: int = -1                  # -1 => never stop early
    cache_dtype: torch.dtype = torch.float32   # or a name ("bfloat16", ...)
    #: bounded admission queue: ``submit`` raises :class:`QueueFull` beyond
    max_queue: int = 64
    #: default per-request deadline (seconds from submit); None = none
    default_deadline_s: Optional[float] = None

    def __post_init__(self):
        if isinstance(self.cache_dtype, str):
            # config files name dtypes as strings, as in the reference
            dtype = getattr(torch, self.cache_dtype, None)
            if not isinstance(dtype, torch.dtype):
                raise ValueError(f"unknown cache_dtype {self.cache_dtype!r}")
            self.cache_dtype = dtype


class QueueFull(RuntimeError):
    """Admission queue at capacity (``ServeConfig.max_queue``)."""


class Engine:
    """Owns params, config and the prefill / decode entry points.  Decoding
    is greedy unless ``ServeConfig.temperature > 0`` and the caller hands
    ``generate`` a ``torch.Generator``; the batcher is always greedy."""

    def __init__(self, params, cfg: ArchConfig, qcfg: QuantLike,
                 scfg: ServeConfig, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg
        self.scfg = scfg
        self.device = lm.resolve_device(device)

    @torch.no_grad()
    def _prefill(self, params, tokens: torch.Tensor, cache):
        return lm.lm_prefill_cache(params, tokens, cache, self.cfg, self.qcfg)

    @torch.no_grad()
    def _decode(self, params, token: torch.Tensor, cache):
        return lm.lm_decode_step(params, token, cache, self.cfg, self.qcfg)

    def init_cache(self, batch: int):
        return lm.init_cache(self.cfg, batch, self.scfg.max_seq,
                             dtype=self.scfg.cache_dtype, device=self.device)

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 gen: Optional[torch.Generator] = None) -> np.ndarray:
        """Single-shot batched generation: prompts (B, S) int32, left-aligned
        and of one length; one prefill, then ``max_new_tokens`` decode
        steps.  Returns (B, max_new_tokens) int32.  ``gen`` (a generator on
        the engine's device) draws the samples when the temperature is
        positive; each step takes the next numbers of its stream, where the
        reference folds the step index into its key."""
        prompts = np.asarray(prompts, dtype=np.int32)
        cache = self.init_cache(prompts.shape[0])
        logits, cache = self._prefill(
            self.params, torch.as_tensor(prompts, device=self.device), cache)
        out = []
        for _ in range(max_new_tokens):
            nxt = self._sample(logits, gen)
            out.append(nxt.cpu().numpy())
            logits, cache = self._decode(self.params, nxt, cache)
        return np.concatenate(out, axis=1)

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Next token per row, (B, 1) int32: drawn from
        ``softmax(logits / temperature)`` with ``gen``, or greedy when the
        temperature is 0 or no generator is given."""
        logits = logits[:, -1, : self.cfg.vocab]
        if self.scfg.temperature <= 0 or gen is None:
            return logits.argmax(-1, keepdim=True).to(torch.int32)
        probs = torch.softmax(logits.float() / self.scfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    produced: int = 0
    budget: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    #: absolute ``time.monotonic()`` cutoff; None = no deadline
    deadline: Optional[float] = None


def _copy_slot(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               slot: int) -> None:
    """In place: ``dst``'s ``slot``-th batch entry := ``src``'s.  Batch is
    axis 1 for the layer-stacked k/v, axis 0 for ``index``."""
    for name, d in dst.items():
        if name == "index":
            d[slot] = src[name][slot]
        else:
            d[:, slot] = src[name][:, slot]


class ContinuousBatcher:
    """Fixed-slot continuous batching: finished sequences free their slot,
    queued requests join mid-flight.

    Admission: the batched prefill advances and rewrites every slot's cache
    row and index, so admission copies the cache first, resets the admitted
    slot to the fresh state (index 0), prefills, and then restores every
    other slot's row and index from the copy.  Active slots decode as if
    the admission never happened and the admitted slot as if alone
    (interleaved output == sequential output when rows are independent,
    i.e. with quantization disabled — an integer per-tensor scale spans
    every slot).
    """

    def __init__(self, engine: Engine):
        self.engine = engine
        scfg = engine.scfg
        self.slots = [_Slot() for _ in range(scfg.batch_slots)]
        self.queue: List[Tuple[int, np.ndarray, int, Optional[float]]] = []
        self.results: Dict[int, np.ndarray] = {}
        #: request_id -> reason for every request that did not complete
        #: normally ("deadline", "nonfinite_logits")
        self.failed: Dict[int, str] = {}
        self._next_id = 0
        B = scfg.batch_slots
        self.cache = engine.init_cache(B)
        #: pristine cache rows used to reset a slot (never written)
        self._fresh_cache = engine.init_cache(B)
        self.last_tok = torch.zeros((B, 1), dtype=torch.int32,
                                    device=engine.device)
        self._logits: Optional[torch.Tensor] = None

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request; raises :class:`QueueFull` at ``max_queue``."""
        if len(self.queue) >= self.engine.scfg.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.engine.scfg.max_queue})")
        prompt = np.asarray(prompt).astype(np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        rid = self._next_id
        self._next_id += 1
        if deadline_s is None:
            deadline_s = self.engine.scfg.default_deadline_s
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        self.queue.append((rid, prompt, max_new_tokens, deadline))
        return rid

    def _fail(self, rid: int, tokens: list, reason: str) -> None:
        self.results[rid] = np.asarray(tokens, dtype=np.int32)
        self.failed[rid] = reason

    def _evict(self, slot_id: int, reason: str) -> None:
        """Evict one slot: partial tokens become the result and the cache
        row is reset so a poisoned row cannot linger in the batch."""
        s = self.slots[slot_id]
        self._fail(s.request_id, s.tokens, reason)
        _copy_slot(self.cache, self._fresh_cache, slot_id)
        self.slots[slot_id] = _Slot()

    def _pop_live(self):
        """Next queued request whose deadline has not expired; expired
        ones fail immediately with an empty result."""
        while self.queue:
            rid, prompt, budget, deadline = self.queue.pop(0)
            if deadline is not None and time.monotonic() > deadline:
                self._fail(rid, [], "deadline")
                continue
            return rid, prompt, budget, deadline
        return None

    def _admit(self) -> None:
        eng = self.engine
        for slot_id, s in enumerate(self.slots):
            if s.active:
                continue
            nxt = self._pop_live()
            if nxt is None:
                return
            rid, prompt, budget, deadline = nxt
            snap = {k: v.clone() for k, v in self.cache.items()}
            _copy_slot(self.cache, self._fresh_cache, slot_id)
            # one chunked-prefill call: the admitted slot's prompt in its
            # row, zeros elsewhere — other rows are restored below
            toks = np.zeros((len(self.slots), len(prompt)), np.int32)
            toks[slot_id] = prompt
            logits, self.cache = eng._prefill(
                eng.params, torch.as_tensor(toks, device=eng.device),
                self.cache)
            _copy_slot(snap, self.cache, slot_id)
            self.cache = snap
            if self._logits is not None:
                merged = self._logits.clone()
                merged[slot_id] = logits[slot_id]
                logits = merged
            self.slots[slot_id] = _Slot(active=True, request_id=rid,
                                        budget=budget, deadline=deadline)
            self._logits = logits

    def step(self) -> None:
        self._admit()
        if not any(s.active for s in self.slots):
            return
        # health pass before sampling: expired deadlines and slots whose
        # logits row is non-finite are evicted; the rest keep decoding
        now = time.monotonic()
        finite = torch.isfinite(
            self._logits[:, -1, : self.engine.cfg.vocab]).all(-1).cpu()
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            if s.deadline is not None and now > s.deadline:
                self._evict(i, "deadline")
            elif not bool(finite[i]):
                self._evict(i, "nonfinite_logits")
        if not any(s.active for s in self.slots):
            return
        nxt = self.engine._sample(self._logits, None)
        nxt_np = nxt.cpu().numpy()
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            s.tokens.append(int(nxt_np[i, 0]))
            s.produced += 1
            done = s.produced >= s.budget or (
                self.engine.scfg.eos_id >= 0
                and s.tokens[-1] == self.engine.scfg.eos_id)
            if done:
                self.results[s.request_id] = np.asarray(s.tokens)
                self.slots[i] = _Slot()
        self.last_tok = nxt
        self._logits, self.cache = self.engine._decode(
            self.engine.params, self.last_tok, self.cache)

    def run_until_drained(self, max_steps: int = 100000) -> Dict[int, np.ndarray]:
        for _ in range(max_steps):
            if not self.queue and not any(s.active for s in self.slots):
                break
            self.step()
        return self.results
