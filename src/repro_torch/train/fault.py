"""Fault-tolerance harness for the step loop.

Counterpart of ``repro/train/fault.py``, pure Python as it is.  The pieces
are dependency-free, so the same loop drives one device here and each
worker of a cluster launcher:

* **retry-with-restore** — a step that raises (preemption, collective
  timeout, numerical assert) triggers restore-from-latest-checkpoint and
  replay; bounded retries then re-raise for the cluster scheduler to
  reschedule.
* **heartbeat file** — touched every step *and during recovery* (an
  external watchdog must not kill a worker that is mid-restore); the write
  is atomic (tmp + ``os.replace``) so the watchdog never reads a torn file.
* **straggler monitor** — EWMA of step wall-time; steps slower than
  ``threshold×`` EWMA are logged with their step index so slow hosts can be
  cordoned.  The first ``warmup_steps`` observations are ignored entirely —
  the compile-dominated first step would otherwise seed the EWMA orders of
  magnitude high and mask real stragglers for hundreds of steps.
* **structured events** — retries, restores and straggler flags are emitted
  through an ``on_event`` callback (dicts with a ``type`` key), which the
  launcher logs and the chaos tests read.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

log = logging.getLogger("repro_torch.fault")

Event = Dict[str, Any]


@dataclasses.dataclass
class FaultConfig:
    max_retries: int = 3
    heartbeat_path: Optional[str] = None
    straggler_threshold: float = 2.0
    ewma_alpha: float = 0.1
    #: observations discarded before the EWMA seeds (compile-dominated
    #: first step(s) must not define "normal")
    warmup_steps: int = 1


class StragglerMonitor:
    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.ewma: Optional[float] = None
        self.flagged: list[tuple[int, float]] = []
        self._seen = 0

    def observe(self, step: int, dt: float) -> bool:
        self._seen += 1
        if self._seen <= self.cfg.warmup_steps:
            return False                  # warmup: never seeds, never flags
        slow = False
        if (self.ewma is not None
                and dt > self.cfg.straggler_threshold * self.ewma):
            self.flagged.append((step, dt))
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, self.ewma)
            slow = True
        a = self.cfg.ewma_alpha
        self.ewma = dt if self.ewma is None else (1 - a) * self.ewma + a * dt
        return slow


def heartbeat(cfg: FaultConfig) -> None:
    """Atomic liveness touch: write-tmp + ``os.replace`` — a watchdog
    polling the file never observes a partial write."""
    if cfg.heartbeat_path:
        tmp = f"{cfg.heartbeat_path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, cfg.heartbeat_path)


def run_with_recovery(
    step_fn: Callable[[Any, int], Any],
    state: Any,
    *,
    start_step: int,
    num_steps: int,
    fault_cfg: FaultConfig = FaultConfig(),
    save_fn: Optional[Callable[[Any, int], None]] = None,
    restore_fn: Optional[Callable[[], tuple[Any, int]]] = None,
    save_every: int = 100,
    on_event: Optional[Callable[[Event], None]] = None,
) -> Any:
    """Drives ``state = step_fn(state, step)`` with checkpoint/restart.

    ``restore_fn`` returns (state, step) from the latest durable checkpoint;
    after ``max_retries`` consecutive failures the exception propagates (the
    cluster scheduler owns node replacement).  ``on_event`` receives
    ``{"type": "retry"|"restore"|"straggler", ...}`` dicts as they happen.
    """
    def emit(ev: Event) -> None:
        if on_event is not None:
            on_event(ev)

    monitor = StragglerMonitor(fault_cfg)
    step = start_step
    retries = 0
    while step < start_step + num_steps:
        t0 = time.time()
        try:
            state = step_fn(state, step)
            retries = 0
        except Exception as e:          # noqa: BLE001 — deliberate catch-all
            retries += 1
            log.error("step %d failed (%s); retry %d/%d",
                      step, type(e).__name__, retries, fault_cfg.max_retries)
            emit({"type": "retry", "step": step, "retries": retries,
                  "error": type(e).__name__})
            # the watchdog must see liveness while we restore — recovery of
            # a big checkpoint can take longer than the kill interval
            heartbeat(fault_cfg)
            if retries > fault_cfg.max_retries or restore_fn is None:
                raise
            state, step = restore_fn()
            emit({"type": "restore", "step": step})
            heartbeat(fault_cfg)
            continue
        if monitor.observe(step, time.time() - t0):
            emit({"type": "straggler", "step": step,
                  "dt": monitor.flagged[-1][1]})
        heartbeat(fault_cfg)
        step += 1
        if save_fn is not None and step % save_every == 0:
            save_fn(state, step)
    return state
