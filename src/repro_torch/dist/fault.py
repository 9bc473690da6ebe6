"""Fault-tolerance primitives for the training loop — the port of the
parts of `repro.dist.fault` the trainer uses (`backoff_ticks` waits for
the router slice). Three small pieces, composed by train/trainer.py:

  * HeartbeatFile — atomically-updated liveness file next to the
    checkpoints. An external supervisor (or another host in the fleet)
    reads it to decide whether this worker is alive; `stale()` is the
    poll the supervisor would run.
  * StepWatchdog — EWMA straggler detector over per-step wall-clock. On a
    real fleet a sustained straggler triggers re-slicing; here it fires a
    callback and records the event (asserted on by tests).
  * resume_or_init — the restart-idempotence entry point: restore the
    latest valid checkpoint onto a device or build fresh state. Combined
    with step-keyed data order, kill + rerun resumes bit-identically
    (tests/test_torch_train.py::test_trainer_restart_idempotent).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, List, Optional, Tuple

from repro_torch import backend

Tree = Any


def _boot_id() -> Optional[str]:
    """Identity of the current boot (Linux); None where unavailable."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as fh:
            return fh.read().strip()
    except OSError:
        return None


class HeartbeatFile:
    """Liveness beacon: {"step", "time", "mono", "boot"} JSON, atomically
    replaced.

    Staleness math runs on `mono` (time.monotonic(), CLOCK_MONOTONIC —
    shared by every process within one boot and immune to NTP steps); the
    wall-clock "time" field is kept purely for human-readable logs. A
    wall clock that jumps backwards under NTP skew must never make a live
    worker look stale (or a dead one look fresh). CLOCK_MONOTONIC is
    per-boot, so `mono` is only trusted when the beat's `boot` id matches
    the reader's (same host, same boot); a supervisor on another host, or
    a read across a reboot, falls back to the wall clock — the only
    cross-boot-comparable timestamp. A same-boot beat whose `mono` sits in
    the reader's future is non-monotonic — impossible for a beat this
    kernel produced, so the file was deserialized/copied — and clamps to
    the wall-clock fallback without the fresh-forever benefit of a
    future wall time (age_s() returns None: presumed stale)."""

    def __init__(self, directory: str, name: str = "HEARTBEAT"):
        self.dir = directory
        self.path = os.path.join(directory, name)
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"step": int(step), "time": time.time(),
                       "mono": time.monotonic(), "boot": _boot_id()}, fh)
        os.replace(tmp, self.path)       # atomic: readers never see a torn beat

    def read(self) -> Optional[dict]:
        try:
            with open(self.path) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def age_s(self) -> Optional[float]:
        b = self.read()
        if b is None:
            return None
        same_boot = ("mono" in b and b.get("boot") is not None
                     and b["boot"] == _boot_id())
        wall = b.get("time")
        if not isinstance(wall, (int, float)) or isinstance(wall, bool):
            wall = None                      # beat without a usable wall time
        if same_boot:
            age = time.monotonic() - b["mono"]
            if age >= 0.0:
                return age
            # A same-boot mono from the FUTURE is impossible for a beat
            # this kernel produced: the file was deserialized/copied (a
            # restored legacy beat, a hand-edited file). Such a beat must
            # clamp to the wall-clock fallback — and its wall time gets no
            # freshness benefit of the doubt either: if that is ALSO from
            # the future, the beat is wholly untrustworthy and must read
            # as never-beaten (stale), not fresh-forever (the max(0, ...)
            # clamp below would have pinned its age at 0 indefinitely).
            now = time.time()
            if wall is None or wall > now:
                return None
            return now - wall
        # legacy beat (no mono/boot), another host, or across a reboot:
        # wall clock is all we have. Clamp negative to 0 — NTP stepping
        # the reader's clock backwards must not make a live worker stale.
        if wall is None:
            return None
        return max(0.0, time.time() - wall)

    def stale(self, timeout_s: float = 300.0) -> bool:
        """True when the worker should be presumed dead (no beat within
        timeout, or no beat ever written)."""
        age = self.age_s()
        return age is None or age > timeout_s

    def clear(self) -> None:
        """Remove the beat file (idempotent). A supervisor calls this when
        it hands a worker's identity to a replacement process (rolling
        restart / replica recovery): the fresh process must not inherit
        the predecessor's liveness — it reads as never-beaten until its
        own first beat()."""
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


class StepWatchdog:
    """Straggler detection on step wall-clock: alarm when a step exceeds
    `factor` x the EWMA of previous steps. The first `warmup` observations
    only train the EWMA (they include compile time)."""

    def __init__(self, on_straggler: Optional[Callable] = None, *,
                 factor: float = 3.0, warmup: int = 3, alpha: float = 0.2):
        self.on_straggler = on_straggler
        self.factor = factor
        self.warmup = warmup
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.count = 0
        self.stragglers: List[Tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Record one step time; returns True if it was flagged."""
        flagged = False
        if (self.count >= self.warmup and self.ewma is not None
                and dt > self.factor * self.ewma):
            flagged = True
            self.stragglers.append((step, dt, self.ewma))
            if self.on_straggler is not None:
                self.on_straggler(step, dt, self.ewma)
        if self.ewma is None:
            self.ewma = dt
        else:
            # fold flagged steps in clamped at the alarm threshold: one
            # outlier can't poison the baseline, but a sustained slowdown
            # re-baselines instead of alarming forever
            d = min(dt, self.factor * self.ewma)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * d
        self.count += 1
        return flagged


def resume_or_init(ckpt, init_fn: Callable[[], Tree], *,
                   device=backend.DEFAULT_DEVICE) -> Tuple[int, Tree]:
    """(start_step, state): the latest checkpoint restored onto `device`,
    else (0, init_fn()). `ckpt` is a
    repro_torch.ckpt.checkpoint.CheckpointManager."""
    step = ckpt.latest_step()
    if step is None:
        return 0, init_fn()
    return ckpt.restore(step, device=device)
