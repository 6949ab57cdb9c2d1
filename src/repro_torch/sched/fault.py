"""Scheduler-side failure model: the orderly-stop exception family and
the per-device slice-level health monitor (DESIGN.md §10).

:class:`DeviceHealth` is the per-device slice-level heartbeat with a
**stall → suspect → failed** escalation ladder —
``sched.executor.DeviceExecutor.run_sliced`` arms it around every
dispatch.  :class:`FaultContained` is the exception family an ``RTJob``
absorbs as an *orderly* stop (eviction under load shedding, a failed
device) rather than an anonymous dead thread.

The trainer-side checkpoint/restart loop, the watchdog and the retry
helper of ``repro.sched.fault`` wait for the port's checkpointer.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple


class StallError(RuntimeError):
    pass


class FaultContained(RuntimeError):
    """Base of the orderly-stop exception family: raised through a job
    body when the platform (not the job) decided the job must stop —
    ``RTJob`` catches it, records the reason, and ends the job cleanly
    instead of leaking a dead thread (no silent job loss)."""


class JobEvicted(FaultContained):
    """The job was evicted mid-segment (load shedding / drain): its
    latest checkpointed carry is the resume point."""


class DeviceFailedError(FaultContained):
    """The device this job is bound to was declared failed; the cluster
    re-runs the job's admission against the surviving devices."""


# --------------------------------------------------------------------------
# per-device health: slice-level heartbeat + stall→suspect→failed ladder
# --------------------------------------------------------------------------

HEALTHY, SUSPECT, FAILED = "healthy", "suspect", "failed"


@dataclass
class HealthConfig:
    """Escalation thresholds for :class:`DeviceHealth` (DESIGN.md §10).

    A slice in flight longer than ``stall_timeout_s`` without a beat
    moves the device to *suspect*; a suspect device that still has not
    beaten after another ``fail_timeout_s`` is declared *failed*.  A beat
    while suspect de-escalates back to healthy.  ``error_threshold``
    slice exceptions (cumulative) also declare the device failed.
    ``poll_interval_s`` is the cluster health monitor's cadence;
    ``auto_failover`` lets the monitor call
    ``ClusterExecutor.fail_device`` itself on a failed verdict.  A
    fail-over bumps the binding epoch and reassigns the controller's
    admitted set wholesale, which drops its warm-start WCRT cache
    (removal is the unsound seed direction, DESIGN.md §11); the
    re-admission sweep that rebinds survivors repopulates it."""
    stall_timeout_s: float = 5.0
    fail_timeout_s: float = 5.0
    error_threshold: int = 3
    poll_interval_s: float = 0.1
    auto_failover: bool = True


class DeviceHealth:
    """Slice-level health of one device executor.

    Armed only while a dispatch is in flight (an idle device is not
    stalling); every slice completion beats.  ``check()`` advances the
    stall → suspect → failed ladder and returns the current state —
    transitions are recorded in ``transitions`` for the audit trail."""

    def __init__(self, device: int, config: Optional[HealthConfig] = None):
        self.device = device
        self.config = config or HealthConfig()
        self.state = HEALTHY
        self.errors: List[str] = []
        self.transitions: List[Tuple[float, str, str, str]] = []
        self._lock = threading.Lock()
        self._inflight: Optional[Tuple[str, int]] = None  # (job, slice)
        self._last_beat = time.monotonic()
        self._suspect_since: Optional[float] = None

    # -- executor-side hooks (called around every dispatch) -------------
    def slice_begin(self, job: str, slice_idx: int) -> None:
        with self._lock:
            self._inflight = (job, slice_idx)
            self._last_beat = time.monotonic()

    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            if self.state == SUSPECT:
                # the ladder runs both ways: a beat from a recovered
                # device clears the suspicion (cf. Heartbeat.beat)
                self._to(HEALTHY, "beat received while suspect")
                self._suspect_since = None

    def slice_end(self) -> None:
        with self._lock:
            self._inflight = None
            self._last_beat = time.monotonic()
            if self.state == SUSPECT:
                self._to(HEALTHY, "slice completed while suspect")
                self._suspect_since = None

    def record_error(self, job: str, exc: BaseException) -> None:
        with self._lock:
            self.errors.append(f"{job}: {type(exc).__name__}: {exc}")
            if (self.state != FAILED
                    and len(self.errors) >= self.config.error_threshold):
                self._to(FAILED,
                         f"{len(self.errors)} slice exceptions "
                         f"(threshold {self.config.error_threshold})")

    # -- monitor-side ----------------------------------------------------
    def check(self, now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state == FAILED or self._inflight is None:
                return self.state
            stale = now - self._last_beat
            if self.state == HEALTHY \
                    and stale > self.config.stall_timeout_s:
                job, s = self._inflight
                self._to(SUSPECT, f"slice {s} of {job!r} stalled "
                                  f"{stale:.2f}s")
                self._suspect_since = now
            elif self.state == SUSPECT and self._suspect_since is not None \
                    and now - self._suspect_since \
                    > self.config.fail_timeout_s:
                job, s = self._inflight
                self._to(FAILED, f"slice {s} of {job!r} still stalled "
                                 f"{stale:.2f}s after suspect")
            return self.state

    @property
    def reason(self) -> str:
        return self.transitions[-1][3] if self.transitions else ""

    def _to(self, state: str, why: str) -> None:
        # caller holds self._lock
        self.transitions.append((time.monotonic(), self.state, state, why))
        self.state = state
