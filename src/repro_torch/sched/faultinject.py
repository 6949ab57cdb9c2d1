"""Deterministic fault injection for the scheduling runtime
(DESIGN.md §10).

The chaos suite must be able to make a specific device hang on a
specific slice of a specific job, make a slice raise, or SIGKILL the
daemon process mid-slice — deterministically, on any host, without
patching executor internals.  This module is that seam:

  * :class:`FaultSpec` — one planned fault: *where* (device / job /
    slice index match, each optional) and *what* (``hang`` for
    ``hang_s`` seconds inside the device lock, ``raise`` an
    :class:`InjectedFault` from the slice, ``kill`` the process with
    SIGKILL — no cleanup whatsoever, exactly like a machine check).
  * :class:`FaultInjector` — the plan holder.
    ``DeviceExecutor.run_sliced``/``run`` call :meth:`fire` at every
    dispatch; specs fire at most once unless ``once=False``.
  * ``from_env()`` — subprocess activation: ``REPRO_FAULT_PLAN`` holds
    either inline JSON or a path to a JSON file, so a *daemon under
    test* injects its own faults with no test hooks in the daemon code.

Injection is a no-op unless a plan is explicitly installed (constructor
argument or environment variable), so production paths pay one ``is
None`` check per dispatch.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Union

ENV_PLAN = "REPRO_FAULT_PLAN"

KINDS = ("hang", "raise", "kill")


class InjectedFault(RuntimeError):
    """The exception a ``raise``-kind spec throws from inside a slice —
    deliberately a *generic* runtime error (not ``FaultContained``), so
    it exercises the same containment path a real kernel failure
    would."""


@dataclass
class FaultSpec:
    """One planned fault.  ``device``/``job``/``slice_idx`` are match
    filters (``None`` matches anything); ``after_matches`` skips the
    first N matching dispatches before firing."""
    kind: str
    device: Optional[int] = None
    job: Optional[str] = None
    slice_idx: Optional[int] = None
    after_matches: int = 0
    hang_s: float = 0.0
    once: bool = True
    fired: int = field(default=0, repr=False)
    _seen: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(available: {KINDS})")

    def matches(self, device: int, job: str, slice_idx: int) -> bool:
        if self.once and self.fired:
            return False
        if self.device is not None and device != self.device:
            return False
        if self.job is not None and job != self.job:
            return False
        if self.slice_idx is not None and slice_idx != self.slice_idx:
            return False
        if self._seen < self.after_matches:
            self._seen += 1
            return False
        return True

    @classmethod
    def from_dict(cls, d: Mapping) -> "FaultSpec":
        return cls(**{k: v for k, v in dict(d).items()
                      if not k.startswith("_") and k != "fired"})


class FaultInjector:
    """Holds the plan; executors call :meth:`fire` at every dispatch."""

    def __init__(self, specs: Sequence[Union[FaultSpec, Mapping]] = ()):
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s)
            for s in specs]
        self.log: List[dict] = []          # every fired fault, audited
        self._lock = threading.Lock()

    def add(self, spec: Union[FaultSpec, Mapping]) -> "FaultInjector":
        with self._lock:
            self.specs.append(spec if isinstance(spec, FaultSpec)
                              else FaultSpec.from_dict(spec))
        return self

    def fire(self, *, device: int, job: str, slice_idx: int) -> None:
        """Called by the executor inside the device lock, immediately
        before the slice dispatch.  A ``hang`` sleeps here (the slice
        heartbeat stays armed, exactly like a hung kernel); a ``raise``
        throws :class:`InjectedFault`; a ``kill`` SIGKILLs the process
        — the journal's last fsync'd record is the recovery point."""
        with self._lock:
            hit = next((s for s in self.specs
                        if s.matches(device, job, slice_idx)), None)
            if hit is None:
                return
            hit.fired += 1
            self.log.append({"kind": hit.kind, "device": device,
                             "job": job, "slice": slice_idx,
                             "t": time.monotonic()})
        if hit.kind == "hang":
            time.sleep(hit.hang_s)
        elif hit.kind == "raise":
            raise InjectedFault(
                f"injected slice exception (device {device}, job "
                f"{job!r}, slice {slice_idx})")
        elif hit.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)

    def fired(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [e for e in self.log
                    if kind is None or e["kind"] == kind]


def from_env(environ: Optional[Mapping] = None) -> Optional[FaultInjector]:
    """Build the process-wide injector from ``$REPRO_FAULT_PLAN``
    (inline JSON — a list of spec dicts — or a path to a JSON file);
    ``None`` when unset, which is the production fast path."""
    env = os.environ if environ is None else environ
    raw = env.get(ENV_PLAN)
    if not raw:
        return None
    raw = raw.strip()
    if raw.startswith("[") or raw.startswith("{"):
        plan = json.loads(raw)
    else:
        with open(raw, encoding="utf-8") as f:
            plan = json.load(f)
    if isinstance(plan, Mapping):
        plan = [plan]
    return FaultInjector(plan)
