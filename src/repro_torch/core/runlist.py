"""Runlist / TSG model (Sec. II) and the baseline GPU arbitration policies.

The Tegra driver associates each process with a TSG (time-sliced group of
channels); active TSGs are placed on the *runlist*, which the GPU hardware
schedules round-robin with per-TSG time slices.  We model exactly the state
the scheduling approaches manipulate:

  * ``TSG``      — one per job in flight (pid, priority, active flag).
  * ``Runlist``  — the set of schedulable TSGs + round-robin rotation state
                   of ONE device.
  * ``Platform`` — N devices, each with its own runlist (DESIGN.md §4);
                   tasks carry a ``device`` index (default 0), and the
                   engine instantiates one policy per device.

Policies built directly on this model:
  * ``UnmanagedPolicy`` — the default driver: every active TSG is on the
    runlist; time-sliced round-robin, no priority, no preemption (Table I
    row 1).
  * ``SyncPolicy``      — synchronization-based GPU access control (MPCP /
    FMLP+ style): the GPU is a mutually exclusive resource; a task acquires
    the lock for the whole GPU segment; the queue is priority-ordered (MPCP)
    or FIFO (FMLP+); lock holders are priority-boosted on their core.

Both also implement the runtime face of ``SchedulingPolicy``, so the
device executor can run them by name from the registry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .policy import SchedulingPolicy, job_priority, register_policy


BOOST = 10_000_000  # priority boost for lock holders (global ceiling model)


@dataclass
class TSG:
    job: "Job"
    priority: int
    active: bool = True  # has submitted work (job in flight)


class Runlist:
    """Round-robin runlist: rotation over member TSGs with a time slice."""

    def __init__(self, slice_ms: float = 2.0):
        self.slice_ms = slice_ms
        self.members: list[TSG] = []
        self.rr_pos: int = 0
        self.slice_left: float = slice_ms

    def add(self, tsg: TSG) -> None:
        if tsg not in self.members:
            self.members.append(tsg)

    def remove(self, tsg: TSG) -> None:
        if tsg in self.members:
            idx = self.members.index(tsg)
            self.members.remove(tsg)
            if idx < self.rr_pos:
                self.rr_pos -= 1
            if self.rr_pos >= len(self.members):
                self.rr_pos = 0
                self.slice_left = self.slice_ms

    def clear(self) -> None:
        self.members.clear()
        self.rr_pos = 0
        self.slice_left = self.slice_ms

    def runnable(self) -> list[TSG]:
        """TSGs whose job currently has an active pure-GPU piece."""
        return [m for m in self.members
                if m.job.wants_gpu() and not m.job.done]

    def current(self) -> Optional[TSG]:
        run = self.runnable()
        if not run:
            return None
        # rotate rr_pos to the next runnable member
        n = len(self.members)
        for k in range(n):
            cand = self.members[(self.rr_pos + k) % n]
            if cand in run:
                if k != 0:  # moved on: fresh slice
                    self.rr_pos = (self.rr_pos + k) % n
                    self.slice_left = self.slice_ms
                return cand
        return None

    def advance(self, dt: float) -> None:
        self.slice_left -= dt
        if self.slice_left <= 1e-12:
            self.rr_pos = (self.rr_pos + 1) % max(len(self.members), 1)
            self.slice_left = self.slice_ms


class Platform:
    """N accelerators, one runlist each.  ``devices[d]`` is the hardware
    scheduling state of device d; policies layer their arbitration on top."""

    def __init__(self, n_devices: int = 1, slice_ms: float = 2.0):
        self.devices: List[Runlist] = [Runlist(slice_ms)
                                       for _ in range(n_devices)]

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, d: int) -> Runlist:
        return self.devices[d]


class UnmanagedPolicy(SchedulingPolicy):
    """Default driver: time-sliced round-robin over all active TSGs."""

    name = "unmanaged"

    def __init__(self, slice_ms: float = 2.0):
        self.runlist = Runlist(slice_ms)
        self.tsgs: dict[int, TSG] = {}

    def on_job_release(self, job: "Job") -> None:
        tsg = TSG(job=job, priority=0)
        self.tsgs[job.uid] = tsg
        self.runlist.add(tsg)

    def on_job_complete(self, job: "Job") -> None:
        tsg = self.tsgs.pop(job.uid, None)
        if tsg:
            self.runlist.remove(tsg)

    def gpu_owner(self) -> Optional["Job"]:
        cur = self.runlist.current()
        return cur.job if cur else None

    def gpu_rr_advance(self, dt: float) -> None:
        if len(self.runlist.runnable()) > 1:
            self.runlist.advance(dt)

    def next_gpu_event(self) -> float:
        if len(self.runlist.runnable()) > 1:
            return max(self.runlist.slice_left, 1e-9)
        return float("inf")

    # runtime face: the default driver admits everything, always.


class SyncPolicy(SchedulingPolicy):
    """Synchronization-based access control (MPCP-like / FMLP+-like).

    The GPU segment (G^m + G^e) is a critical section under a global lock.
    ``order='priority'`` models MPCP, ``order='fifo'`` models FMLP+.
    Lock holders are priority-boosted on their core.
    """

    name = "sync"
    needs_segment_hooks = True

    def __init__(self, order: str = "priority"):
        assert order in ("priority", "fifo")
        self.order = order
        self.holder: Optional["Job"] = None
        self.queue: list["Job"] = []  # waiting jobs

    # ---- shared lock mechanics (simulator Jobs or runtime RTJobs) --------
    def _lock_acquire(self, job) -> bool:
        """Returns True if the lock was granted immediately."""
        if self.holder is None:
            self.holder = job
            return True
        self.queue.append(job)
        return False

    def _lock_release(self) -> None:
        self.holder = None
        if self.queue:
            if self.order == "priority":
                self.queue.sort(key=lambda j: -job_priority(j))
            self.holder = self.queue.pop(0)

    # ---- simulator face ---------------------------------------------------
    def on_segment_begin(self, job: "Job") -> None:
        if not self._lock_acquire(job):
            job.lock_wait = True

    def on_ge_complete(self, job: "Job") -> None:
        assert self.holder is job, "lock released by non-holder"
        self._lock_release()
        if self.holder is not None:
            self.holder.lock_wait = False

    def on_job_complete(self, job: "Job") -> None:
        if job in self.queue:
            self.queue.remove(job)

    def gpu_owner(self) -> Optional["Job"]:
        if self.holder is not None and self.holder.wants_gpu():
            return self.holder
        return None

    def effective_priority(self, job: "Job") -> int:
        if job is self.holder:
            return BOOST + job.task.priority
        return job.task.priority

    def cpu_blocked(self, job: "Job") -> bool:
        # waiting for the lock: blocked unless busy-waiting (sim handles
        # busy-wait CPU occupancy separately)
        return job.lock_wait and self.sim.mode == "suspend"

    # ---- runtime face -----------------------------------------------------
    def runtime_segment_begin(self, job) -> bool:
        self._lock_acquire(job)
        return False  # lock handoff is not a runlist rewrite

    def runtime_segment_end(self, job) -> bool:
        if self.holder is job:
            self._lock_release()
        elif job in self.queue:
            self.queue.remove(job)
        return False

    def runtime_on_complete(self, job) -> None:
        if self.holder is job:
            self._lock_release()
        if job in self.queue:
            self.queue.remove(job)

    def runtime_admitted(self, job) -> bool:
        return self.holder is None or self.holder is job


register_policy("unmanaged", UnmanagedPolicy,
                "default driver: time-sliced RR, no priority (Table I)")
register_policy("sync_priority",
                lambda **kw: SyncPolicy(order="priority", **kw),
                "MPCP-style lock-based GPU access, priority queue")
register_policy("sync_fifo",
                lambda **kw: SyncPolicy(order="fifo", **kw),
                "FMLP+-style lock-based GPU access, FIFO queue")

__all__ = ["TSG", "Runlist", "Platform", "UnmanagedPolicy", "SyncPolicy",
           "BOOST"]
