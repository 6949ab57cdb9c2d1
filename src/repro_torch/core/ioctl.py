"""IOCTL-based approach (Sec. V-B, Algorithm 2).

User programs bracket each GPU segment with cudaStreamBegin()/cudaStreamEnd()
macros; each call issues an IOCTL that runs the runlist-update procedure in
the driver under an rt_mutex.  In the simulator, these appear as explicit
``upd`` pieces in the job's piece sequence (cost epsilon each, executed on
the caller's core, non-preemptive — kernel path holding the driver lock —
and pausing the GPU while the runlist is rewritten).

Algorithm 2 state lives in the shared ``policy.Alg2State`` (two disjoint
lists, ``task_running`` and ``task_pending``) — the very same state machine
the runtime executor's notify mode drives, so the simulated admission and
the live admission cannot diverge (DESIGN.md §2).  One safety deviation
from the paper is noted in Alg2State: on removal with no pending real-time
task we take the union of the lists instead of overwriting task_running.

Both busy-waiting and self-suspension are supported during pure GPU
execution and while waiting for admission (Table I / Sec. VI).
"""
from __future__ import annotations

from typing import Optional

from .analysis import ioctl_busy_rta, ioctl_suspend_rta
from .policy import (Alg2State, SchedulingPolicy, job_gpu_priority,
                     job_is_rt, register_policy)
from .runlist import Runlist, TSG



class IoctlPolicy(SchedulingPolicy):
    name = "ioctl"
    needs_ioctl_pieces = True
    needs_segment_hooks = True

    def __init__(self, rr_slice: float = 2.0):
        self.alg2 = Alg2State(on_enter_running=self._enter_running,
                              on_leave_running=self._leave_running)
        self.lock_holder: Optional["Job"] = None
        self.rr = Runlist(rr_slice)        # RR among best-effort members
        self._tsgs: dict = {}

    # task_running / task_pending views (kept for API compatibility)
    @property
    def running(self) -> list:
        return self.alg2.running

    @property
    def pending(self) -> list:
        return self.alg2.pending

    # ---- rt_mutex ----------------------------------------------------------
    # The update is a kernel section: a caller must win its core (ordinary
    # priority scheduling) to *enter* the IOCTL; once entered it acquires
    # the mutex and runs non-preemptively for at most epsilon.  Contending
    # callers therefore wait at most one epsilon for a lower-priority
    # holder (the paper's (eta_i^g + 1) * epsilon blocking term), and the
    # highest-priority waiter enters next (rt_mutex ordering emerges from
    # per-core priority scheduling at acquisition instants).
    def try_acquire(self, job: "Job") -> bool:
        if self.lock_holder is None or self.lock_holder is job:
            self.lock_holder = job
            return True
        return False

    def _release_lock(self) -> None:
        self.lock_holder = None

    # ---- best-effort TSG bookkeeping (Alg2State callbacks) -----------------
    def _enter_running(self, job) -> None:
        if not job_is_rt(job):
            self.rr.add(self._tsg(job))

    def _leave_running(self, job) -> None:
        tsg = self._tsgs.get(id(job))
        if tsg:
            self.rr.remove(tsg)

    def _tsg(self, job: "Job") -> TSG:
        if id(job) not in self._tsgs:
            self._tsgs[id(job)] = TSG(job=job,
                                      priority=job_gpu_priority(job))
        return self._tsgs[id(job)]

    # ---- simulator hooks ----------------------------------------------------
    def begin_update(self, job: "Job", piece) -> None:
        """Runs when the caller acquires the rt_mutex.  Executes Algorithm 2
        and prices the IOCTL: a call that actually rewrites the runlist
        (task_running membership changes) costs epsilon of CPU time at the
        caller's priority and freezes the GPU for epsilon (TSG eviction /
        context switch — a hardware-driven window that elapses in wall time
        once the runlist registers are written); a call that only touches
        task_pending is the cheap mode of the paper's overhead histogram
        (Table V) and is modeled as free."""
        if piece.which == "begin":
            rewrote = self.alg2.add(job)
        else:
            rewrote = self.alg2.remove(job)
        cost = self.sim.ts.epsilon if rewrote else 0.0
        piece.duration = cost
        piece.remaining = cost
        if cost > 0.0:
            self._gpu_pause_left = max(self._gpu_pause_left, cost)

    def on_update_done(self, job: "Job", which: str) -> None:
        self._release_lock()

    def on_job_complete(self, job: "Job") -> None:
        # defensive cleanup (a well-formed job has already called end())
        self.alg2.discard(job)
        self._tsgs.pop(id(job), None)

    _gpu_pause_left = 0.0

    # ---- resource arbitration ----------------------------------------------
    def update_in_flight(self) -> bool:
        return self._gpu_pause_left > 0.0

    def gpu_owner(self) -> Optional["Job"]:
        if self.update_in_flight():
            return None  # runlist rewrite / context switch pauses the GPU
        rt = [j for j in self.running if j.task.is_rt and j.wants_gpu()]
        if rt:
            return max(rt, key=lambda j: j.task.gpu_priority)
        cur = self.rr.current()
        return cur.job if cur else None

    def gpu_rr_advance(self, dt: float) -> None:
        if self._gpu_pause_left > 0.0:
            self._gpu_pause_left = max(self._gpu_pause_left - dt, 0.0)
        if not any(j.task.is_rt and j.wants_gpu() for j in self.running):
            if len(self.rr.runnable()) > 1:
                self.rr.advance(dt)

    def next_gpu_event(self) -> float:
        ev = float("inf")
        if self._gpu_pause_left > 0.0:
            ev = self._gpu_pause_left
        if not any(j.task.is_rt and j.wants_gpu() for j in self.running):
            if len(self.rr.runnable()) > 1:
                ev = min(ev, max(self.rr.slice_left, 1e-9))
        return ev

    def cpu_blocked(self, job: "Job") -> bool:
        if self.sim.mode != "suspend":
            return False
        k = job.current_kind()
        if k == "upd" and self.lock_holder not in (None, job) \
                and not job.upd_started:
            return True   # rt_mutex sleeps the waiter
        if k == "ge":
            return True   # self-suspended during pure GPU execution / wait
        return False

    # ---- runtime face (sched.executor notify mode) -------------------------
    def runtime_segment_begin(self, job) -> bool:
        return self.alg2.add(job)

    def runtime_segment_end(self, job) -> bool:
        return self.alg2.remove(job)

    def runtime_on_complete(self, job) -> None:
        self.alg2.discard(job)
        self._tsgs.pop(id(job), None)

    def runtime_admitted(self, job) -> bool:
        if job not in self.running:
            return False
        rt = [j for j in self.running if job_is_rt(j)]
        if rt:
            return job is max(rt, key=job_gpu_priority)
        return True


# Both wait modes carry their analytic guarantee on one device; the
# multi-device projections are not part of this package yet.
register_policy("ioctl", IoctlPolicy,
                "Algorithm 2: IOCTL segment-granular runlist control",
                rtas={"busy": ioctl_busy_rta, "suspend": ioctl_suspend_rta})
