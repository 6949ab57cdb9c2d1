"""GPU segment priority assignment (Sec. V-C) via Audsley's OPA.

If the schedulability test fails with default priorities (GPU priority ==
CPU priority), we search for a GPU-segment priority assignment, iterating
priority levels from lowest to highest.  Constraints from the paper:

  * Only the GPU segments get new priorities; CPU scheduling is untouched.
  * For tasks on the same CPU core the relative GPU-priority order must
    equal the relative CPU-priority order (deadlock prevention) -- so when
    assigning the lowest remaining GPU priority level, only the
    lowest-CPU-priority unassigned GPU-using task of each core is eligible.
  * During assignment, jitters use D_h instead of R_h (Sec. VI-B), which
    makes each per-task test depend only on the *set* of higher-GPU-priority
    tasks -- the property OPA requires.

The GPU priority *values* are the sorted CPU-priority values of the GPU-using
real-time tasks, so they remain comparable with the (unchanged) gpu_priority
of CPU-only and best-effort tasks.

Warm-started assignment (DESIGN.md §5): a candidate that fails a level is
re-tested at every subsequent level, and each test historically restarted
its fixed point from zero.  Since the recurrences are monotone, iterating
from any seed *at or below* the least fixed point is result-identical and
skips the early ascent.  Note the direction: as levels rise the candidate's
interference set *shrinks*, so the converged bound from a previous level
sits at or ABOVE the new fixed point and is NOT a sound seed.  Instead we
seed every test of a candidate with its *floor bound* — the converged
response time with an empty remote-interference set (candidate provisionally
above every GPU priority) and, for the overlap-improved analyses, the
all-GPU-tasks overlap superset (``overlap_floor=True``), whose larger
deduction keeps the floor recurrence a pointwise lower bound of the
recurrence at any level.  The floor is level- and state-independent, is
computed once per candidate (lazily, on its first test), prunes candidates
whose floor already misses the deadline, and — because under deadline-based
jitters a task's recurrence depends only on the *set* of tasks above it —
each placed candidate's converged bound equals its bound under the final
assignment, so the closing full-set test is seeded with the placement
bounds.  Warm-starting applies on single-device tasksets only: under the
multi-device busy fixed point (`core/crossfix.py`) the folded occupancy
charges shift with GPU priorities and no per-candidate floor is available.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

from .analysis import supports_kwarg
from .task_model import Task, Taskset


def _test_task(ts: Taskset, name: str, rta: Callable,
               seeds: Optional[Dict[str, float]] = None,
               **kw) -> Tuple[bool, Optional[float]]:
    """Test one task's bound; returns (passes, converged bound)."""
    if supports_kwarg(rta, "only"):
        # With use_gpu_prio the jitters are deadline-based (the OPA
        # property), so on single-device / suspend paths the candidate's
        # bound alone is enough and ``only`` prunes the rest.  Under the
        # multi-device busy fixed point (core/crossfix.py) a task's bound
        # also depends on the other tasks' occupancy iterates, so the
        # joint analysis ignores ``only`` and computes the full vector —
        # the per-candidate test stays correct (we still only read the
        # candidate's bound) and _full_test gates final acceptance.
        kw.setdefault("only", name)
    if seeds and supports_kwarg(rta, "seeds"):
        kw.setdefault("seeds", seeds)
    R = rta(ts, use_gpu_prio=True, **kw)
    t = next(t for t in ts.tasks if t.name == name)
    r = R[name]
    ok = r is not None and not math.isinf(r) and r <= t.deadline + 1e-9
    return ok, r


def _full_test(ts: Taskset, rta: Callable,
               seeds: Optional[Dict[str, float]] = None, **kw) -> bool:
    if supports_kwarg(rta, "early_exit"):
        kw.setdefault("early_exit", True)
    if seeds and supports_kwarg(rta, "seeds"):
        kw.setdefault("seeds", seeds)
    R = rta(ts, use_gpu_prio=True, **kw)
    return all(not math.isinf(R.get(t.name, math.inf))
               and R[t.name] <= t.deadline + 1e-9 for t in ts.rt_tasks)


def assign_gpu_priorities(ts: Taskset, rta: Callable,
                          warm_start: bool = True) -> Optional[Taskset]:
    """Audsley assignment of GPU-segment priorities.

    Returns a new Taskset with gpu_priority fields set if one is found under
    which every real-time task passes ``rta`` (with use_gpu_prio=True), else
    None.  ``warm_start`` enables the result-identical floor-seeded
    candidate tests (module docstring); disable it to run every fixed
    point from zero (the reference behaviour, kept for differential
    testing).
    """
    gpu_tasks = sorted([t for t in ts.rt_tasks if t.uses_gpu],
                       key=lambda t: t.priority)
    if not gpu_tasks:
        return None
    levels = sorted(t.priority for t in gpu_tasks)  # reuse CPU prio values

    # Work on copies so the input taskset is untouched.
    pool = {t.name: dataclasses.replace(t) for t in ts.tasks}
    work = Taskset(tasks=list(pool.values()), n_cpus=ts.n_cpus,
                   epsilon=ts.epsilon, kthread_cpu=ts.kthread_cpu,
                   n_devices=ts.n_devices)
    unassigned = [pool[t.name] for t in gpu_tasks]
    # Unassigned tasks provisionally sit above every level (OPA invariant).
    top = max(levels) + 1
    for t in unassigned:
        t.gpu_priority = top + t.priority  # unique, above all levels

    warm = (warm_start and ts.n_devices == 1
            and supports_kwarg(rta, "seeds"))
    ceiling = top + max(t.priority for t in gpu_tasks) + 1
    floors: Dict[str, float] = {}    # candidate -> floor bound (seed)
    placed_R: Dict[str, float] = {}  # candidate -> bound at placement

    def candidate_floor(cand: Task) -> float:
        """Converged bound with an empty remote set (candidate above every
        GPU priority) and, where supported, the overlap floor — a lower
        bound of the candidate's fixed point at every level."""
        kw = {}
        if supports_kwarg(rta, "overlap_floor"):
            kw["overlap_floor"] = True
        old = cand.gpu_priority
        cand.gpu_priority = ceiling
        try:
            _, r = _test_task(work, cand.name, rta, **kw)
        finally:
            cand.gpu_priority = old
        return math.inf if r is None else r

    for level in levels:  # lowest first
        # Eligible: lowest-CPU-priority unassigned GPU task per core.
        lowest_per_core: Dict[int, Task] = {}
        for t in sorted(unassigned, key=lambda t: t.priority):
            lowest_per_core.setdefault(t.cpu, t)
        placed = None
        for cand in sorted(lowest_per_core.values(), key=lambda t: t.priority):
            seeds = None
            if warm:
                if cand.name not in floors:
                    floors[cand.name] = candidate_floor(cand)
                if math.isinf(floors[cand.name]):
                    continue  # floor already misses: fails at every level
                seeds = {cand.name: floors[cand.name]}
            old = cand.gpu_priority
            cand.gpu_priority = level
            ok, r = _test_task(work, cand.name, rta, seeds=seeds)
            if ok:
                placed = cand
                placed_R[cand.name] = r
                break
            cand.gpu_priority = old
        if placed is None:
            return None
        unassigned.remove(placed)

    # CPU-only tasks' schedulability can also shift with GPU priorities
    # (busy-wait chains); verify the whole set before accepting.  Each
    # placed candidate's final-assignment bound equals its placement bound
    # (set-identical interference under deadline jitters), so those seed
    # the full test.
    if _full_test(work, rta, seeds=placed_R if warm else None):
        return work
    return None


def schedulable_with_assignment(ts: Taskset, rta: Callable) -> bool:
    """The evaluation pipeline of Sec. VII-A: test with default (RM)
    priorities first; on failure, retry with Audsley GPU priorities."""
    from .analysis import schedulable
    if schedulable(ts, rta):
        return True
    return assign_gpu_priorities(ts, rta) is not None
