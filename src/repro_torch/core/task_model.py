"""Task model from Sec. IV of the paper.

A task tau_i := (C_i, G_i, T_i, D_i, eta_i^c, eta_i^g) is an alternating
sequence of CPU segments and GPU segments, statically partitioned to one CPU
core, with a unique fixed priority.  Each GPU segment G_{i,j} := (G^m, G^e)
where G^m is miscellaneous CPU work (kernel launch, driver communication) and
G^e is the *pure GPU segment* (no CPU intervention; the task busy-waits or
self-suspends on the CPU during it).

Best-case execution times (the paper's check-marked symbols) are carried as
``*_best`` fields; they default to the WCET (i.e. deterministic execution),
and are used by the reduced-pessimism analysis (Sec. VI-C).

All times are in milliseconds (float).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

# The G_{i,j} = (G^m, G^e) segment pair is shared with the simulator and
# runtime layers and lives in core/segments.py (DESIGN.md §6); it is
# re-exported here because the analysis vocabulary historically imported
# it from the task model.
from .segments import GpuSegment as GpuSegment

BEST_EFFORT_PRIORITY = -1_000_000  # below every real-time priority


@dataclass
class Task:
    """A sporadic task with constrained deadline, statically bound to a core.

    ``priority`` follows Linux rt_priority convention: larger = higher.
    ``gpu_priority`` defaults to ``priority`` (Sec. V-C assignment may change
    it).  ``best_effort`` tasks have no real-time priority (they map to
    CFS/default tasks in the paper's evaluation).  ``device`` is the index
    of the accelerator the task's GPU segments execute on (multi-GPU
    platforms, DESIGN.md §4); 0 on the paper's single-GPU platform.
    """

    name: str
    cpu_segments: Sequence[float]  # WCETs C_{i,1..eta^c}
    gpu_segments: Sequence[GpuSegment]
    period: float  # T_i
    deadline: float  # D_i <= T_i
    cpu: int  # statically assigned core id
    priority: int  # unique OS-level priority, larger = higher
    gpu_priority: Optional[int] = None
    best_effort: bool = False
    cpu_segments_best: Optional[Sequence[float]] = None
    device: int = 0  # accelerator index

    def __post_init__(self):
        self.cpu_segments = tuple(float(c) for c in self.cpu_segments)
        self.gpu_segments = tuple(self.gpu_segments)
        if self.cpu_segments_best is None:
            self.cpu_segments_best = self.cpu_segments
        self.cpu_segments_best = tuple(float(c) for c in self.cpu_segments_best)
        if len(self.cpu_segments_best) != len(self.cpu_segments):
            raise ValueError("best-case CPU segment count mismatch")
        if any(b > w + 1e-12 for b, w in zip(self.cpu_segments_best, self.cpu_segments)):
            raise ValueError("best-case CPU segments must not exceed WCET")
        if self.deadline > self.period + 1e-12:
            raise ValueError("constrained deadline required: D_i <= T_i")
        if self.gpu_priority is None:
            self.gpu_priority = self.priority
        if self.best_effort:
            # Best-effort tasks sit below all real-time priorities.
            self.priority = BEST_EFFORT_PRIORITY + self.priority % 1000
            self.gpu_priority = self.priority
        # cache the cumulative quantities: they are invariant after
        # construction (priority mutations don't touch segment times) and
        # sit on the hot path of every fixed-point RTA iteration
        self._C = sum(self.cpu_segments)
        self._C_best = sum(self.cpu_segments_best)
        self._G = sum(g.total for g in self.gpu_segments)
        self._Gm = sum(g.misc for g in self.gpu_segments)
        self._Ge = sum(g.exec for g in self.gpu_segments)
        self._Ge_best = sum(g.exec_best for g in self.gpu_segments)

    # --- cumulative quantities used throughout the analysis -----------------
    @property
    def C(self) -> float:
        return self._C

    @property
    def C_best(self) -> float:
        return self._C_best

    @property
    def G(self) -> float:
        return self._G

    @property
    def Gm(self) -> float:
        return self._Gm

    @property
    def Ge(self) -> float:
        return self._Ge

    @property
    def Ge_best(self) -> float:
        return self._Ge_best

    @property
    def eta_c(self) -> int:
        return len(self.cpu_segments)

    @property
    def eta_g(self) -> int:
        return len(self.gpu_segments)

    @property
    def uses_gpu(self) -> bool:
        return self.eta_g > 0

    @property
    def utilization(self) -> float:
        return (self.C + self.G) / self.period

    @property
    def is_rt(self) -> bool:
        return not self.best_effort

    def with_gpu_priority(self, gp: int) -> "Task":
        t = dataclasses.replace(self)
        t.gpu_priority = gp
        return t


@dataclass
class Taskset:
    """A taskset on a multi-core platform with ``n_devices`` GPUs
    (Sec. IV; the paper's platform has exactly one)."""

    tasks: list[Task]
    n_cpus: int
    epsilon: float = 1.0  # runlist update cost (ms), Table II
    kthread_cpu: int = 0  # core hosting the kernel thread (kthread approach)
    n_devices: int = 1    # number of accelerators (each with its own runlist)

    def __post_init__(self):
        prios = [t.priority for t in self.tasks]
        if len(set(prios)) != len(prios):
            raise ValueError("task priorities must be unique (footnote 4)")
        for t in self.tasks:
            if not (0 <= t.cpu < self.n_cpus):
                raise ValueError(f"{t.name}: cpu {t.cpu} out of range")
            if not (0 <= t.device < self.n_devices):
                raise ValueError(f"{t.name}: device {t.device} out of range")

    def tasks_on_device(self, device: int) -> list[Task]:
        """GPU-using tasks bound to ``device`` (CPU-only tasks are device-
        agnostic and excluded)."""
        return [t for t in self.tasks if t.uses_gpu and t.device == device]

    @property
    def rt_tasks(self) -> list[Task]:
        return [t for t in self.tasks if t.is_rt]

    def by_priority(self) -> list[Task]:
        """Tasks in decreasing priority order."""
        return sorted(self.tasks, key=lambda t: -t.priority)

    def hp(self, ti: Task, by_gpu: bool = False) -> list[Task]:
        """hp(tau_i): all higher-priority tasks in the system.

        With ``by_gpu`` (Sec. VI-B), ordering uses GPU-segment priorities.
        """
        key = (lambda t: t.gpu_priority) if by_gpu else (lambda t: t.priority)
        return [t for t in self.tasks if t is not ti and key(t) > key(ti)]

    def hpp(self, ti: Task) -> list[Task]:
        """hpp(tau_i): higher-priority tasks on the same core as tau_i."""
        return [t for t in self.tasks
                if t is not ti and t.cpu == ti.cpu and t.priority > ti.priority]

    def total_utilization(self) -> float:
        return sum(t.utilization for t in self.tasks)
