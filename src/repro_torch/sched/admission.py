"""RTA-driven admission control: before a new real-time job is accepted
onto the executor, its measured worst-case segment times are folded into
the current taskset and the paper's schedulability test decides.

This is where the paper's analysis becomes an operational guarantee: jobs
admitted here have analytically bounded response times under the chosen
scheduling approach (kthread/ioctl x busy/suspend), including the measured
runlist-update overhead epsilon.

The analysis matching each approach lives in the policy registry
(`core.policy.PolicySpec.rtas`), so the executor, the simulator, and the
admission controller all resolve one policy name to one consistent
(implementation, analysis) pair.

Single-device analyses only in this package: ``n_devices > 1`` raises
``NotImplementedError`` in the RTA, and the batched burst path
(``try_admit_many``) waits for its backend."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

from ..core import GpuSegment, Task, Taskset
from ..core.analysis import _EPS, supports_kwarg
from ..core.audsley import assign_gpu_priorities
from ..core.policy import policy_spec
from ..core.segments import WorkloadProfile


# Reason codes carried by every admission decision, in refusal order:
# the first gate that fires names the decision.
REASONS = ("accepted", "validation-refused", "headroom-fast-reject",
           "rta-reject")


class AdmissionDecision(dict):
    """Structured admission result (one decision of ``try_admit``).

    A ``dict`` whose keys are those of the reference's decisions, so
    :func:`decisions_match` compares the two directly; ``bool(decision)``
    is the acceptance, ``.reason`` one of :data:`REASONS`, ``.wcrt`` the
    RTA evidence.

    Keys always present: ``admitted`` (bool), ``reason``, ``via``
    (``"default"``/``"audsley"``/``"best_effort"``/None), ``wcrt``
    (task name → WCRT ms; empty when no fixed point ran).  Optional:
    ``error`` (human-readable refusal), ``gpu_priorities`` (Audsley
    assignment)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.setdefault("admitted", False)
        self.setdefault("reason",
                        "accepted" if self["admitted"] else "rta-reject")
        self.setdefault("via", None)
        self.setdefault("wcrt", {})
        if self["reason"] not in REASONS:
            raise ValueError(f"unknown reason code {self['reason']!r} "
                             f"(expected one of {REASONS})")
        if self["admitted"] != (self["reason"] == "accepted"):
            raise ValueError(
                f"admitted={self['admitted']} contradicts "
                f"reason={self['reason']!r}")

    def __bool__(self) -> bool:
        return bool(self["admitted"])

    @property
    def accepted(self) -> bool:
        return bool(self["admitted"])

    @property
    def reason(self) -> str:
        return self["reason"]

    @property
    def via(self) -> Optional[str]:
        return self["via"]

    @property
    def wcrt(self) -> dict:
        return self["wcrt"]

    @property
    def error(self) -> Optional[str]:
        return self.get("error")

    @classmethod
    def accept(cls, via: str, wcrt: Optional[dict] = None,
               **extra) -> "AdmissionDecision":
        return cls(admitted=True, reason="accepted", via=via,
                   wcrt=dict(wcrt or {}), **extra)

    @classmethod
    def refuse(cls, reason: str, *, error: Optional[str] = None,
               wcrt: Optional[dict] = None) -> "AdmissionDecision":
        d = cls(admitted=False, reason=reason, via=None,
                wcrt=dict(wcrt or {}))
        if error is not None:
            d["error"] = error
        return d


def decisions_match(a: Mapping, b: Mapping, tol: float = 1e-6) -> bool:
    """Decision identity: same acceptance, reason, via, Audsley
    assignment, and WCRT evidence (to ``tol``, inf-for-inf).  The
    refusal text is presentation, not evidence, and is not compared."""
    if (bool(a.get("admitted")) != bool(b.get("admitted"))
            or a.get("reason") != b.get("reason")
            or a.get("via") != b.get("via")
            or a.get("gpu_priorities") != b.get("gpu_priorities")):
        return False
    wa, wb = a.get("wcrt") or {}, b.get("wcrt") or {}
    if set(wa) != set(wb):
        return False
    for k, va in wa.items():
        vb = wb[k]
        va = math.inf if va is None else float(va)
        vb = math.inf if vb is None else float(vb)
        if math.isinf(va) or math.isinf(vb):
            if va != vb:
                return False
        elif abs(va - vb) > tol:
            return False
    return True


def profile_utilization(prof: "JobProfile") -> float:
    """One profile's device utilization: Σ (G^m + G^e) / T."""
    return sum(m + e for m, e in prof.device_segments_ms) / prof.period_ms


def rta_for(policy: str, wait_mode: str) -> Callable:
    """Resolve the RTA guaranteeing (approach, wait mode)."""
    spec = policy_spec(policy)
    try:
        return spec.rtas[wait_mode]
    except KeyError:
        raise ValueError(
            f"approach {spec.name!r} has no analysis for "
            f"wait_mode={wait_mode!r} (available: {sorted(spec.rtas)})")


@dataclass
class JobProfile:
    """Measured WCETs of one job (ms): host segments and device segments
    (launch misc + pure device time)."""
    name: str
    host_segments_ms: List[float]
    device_segments_ms: List[tuple]  # (misc_ms, exec_ms)
    period_ms: float
    priority: int
    cpu: int = 0
    deadline_ms: Optional[float] = None
    best_effort: bool = False
    device: int = 0  # accelerator the device segments execute on

    def to_task(self) -> Task:
        return Task(
            name=self.name,
            cpu_segments=self.host_segments_ms,
            gpu_segments=[GpuSegment(m, e) for m, e in
                          self.device_segments_ms],
            period=self.period_ms,
            deadline=self.deadline_ms or self.period_ms,
            cpu=self.cpu, priority=self.priority,
            best_effort=self.best_effort, device=self.device)

    @classmethod
    def from_workload(cls, wp: "WorkloadProfile", period_ms: float,
                      priority: int, *, cpu: int = 0,
                      deadline_ms: Optional[float] = None,
                      best_effort: bool = False, device: int = 0,
                      margin: float = 1.2) -> "JobProfile":
        """Build the admission profile from a *measured*
        ``core.segments.WorkloadProfile`` (host segment times + per-slice
        device times), inflated by ``margin`` — observations are not
        WCETs.  This is the end of the measured pipeline: real sliced
        kernel → per-slice times → η/G segments → RTA admission."""
        host, dev = wp.segments_ms(margin)
        return cls(name=wp.name,
                   host_segments_ms=host or [0.0],
                   device_segments_ms=dev,
                   period_ms=period_ms, priority=priority, cpu=cpu,
                   deadline_ms=deadline_ms, best_effort=best_effort,
                   device=device)


class AdmissionController:
    """RTA gatekeeper with incremental decision state.

    Three kinds of state persist between decisions, so a streaming
    decision costs O(new work):

      * **built tasks** — each admitted profile's :class:`Task` is
        converted once and reused by every later taskset build;
      * **running utilization totals** — per-core and per-device RT
        demand (the headroom gate's sums) plus per-device profile load,
        added on admit and recounted on release;
      * **warm-start seeds** — the admitted set's *converged* WCRT dict
        under the default (RM-priority) recurrence.  Admitting a task
        only **adds** interference, so the previous fixed point sits at
        or below the new one component-wise and is a sound Kleene seed
        (`analysis._iterate`); the candidate itself seeds from zero.
        A ``release`` of an RT profile shrinks interference, leaving
        cached bounds *above* the new fixed point — the unsound
        direction (see `core/audsley.py`) — so the cache is invalidated
        and the next decision re-solves cold.  An Audsley accept also
        invalidates: its bounds hold under the reassigned GPU
        priorities, not the default recurrence the next RM test runs.

    The decisions and WCRTs are those of the reference's controller on
    the same profile stream (the port's tests hold them equal)."""

    def __init__(self, policy: str = "ioctl", wait_mode: str = "suspend",
                 n_cpus: int = 4, epsilon_ms: float = 1.0,
                 try_gpu_priorities: bool = True, n_devices: int = 1,
                 headroom: float = 1.0):
        self.policy = policy_spec(policy).name
        self.wait_mode = wait_mode
        self.rta = rta_for(self.policy, wait_mode)
        self.n_cpus = n_cpus
        self.epsilon_ms = epsilon_ms
        self.try_gpu_priorities = try_gpu_priorities
        self.n_devices = n_devices
        self.headroom = headroom
        self._admitted: List[JobProfile] = []
        self._tasks: Dict[str, Task] = {}
        self._cpu_util: Dict[int, float] = {}   # RT (C+Gm)/T per core
        self._dev_util: Dict[int, float] = {}   # RT Ge/T per device
        self._load: Dict[int, float] = {}       # profile load per device
        self._warm: Optional[Dict[str, Optional[float]]] = None

    # ------------------------------------------------------------------
    # incremental bookkeeping
    # ------------------------------------------------------------------
    @property
    def admitted(self) -> List[JobProfile]:
        """Admitted profiles in admission order."""
        return self._admitted

    def _charge(self, prof: JobProfile, task: Task) -> None:
        """Add one admitted profile to the running totals (in admission
        order, the order the reference sums in, so the floats agree)."""
        self._load[prof.device] = (self._load.get(prof.device, 0.0)
                                   + profile_utilization(prof))
        if task.is_rt:
            self._cpu_util[task.cpu] = (self._cpu_util.get(task.cpu, 0.0)
                                        + (task.C + task.Gm) / task.period)
            if task.uses_gpu:
                self._dev_util[task.device] = \
                    (self._dev_util.get(task.device, 0.0)
                     + task.Ge / task.period)

    def _recount(self) -> None:
        """Rebuild the running totals from the admitted list.  Used on
        removal instead of subtracting: re-accumulating in admission
        order reproduces exactly the floats a fresh controller would
        hold, so decisions at the headroom boundary do not drift."""
        self._cpu_util, self._dev_util, self._load = {}, {}, {}
        for p in self._admitted:
            self._charge(p, self._tasks[p.name])

    def _register(self, prof: JobProfile, task: Task) -> None:
        self._admitted.append(prof)
        self._tasks[prof.name] = task
        self._charge(prof, task)

    def _taskset(self, candidate: Task) -> Taskset:
        tasks = [self._tasks[p.name] for p in self._admitted] + [candidate]
        return Taskset(tasks, n_cpus=self.n_cpus,
                       epsilon=self.epsilon_ms,
                       kthread_cpu=self.n_cpus,  # dedicated scheduler core
                       n_devices=self.n_devices)

    def _headroom_reason(self, task: Task) -> Optional[str]:
        """Utilization fast-reject on the running totals plus the
        candidate: the long-run RT demand of each core (C + G^m per
        period) and each device (G^e per period) against ``headroom``.
        A necessary condition, so refusing on it is sound.  Returns the
        refusal text, or None when the gate passes."""
        cpu_u, dev_u = dict(self._cpu_util), dict(self._dev_util)
        if task.is_rt:
            cpu_u[task.cpu] = (cpu_u.get(task.cpu, 0.0)
                               + (task.C + task.Gm) / task.period)
            if task.uses_gpu:
                dev_u[task.device] = (dev_u.get(task.device, 0.0)
                                      + task.Ge / task.period)
        for core, u in sorted(cpu_u.items()):
            if u > self.headroom + _EPS:
                return (f"RT utilization {u:.3f} on core {core} exceeds "
                        f"headroom {self.headroom:g}")
        for dev, u in sorted(dev_u.items()):
            if u > self.headroom + _EPS:
                return (f"RT utilization {u:.3f} on device {dev} exceeds "
                        f"headroom {self.headroom:g}")
        return None

    def _seeds(self) -> Optional[Dict[str, float]]:
        """Warm-start seeds for the next decision, or None when cold:
        the cached converged WCRTs of the admitted tasks (a lower bound
        of the grown fixed point).  Single-device only."""
        if self._warm is None or self.n_devices != 1:
            return None
        seeds = {k: v for k, v in self._warm.items()
                 if v is not None and math.isfinite(v)}
        return seeds or None

    # ------------------------------------------------------------------
    # decisions
    # ------------------------------------------------------------------
    def try_admit(self, prof: JobProfile) -> AdmissionDecision:
        """Decide one profile.  Best-effort jobs are always admitted (they
        have no guarantee) — but still validated, or an unbuildable
        profile would poison every later taskset build."""
        if not (0 <= prof.device < self.n_devices):
            # refuse, don't crash: a bad profile must not take down the
            # admission path (Taskset validation would raise)
            return AdmissionDecision.refuse(
                "validation-refused",
                error=f"device {prof.device} out of range for "
                      f"{self.n_devices}-device platform")
        if prof.name in self._tasks:
            # a duplicate name would silently merge WCRT dict entries
            return AdmissionDecision.refuse(
                "validation-refused",
                error=f"job name {prof.name!r} already admitted")
        try:
            # the same rule for every other profile defect Taskset
            # validation catches (colliding priorities, bad cpu)
            task = prof.to_task()
            ts = self._taskset(task)
        except ValueError as e:
            return AdmissionDecision.refuse("validation-refused",
                                            error=str(e))
        if prof.best_effort:
            # BE tasks never interfere analytically, so the RT fixed
            # point — and the warm cache — are untouched by this accept
            self._register(prof, task)
            return AdmissionDecision.accept("best_effort")
        reason = self._headroom_reason(task)
        if reason is not None:
            # a hopeless taskset never reaches a fixed point (wcrt stays
            # empty — nothing was computed)
            return AdmissionDecision.refuse("headroom-fast-reject",
                                            error=reason)
        seeds = self._seeds()
        if seeds is not None and supports_kwarg(self.rta, "seeds"):
            R = self.rta(ts, seeds=seeds)
        else:
            R = self.rta(ts)
        if self._accepts(ts, R):
            self._register(prof, task)
            # the admitted set's fixed point seeds the next decision
            self._warm = dict(R)
            return AdmissionDecision.accept("default", R)
        if self.try_gpu_priorities:
            assigned = assign_gpu_priorities(ts, self.rta)
            if assigned is not None:
                self._register(prof, task)
                self._warm = None
                return AdmissionDecision.accept(
                    "audsley", self.rta(assigned, use_gpu_prio=True),
                    gpu_priorities={t.name: t.gpu_priority
                                    for t in assigned.tasks})
        return AdmissionDecision.refuse("rta-reject", wcrt=R)

    @staticmethod
    def _accepts(ts: Taskset, R: dict) -> bool:
        """`analysis.schedulable`'s accept criterion on a WCRT dict."""
        for t in ts.rt_tasks:
            r = R.get(t.name, math.inf)
            if r is None or math.isinf(r) or r > t.deadline + _EPS:
                return False
        return True

    def release(self, name: str) -> bool:
        """Retire an admitted profile (its job left the platform) so its
        demand no longer charges future admissions.  Releasing an RT
        profile invalidates the warm cache (see the class docstring); a
        best-effort release keeps it."""
        for i, p in enumerate(self._admitted):
            if p.name == name:
                del self._admitted[i]
                if self._tasks.pop(name).is_rt:
                    self._warm = None
                self._recount()
                return True
        return False

    def device_utilization(self, device: int) -> float:
        """Total admitted GPU utilization on ``device``, best-effort
        demand included: BE tasks never interfere analytically, but they
        do occupy the device at runtime."""
        return self._load.get(device, 0.0)
