"""Baseline end-to-end response time analysis (Sec. VI-A / VI-B).

Implements:
  * Lemma 1 — runlist-update delay bound K_i under the kernel-thread approach.
  * Lemma 2 — WCRT under the kernel-thread approach (busy-waiting only).
  * Lemma 3 — WCRT under the IOCTL-based approach, busy-waiting mode.
  * Lemma 4 — WCRT under the IOCTL-based approach, self-suspension mode.
  * Sec. VI-B — variant under GPU-segment priority assignment: GPU preemption
    terms (and Eq. (1) runlist updates) are governed by GPU priorities, and
    release jitters use D_h in place of R_h (WCRTs of higher-GPU-priority
    tasks are unknown during Audsley assignment).

All analyses return a dict {task name -> WCRT}, with ``math.inf`` for tasks
whose recurrence exceeds the deadline (unschedulable).  Best-effort tasks are
not analyzed (value ``None``): they have no deadline.

Every entry point shares the ``_rta_loop`` driver, which adds two
result-preserving accelerations used by the schedulability sweeps:

  * ``early_exit=True`` stops at the first unschedulable task (the
    remaining WCRTs cannot rescue the taskset) — partial dicts are only
    returned on the failure path, so ``schedulable`` stays exact;
  * ``only=<name>`` computes just the prefix of tasks needed for one
    task's bound — with ``use_gpu_prio=True`` jitters are deadline-based
    (the OPA property), so a single task suffices (Audsley's inner loop).

Single-device tasksets only: the multi-device projections
(``per_device``, ``cross_device`` and the cross-device fixed point) are not
part of this package yet, and an RTA given ``n_devices > 1`` raises
``NotImplementedError``.

Conventions:
  G_i^*  = G_i   + 2*eps*eta_i^g       (Sec. VI-A.2)
  G_i^e* = G_i^e + 2*eps*eta_i^g
  G_i^m* = G_i^m + 2*eps*eta_i^g
  J_h    = R_h - (C_h + G_h)           (Lemma 1)
  J_h^g  = R_h - G_h^e                 (Lemma 3)
  J_h^c  = R_h - (C_h + G_h^m)         (Lemma 4)
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional

from .task_model import Task, Taskset

MAX_ITERS = 4096
_EPS = 1e-9


def ceil_pos(x: float, t: float) -> int:
    """ceil(x / t) robust to float noise, clamped at >= 0."""
    if x <= 0:
        return 0
    q = x / t
    c = math.ceil(q - 1e-9)
    return max(c, 0)


def _jitter(ts: Taskset, h: Task, kind: str, R: Dict[str, float],
            use_gpu_prio: bool) -> float:
    """Release jitter of a higher-priority task (Sec. VI-A / VI-B)."""
    base = ts_deadline(h) if use_gpu_prio else R.get(h.name, h.deadline)
    if base is None or math.isinf(base):
        base = h.deadline  # conservative fallback keeps recurrence finite
    if kind == "job":      # J_h = R_h - (C_h + G_h)
        j = base - (h.C + h.G)
    elif kind == "gpu":    # J_h^g = R_h - G_h^e
        j = base - h.Ge
    elif kind == "cpu":    # J_h^c = R_h - (C_h + G_h^m)
        j = base - (h.C + h.Gm)
    else:
        raise ValueError(kind)
    return max(j, 0.0)


def ts_deadline(t: Task) -> float:
    return t.deadline


def _iterate(ti: Task, f: Callable[[float], float], seed: float = 0.0) -> float:
    """Standard fixed-point iteration; inf if R exceeds the deadline.

    ``seed`` warm-starts the ascent.  The caller must guarantee
    ``seed <= lfp(f)``: for monotone ``f`` the Kleene iteration from any
    point at or below the least fixed point is nondecreasing and converges
    to the same least fixed point (Knaster–Tarski: ``f(s) < s`` would imply
    ``lfp <= s``), so the result is identical to the cold start — only the
    early iterations are skipped.  An ``inf`` seed means the caller already
    proved a lower bound beyond the deadline."""
    if math.isinf(seed):
        return math.inf
    R = f(max(seed, 0.0))
    for _ in range(MAX_ITERS):
        R_new = f(R)
        if R_new > ti.deadline + _EPS:
            return math.inf
        if abs(R_new - R) < _EPS:
            return R_new
        R = R_new
    return math.inf


def _gpu_hp_remote(ts: Taskset, ti: Task, use_gpu_prio: bool) -> list[Task]:
    """hp(tau_i) \\ hpp(tau_i) with eta^g>0; ordering per Sec. VI-B if asked."""
    hpp = set(id(t) for t in ts.hpp(ti))
    return [h for h in ts.hp(ti, by_gpu=use_gpu_prio)
            if id(h) not in hpp and h.uses_gpu]


# --------------------------------------------------------------------------
# shared fixed-point driver + multi-device projection
# --------------------------------------------------------------------------

def _rta_loop(ts: Taskset, make_f: Callable[[Task, Dict], Callable],
              early_exit: bool = False, only: Optional[str] = None,
              r_independent: bool = False,
              seeds: Optional[Dict[str, float]] = None
              ) -> Dict[str, Optional[float]]:
    """Run the per-task fixed points in decreasing priority order.

    ``make_f(ti, R)`` builds the recurrence for ``ti`` given the WCRTs of
    the higher-priority tasks computed so far.  ``r_independent`` declares
    that the recurrences never read ``R`` (deadline-based jitters), which
    lets ``only`` skip every other task outright.  ``seeds`` maps task
    names to warm-start values for the per-task iteration (must be lower
    bounds of the respective fixed points — see ``_iterate``; used by the
    warm-started Audsley assignment in `core/audsley.py`)."""
    R: Dict[str, Optional[float]] = {}
    for ti in ts.by_priority():
        if only is not None and r_independent and ti.name != only:
            continue
        if ti.is_rt:
            seed = seeds.get(ti.name, 0.0) if seeds else 0.0
            R[ti.name] = _iterate(ti, make_f(ti, R), seed=seed)
        else:
            R[ti.name] = None
        if only is not None and ti.name == only:
            return R
        if early_exit and ti.is_rt and math.isinf(R[ti.name]):
            return R  # partial: the taskset is already unschedulable
    return R


def single_device(rta: Callable) -> Callable:
    """Refuse multi-device tasksets: their projections are not ported."""
    @functools.wraps(rta)
    def wrapper(ts: Taskset, *args, **kw):
        if ts.n_devices > 1:
            raise NotImplementedError(
                "multi-device analysis (n_devices > 1) is not available "
                "in repro_torch")
        return rta(ts, *args, **kw)

    return wrapper


# --------------------------------------------------------------------------
# Lemma 1 + Lemma 2: kernel-thread approach (busy-waiting)
# --------------------------------------------------------------------------

def kthread_K(ts: Taskset, ti: Task, R_i: float, R: Dict[str, float],
              use_gpu_prio: bool = False, corrected: bool = True) -> float:
    """Lemma 1: runlist update delay K_i.

    K_i = x_i * (2*eps + sum_{h in hp, eta_h^g>0} ceil((R_i+J_h)/T_h) * 2*eps)

    Paper: x_i = 1 iff tau_i uses the GPU or shares the kernel thread's core.

    ERRATUM (found by property testing the analysis against the simulator,
    see tests/test_soundness.py): the paper's x_i misses a *transitive*
    busy-wait effect: a CPU-only task on a different core than the kernel
    thread is still delayed by runlist updates whenever a same-core
    higher-priority GPU-using task busy-waits through an update-induced GPU
    pause.  With ``corrected=True`` (default), x_i = 1 also when any
    same-core higher-priority task uses the GPU, which restores soundness
    (MORT <= WCRT in all randomized sweeps).  ``corrected=False`` gives the
    paper's verbatim term.
    """
    x_i = 1 if (ti.uses_gpu or ti.cpu == ts.kthread_cpu) else 0
    if corrected and not x_i:
        x_i = 1 if any(h.uses_gpu for h in ts.hpp(ti)) else 0
    if not x_i:
        return 0.0
    eps = ts.epsilon
    total = 2.0 * eps
    hps = [h for h in ts.hp(ti, by_gpu=use_gpu_prio) if h.uses_gpu]
    for h in hps:
        J_h = _jitter(ts, h, "job", R, use_gpu_prio)
        total += ceil_pos(R_i + J_h, h.period) * 2.0 * eps
    return total


@single_device
def kthread_busy_rta(ts: Taskset, use_gpu_prio: bool = False,
                     corrected: bool = True, early_exit: bool = False,
                     only: Optional[str] = None,
                     seeds: Optional[Dict[str, float]] = None
                     ) -> Dict[str, Optional[float]]:
    """Lemma 2: WCRT under the kernel-thread approach.

    R_i = C_i + G_i + K_i
        + sum_{h in hpp(tau_i)}                ceil(R_i/T_h) * (C_h + G_h)
        + sum_{h in hp\\hpp, eta_h^g>0}       ceil((R_i+J_h)/T_h) * (C_h + G_h)

    Same-core preemption is jitter-free (busy-waiting keeps tau_h occupying
    its core for its whole job); remote GPU-using tasks effectively preempt
    through the job-granular runlist reservation (Sec. V-A under-utilization)
    and carry a release jitter J_h.
    """
    def make_f(ti: Task, R: Dict) -> Callable:
        hpp = ts.hpp(ti)
        remote = _gpu_hp_remote(ts, ti, use_gpu_prio)

        def f(R_i: float) -> float:
            v = ti.C + ti.G + kthread_K(ts, ti, R_i, R, use_gpu_prio,
                                        corrected)
            for h in hpp:
                v += ceil_pos(R_i, h.period) * (h.C + h.G)
            for h in remote:
                J_h = _jitter(ts, h, "job", R, use_gpu_prio)
                v += ceil_pos(R_i + J_h, h.period) * (h.C + h.G)
            return v
        return f

    return _rta_loop(ts, make_f, early_exit=early_exit, only=only,
                     r_independent=use_gpu_prio, seeds=seeds)


# --------------------------------------------------------------------------
# Lemma 3: IOCTL-based approach, busy-waiting
# --------------------------------------------------------------------------

def _gstar(t: Task, eps: float) -> float:
    return t.G + 2.0 * eps * t.eta_g


def _gestar(t: Task, eps: float) -> float:
    return t.Ge + 2.0 * eps * t.eta_g


def _gmstar(t: Task, eps: float) -> float:
    return t.Gm + 2.0 * eps * t.eta_g


@single_device
def ioctl_busy_rta(ts: Taskset, use_gpu_prio: bool = False,
                   corrected: bool = True, early_exit: bool = False,
                   only: Optional[str] = None,
                   seeds: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Optional[float]]:
    """Lemma 3: WCRT under the IOCTL-based approach with busy-waiting.

    R_i = C_i + G_i^* + (eta_i^g + 1) * eps
        + sum_{h in hpp, eta_h^g=0} ceil(R_i/T_h) * C_h
        + sum_{h in hpp, eta_h^g>0} ceil(R_i/T_h) * (C_h + G_h^*)
        + sum_{h in hp\\hpp, eta_h^g>0} ceil((R_i+J_h^g)/T_h) * G_h^{e*}

    ERRATUM (see kthread_K): under busy-waiting, a same-core higher-priority
    GPU-using task occupies the core not only for C_h + G_h^* but also for
    its own runlist-update blocking, bounded by its (eta_h^g + 1)*eps
    budget.  ``corrected=True`` (default) adds that stretch to the same-core
    term; ``corrected=False`` is the paper's verbatim Lemma 3.
    """
    eps = ts.epsilon

    def make_f(ti: Task, R: Dict) -> Callable:
        hpp_cpu = [h for h in ts.hpp(ti) if not h.uses_gpu]
        hpp_gpu = [h for h in ts.hpp(ti) if h.uses_gpu]
        remote = _gpu_hp_remote(ts, ti, use_gpu_prio)

        def f(R_i: float) -> float:
            v = ti.C + _gstar(ti, eps) + (ti.eta_g + 1) * eps
            for h in hpp_cpu:
                v += ceil_pos(R_i, h.period) * h.C
            for h in hpp_gpu:
                stretch = (h.eta_g + 1) * eps if corrected else 0.0
                v += ceil_pos(R_i, h.period) * (h.C + _gstar(h, eps) + stretch)
            for h in remote:
                J = _jitter(ts, h, "gpu", R, use_gpu_prio)
                v += ceil_pos(R_i + J, h.period) * _gestar(h, eps)
            return v
        return f

    return _rta_loop(ts, make_f, early_exit=early_exit, only=only,
                     r_independent=use_gpu_prio, seeds=seeds)


# --------------------------------------------------------------------------
# Lemma 4: IOCTL-based approach, self-suspension
# --------------------------------------------------------------------------

@single_device
def ioctl_suspend_rta(ts: Taskset, use_gpu_prio: bool = False,
                      early_exit: bool = False, only: Optional[str] = None,
                      seeds: Optional[Dict[str, float]] = None
                      ) -> Dict[str, Optional[float]]:
    """Lemma 4: WCRT under the IOCTL-based approach with self-suspension.

    R_i = C_i + G_i^* + (eta_i^g + 1) * eps
        + sum_{h in hpp, eta_h^g=0}             ceil(R_i/T_h) * C_h
        + sum_{h in hpp, eta_h^g>0}             ceil((R_i+J_h^c)/T_h) * (C_h + G_h^{m*})
        + sum_{h in hpp, eta_h^g>0, eta_i^g>0}  ceil((R_i+J_h^g)/T_h) * G_h^e
        + sum_{h in hp\\hpp, eta_h^g>0, eta_i^g>0}
                                                ceil((R_i+J_h^g)/T_h) * G_h^{e*}

    Under self-suspension there are no busy-wait chains, so GPU-side
    interference (the last two terms) applies only to GPU-using tau_i
    (Lemma 4's proof: remote tau_h "interferes with the GPU execution of
    tau_i").
    """
    eps = ts.epsilon

    def make_f(ti: Task, R: Dict) -> Callable:
        hpp_cpu = [h for h in ts.hpp(ti) if not h.uses_gpu]
        hpp_gpu = [h for h in ts.hpp(ti) if h.uses_gpu]
        remote = _gpu_hp_remote(ts, ti, use_gpu_prio)

        def f(R_i: float) -> float:
            v = ti.C + _gstar(ti, eps) + (ti.eta_g + 1) * eps
            for h in hpp_cpu:
                v += ceil_pos(R_i, h.period) * h.C
            for h in hpp_gpu:
                Jc = _jitter(ts, h, "cpu", R, use_gpu_prio)
                v += ceil_pos(R_i + Jc, h.period) * (h.C + _gmstar(h, eps))
                if ti.uses_gpu:
                    Jg = _jitter(ts, h, "gpu", R, use_gpu_prio)
                    v += ceil_pos(R_i + Jg, h.period) * h.Ge
            if ti.uses_gpu:
                for h in remote:
                    Jg = _jitter(ts, h, "gpu", R, use_gpu_prio)
                    v += ceil_pos(R_i + Jg, h.period) * _gestar(h, eps)
            return v
        return f

    return _rta_loop(ts, make_f, early_exit=early_exit, only=only,
                     r_independent=use_gpu_prio, seeds=seeds)


# --------------------------------------------------------------------------
# Schedulability helpers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def supports_kwarg(rta: Callable, kwname: str) -> bool:
    """Whether an RTA callable accepts ``kwname`` (for the optional
    early_exit/only accelerations; external RTAs without them still work)."""
    try:
        import inspect
        return kwname in inspect.signature(rta).parameters
    except (TypeError, ValueError):  # pragma: no cover
        return False


def schedulable(ts: Taskset, rta: Callable[..., Dict[str, Optional[float]]],
                **kw) -> bool:
    if supports_kwarg(rta, "early_exit"):
        kw.setdefault("early_exit", True)
    R = rta(ts, **kw)
    for t in ts.rt_tasks:
        r = R.get(t.name, math.inf)  # absent => early-exited: unschedulable
        if r is None or math.isinf(r) or r > t.deadline + _EPS:
            return False
    return True
