"""The PyTorch port's scheduling side against the reference.

The same ``JobProfile`` stream goes through ``repro_torch.sched`` and
``repro.sched`` admission controllers: the decisions must match
(``repro.sched.decisions_match``) with identical WCRTs, since the port's
analysis is the same code.  The port's executor preempts a best-effort
job for a real-time one at slice boundaries, over torch tensors."""
import math
import time

import numpy as np
import pytest
import torch

import repro.sched as jsched
from repro_torch.core import (SegmentedWorkload, SlicedOp, Task, Taskset,
                              available_policies, block_until_ready,
                              ioctl_busy_rta, ioctl_suspend_rta,
                              kthread_busy_rta, make_policy)
from repro_torch.core.segments import measure_sliced
from repro_torch.sched import (AdmissionController, DeviceExecutor,
                               ExecutorTrace, JobProfile, RTJob)

torch.set_num_threads(1)


def _stream(seed, n):
    """Profiles with seeded WCETs: RT and best-effort jobs, one
    duplicate name (a validation refusal) and periods tight enough that
    some are refused by the RTA or the headroom gate."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        host = [float(x) for x in rng.uniform(0.1, 2.0, rng.integers(1, 3))]
        dev = [(float(m), float(e)) for m, e in
               rng.uniform(0.05, 6.0, (int(rng.integers(1, 4)), 2))]
        out.append(dict(
            name=f"job{i}" if i != n - 1 else "job0",
            host_segments_ms=host, device_segments_ms=dev,
            period_ms=float(rng.uniform(20.0, 120.0)),
            priority=int(100 - i), cpu=int(rng.integers(0, 2)),
            best_effort=bool(rng.random() < 0.2)))
    return out


@pytest.mark.parametrize("wait_mode", ["suspend", "busy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_match_reference(seed, wait_mode):
    kw = dict(policy="ioctl", wait_mode=wait_mode, n_cpus=2, epsilon_ms=0.5)
    ours, theirs = AdmissionController(**kw), jsched.AdmissionController(**kw)
    reasons = set()
    for p in _stream(seed, 12):
        a = ours.try_admit(JobProfile(**p))
        b = theirs.try_admit(jsched.JobProfile(**p))
        assert jsched.decisions_match(a, b), (a, b)
        assert a["wcrt"] == b["wcrt"]           # the same floats
        reasons.add(a.reason)
    assert "accepted" in reasons and len(reasons) >= 2
    assert [p.name for p in ours.admitted] == \
        [p.name for p in theirs.admitted]


def test_admission_release_and_utilization_match_reference():
    kw = dict(policy="ioctl", wait_mode="suspend", n_cpus=2, epsilon_ms=0.5)
    ours, theirs = AdmissionController(**kw), jsched.AdmissionController(**kw)
    for p in _stream(3, 8):
        ours.try_admit(JobProfile(**p))
        theirs.try_admit(jsched.JobProfile(**p))
    name = ours.admitted[0].name
    assert ours.release(name) and theirs.release(name)
    assert ours.device_utilization(0) == theirs.device_utilization(0)
    p = dict(_stream(4, 1)[0], name="late")
    assert jsched.decisions_match(ours.try_admit(JobProfile(**p)),
                                  theirs.try_admit(jsched.JobProfile(**p)))


@pytest.mark.parametrize("rta", [ioctl_suspend_rta, ioctl_busy_rta,
                                 kthread_busy_rta])
def test_rtas_refuse_multi_device_tasksets(rta):
    t = Task(name="a", cpu_segments=[1.0], gpu_segments=[], period=10.0,
             deadline=10.0, cpu=0, priority=1)
    with pytest.raises(NotImplementedError):
        rta(Taskset([t], n_cpus=1, n_devices=2))
    assert math.isfinite(rta(Taskset([t], n_cpus=1))["a"])


def test_policy_registry_is_filled_on_import():
    assert {"ioctl", "unmanaged", "sync_priority", "sync_fifo"} <= \
        set(available_policies())
    assert make_policy("ioctl").name == "ioctl"


def test_block_until_ready_walks_nested_carries():
    tree = {"cache": [{"k": torch.zeros(2)}], "pos": torch.ones(3),
            "n": 4, "none": None}
    assert block_until_ready(tree) is tree


def test_measure_sliced_times_every_slice():
    def make():
        return SlicedOp(3, lambda: torch.zeros(4),
                        lambda c, i: c + torch.ones(4), lambda c: c.sum(),
                        label="add")
    prof = measure_sliced(make, reps=2)
    assert prof.label == "add" and prof.n_slices == 3
    assert all(t >= 0.0 for t in prof.slice_ms) and prof.exec_ms >= 0.0


def _spin(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_rt_job_preempts_best_effort_at_slice_boundaries():
    """The best-effort job runs 8 slices; the real-time job, released
    once it has started, runs its 3 slices contiguously before the
    best-effort job's last slice (IOCTL approach, Algorithm 2)."""
    trace = ExecutorTrace()
    ex = DeviceExecutor(policy="ioctl", wait_mode="suspend", trace=trace)
    order = []

    def op(tag, n):
        def step(carry, i):
            _spin(0.02)
            order.append((tag, i))
            return carry + 1
        return SlicedOp(n, lambda: torch.zeros(()), step, lambda c: c,
                        label=tag)

    be_wl = SegmentedWorkload("be").device(lambda: op("be", 8))
    rt_wl = SegmentedWorkload("rt").host(lambda: time.sleep(0.05)) \
        .device(lambda: op("rt", 3))
    be = RTJob("be", be_wl.bind(ex), period_s=10.0, priority=0,
               best_effort=True)
    rt = RTJob("rt", rt_wl.bind(ex), period_s=10.0, priority=50)
    be.start(ex)
    rt.start(ex)
    be.join(20)
    rt.join(20)
    ex.shutdown()
    assert be.error is None and rt.error is None
    rt_idx = [i for i, e in enumerate(order) if e[0] == "rt"]
    be_last = max(i for i, e in enumerate(order) if e[0] == "be")
    assert rt_idx == list(range(rt_idx[0], rt_idx[0] + 3))
    assert rt_idx[-1] < be_last
    assert trace.of("preempt"), "the best-effort job was never preempted"
    assert rt.stats.completions == 1 and rt.stats.mort is not None


def test_profile_to_admission_pipeline():
    """Measured slices -> JobProfile -> WCRT, the main path's admission."""
    wl = SegmentedWorkload("w").device(
        lambda: SlicedOp(2, lambda: torch.zeros(8),
                         lambda c, i: c * 2 + 1, lambda c: c))
    prof = wl.profile(reps=2)
    ctl = AdmissionController(policy="ioctl", wait_mode="suspend",
                              n_cpus=1, epsilon_ms=1.0 + prof.max_slice_ms)
    dec = ctl.try_admit(JobProfile.from_workload(prof, period_ms=1000.0,
                                                 priority=5))
    assert dec.accepted and dec.wcrt["w"] < 1000.0
