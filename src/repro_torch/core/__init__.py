"""Scheduling core of the PyTorch port: task model, single-device
response-time analyses, the policy registry and the segment abstraction.

Pure Python, the same code as ``repro.core``'s single-device part.
Importing this package registers the ``ioctl``, ``unmanaged``,
``sync_priority`` and ``sync_fifo`` policies (``make_policy`` resolves
names through the registry the modules fill on import).
"""
from .analysis import (ioctl_busy_rta, ioctl_suspend_rta, kthread_busy_rta,
                       kthread_K, schedulable)
from .audsley import assign_gpu_priorities, schedulable_with_assignment
from .ioctl import IoctlPolicy
from .policy import (Alg2State, SchedulingPolicy,
                     available_policies, job_gpu_priority, job_is_rt,
                     make_policy, pick_reserved, policy_spec,
                     register_policy)
from .runlist import Platform, Runlist, SyncPolicy, TSG, UnmanagedPolicy
from .segments import (GpuSegment, SegmentedWorkload, SlicedOp,
                       SliceProfile, WorkloadProfile, block_until_ready,
                       measure_sliced, n_slices_for, segment_layout)
from .task_model import Task, Taskset

__all__ = [
    "Task", "GpuSegment", "Taskset",
    "SlicedOp", "SegmentedWorkload", "SliceProfile", "WorkloadProfile",
    "measure_sliced", "n_slices_for", "segment_layout", "block_until_ready",
    "SchedulingPolicy", "register_policy", "make_policy",
    "available_policies", "policy_spec", "Alg2State", "pick_reserved",
    "job_is_rt", "job_gpu_priority",
    "kthread_busy_rta", "ioctl_busy_rta", "ioctl_suspend_rta", "kthread_K",
    "schedulable", "assign_gpu_priorities", "schedulable_with_assignment",
    "IoctlPolicy", "SyncPolicy", "UnmanagedPolicy",
    "Runlist", "TSG", "Platform",
]
