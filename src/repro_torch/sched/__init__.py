"""Runtime side of the PyTorch port: RTA admission, the preemptive
device executor, real-time jobs, and the fault primitives they raise."""
from .admission import (AdmissionController, AdmissionDecision, JobProfile,
                        decisions_match, rta_for)
from .executor import DeviceExecutor, ExecutorTrace, TraceEvent
from .fault import (DeviceFailedError, DeviceHealth, FaultContained,
                    HealthConfig, JobEvicted)
from .faultinject import FaultInjector, FaultSpec, InjectedFault
from .job import RTJob

__all__ = [
    "AdmissionController", "AdmissionDecision", "JobProfile",
    "decisions_match", "rta_for",
    "DeviceExecutor", "ExecutorTrace", "TraceEvent",
    "DeviceFailedError", "DeviceHealth", "FaultContained", "HealthConfig",
    "JobEvicted", "FaultInjector", "FaultSpec", "InjectedFault", "RTJob",
]
