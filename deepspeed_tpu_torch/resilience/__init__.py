"""Resilience layer (port of ``deepspeed_tpu/resilience``, its serving
half): fault injection, the step watchdog, preemption grace, the restart
ledger and the serve fault drill (``python -m
deepspeed_tpu_torch.resilience.faultdrill --mode serve``). The training
engine's use of the watchdog and of preemption, and the drill's training
modes, are A7.1."""

from .fault_injection import (
    DISAGG_FAULT_SITE,
    FAULT_SITES,
    SERVE_FAULT_SITES,
    TRAIN_FAULT_SITES,
    FaultInjector,
    InjectedFault,
    get_fault_injector,
    set_fault_injector,
)
from .ledger import RestartLedger
from .preemption import PreemptionHandler
from .watchdog import StepWatchdog

__all__ = [
    "DISAGG_FAULT_SITE",
    "FAULT_SITES",
    "SERVE_FAULT_SITES",
    "TRAIN_FAULT_SITES",
    "FaultInjector",
    "InjectedFault",
    "get_fault_injector",
    "set_fault_injector",
    "RestartLedger",
    "PreemptionHandler",
    "StepWatchdog",
]
