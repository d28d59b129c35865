"""Resilience layer (port of ``deepspeed_tpu/resilience``): fault
injection, the step watchdog, preemption grace, the restart ledger and the
fault drill (``python -m deepspeed_tpu_torch.resilience.faultdrill``:
the serve modes and the training checkpoint sites). The serving engine
and the training engine both take the watchdog and preemption; the
drill's ``collective`` site is A8 and its goodput drill A7.6."""

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
