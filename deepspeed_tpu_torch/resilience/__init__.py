"""Resilience layer (port of ``deepspeed_tpu/resilience``, its serving
half): fault injection, the step watchdog, preemption grace and the
restart ledger. The fault drill (``faultdrill.py``) is A6b; the training
engine's use of the watchdog and of preemption is A7.1."""

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
