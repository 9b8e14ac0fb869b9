"""Deterministic test harnesses of the port (fault injection, clocks):
``seldon_core_tpu/testing``'s, for the port's components, batchers and
replica fleet."""

from seldon_core_tpu_torch.testing.faults import (  # noqa: F401
    BatcherKiller,
    DispatchFailer,
    FaultClock,
    FaultSchedule,
    FaultSpec,
    FaultyComponent,
    HandoffPoisoner,
    LeakSweep,
    inject_faults,
)
