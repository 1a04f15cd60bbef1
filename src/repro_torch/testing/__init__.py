"""Test-support subsystems that ship with the library (counterpart of
`repro/testing`): the fault-injection harness lives here because its
injection points are compiled into the production modules (checkpoint
store, train loop) and must be importable from any process, including the
subprocess workers the kill tests end."""

from repro_torch.testing.faults import (       # noqa: F401
    FaultInjector, FaultRule, InjectedFault, fault_point, inject)
