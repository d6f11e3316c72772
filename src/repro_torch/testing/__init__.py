"""Seeded, deterministic fault injectors for chunk sources: the failure
modes :class:`~repro_torch.data.resilient.ResilientChunkSource` survives."""

from repro_torch.testing.faults import (
    CorruptChunkSource,
    CrashingSource,
    FakeClock,
    FlakyIOSource,
    InjectedCrash,
    StragglerSource,
    seeded_fault_schedule,
)

__all__ = [
    "CorruptChunkSource",
    "CrashingSource",
    "FakeClock",
    "FlakyIOSource",
    "InjectedCrash",
    "StragglerSource",
    "seeded_fault_schedule",
]
