"""Seeded, deterministic fault injectors for chunk sources (the failure
modes :class:`~repro_torch.data.resilient.ResilientChunkSource` survives)
and the row mask of a lost data shard."""

from repro_torch.testing.faults import (
    CorruptChunkSource,
    CrashingSource,
    FakeClock,
    FlakyIOSource,
    InjectedCrash,
    StragglerSource,
    seeded_fault_schedule,
    shard_loss_rows_mask,
)

__all__ = [
    "CorruptChunkSource",
    "CrashingSource",
    "FakeClock",
    "FlakyIOSource",
    "InjectedCrash",
    "StragglerSource",
    "seeded_fault_schedule",
    "shard_loss_rows_mask",
]
