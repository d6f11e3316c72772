"""RunHealth — the degradation ledger a fit reports.

Counterpart of ``repro.health``. A clean run reports all-zero counters; the
in-core plane counts the non-finite rows it quarantines. The other counters
belong to the streaming and distributed planes, which the port does not
have yet, and stay zero.
"""

from __future__ import annotations

import dataclasses

__all__ = ["RunHealth"]


@dataclasses.dataclass
class RunHealth:
    retries: int = 0
    deadline_hits: int = 0
    lost_chunks: int = 0
    lost_points: int = 0
    quarantined_rows: int = 0  # non-finite rows dropped before compute
    lost_shards: int = 0
    degraded_rounds: int = 0
    lost_mass_frac: float = 0.0

    @property
    def degraded(self) -> bool:
        """True iff the run was not a faithful pass over all the data."""
        return bool(
            self.lost_chunks
            or self.lost_points
            or self.quarantined_rows
            or self.lost_shards
            or self.degraded_rounds
        )

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["degraded"] = self.degraded
        return d
