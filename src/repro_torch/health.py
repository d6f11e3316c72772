"""RunHealth — the degradation ledger a fit reports.

Counterpart of ``repro.health``. A clean run reports all-zero counters. The
in-core plane counts the non-finite rows it quarantines; the streaming plane
reports the ledger of a :class:`~repro_torch.data.resilient.ResilientChunkSource`
(retries, deadline hits, lost chunks, quarantined rows); the sharded plane
counts lost shards, degraded rounds and the largest mass fraction lost.
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

    @classmethod
    def from_dict(cls, d: dict | None) -> "RunHealth":
        if not d:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def merged(self, other: "RunHealth | None") -> "RunHealth":
        """Counter-wise sum (max for ``lost_mass_frac``): a source's ledger
        and an engine's own as one record."""
        if other is None:
            return dataclasses.replace(self)
        out = RunHealth()
        for f in dataclasses.fields(RunHealth):
            a, b = getattr(self, f.name), getattr(other, f.name)
            setattr(out, f.name, max(a, b) if f.name == "lost_mass_frac" else a + b)
        return out
