"""Synthetic stand-ins for the paper's datasets (numpy only).

The port's own copy of ``repro.data.synthetic``: anisotropic GMMs that match
the (n, d) profile of each dataset of the paper's Table 1. The same seed
gives the same array as the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PAPER_DATASETS", "gmm_dataset", "paper_dataset"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    d: int
    modes: int  # generative component count of the stand-in


# Table 1 of the paper
PAPER_DATASETS: dict[str, DatasetSpec] = {
    "CIF": DatasetSpec("CIF", 68_037, 17, 12),
    "3RN": DatasetSpec("3RN", 434_874, 3, 20),
    "GS": DatasetSpec("GS", 4_208_259, 19, 15),
    "SUSY": DatasetSpec("SUSY", 5_000_000, 19, 10),
    "WUY": DatasetSpec("WUY", 45_811_883, 5, 25),
}


def gmm_dataset(seed: int, n: int, d: int, modes: int, *, anisotropy: float = 3.0) -> np.ndarray:
    """Anisotropic GMM with unbalanced mixing weights (float32 [n, d])."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(modes, d) * 10.0
    weights = rng.dirichlet(np.full(modes, 0.5))
    comp = rng.choice(modes, size=n, p=weights)
    scales = rng.uniform(0.5, anisotropy, size=(modes, d))
    x = centers[comp] + rng.randn(n, d) * scales[comp]
    return x.astype(np.float32)


def paper_dataset(name: str, *, scale: float = 1.0, seed: int = 0) -> np.ndarray:
    spec = PAPER_DATASETS[name]
    n = max(1000, int(spec.n * scale))
    return gmm_dataset(seed, n, spec.d, spec.modes)
