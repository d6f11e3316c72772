"""Name-based registry of seeding strategies. Counterpart of ``repro.api.inits``.

The port has ``kmeans++`` (the default, paper Algorithm 5 Step 1) and
``forgy``. The reference's other strategies are named here so that asking
for one says which ROADMAP item brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import kmeanspp

__all__ = ["InitStrategy", "resolve_init"]


@dataclasses.dataclass(frozen=True)
class InitStrategy:
    name: str
    description: str
    seed_centroids: Callable  # (key, points [n,d], weights [n], k) -> [k,d]


_REGISTRY = {
    s.name: s
    for s in (
        InitStrategy(
            "kmeans++",
            "weighted K-means++ over the weighted point set (Arthur & "
            "Vassilvitskii 2007; the paper's Algorithm 5 Step 1)",
            kmeanspp.weighted_kmeanspp,
        ),
        InitStrategy(
            "forgy",
            "K rows drawn weight-proportionally without replacement (the paper's FKM seeding)",
            lambda key, x, w, k: kmeanspp.forgy(key, x, k, w),
        ),
    )
}
_ALIASES = {"kmeanspp": "kmeans++", "km++": "kmeans++"}

#: the reference's other strategies -> the ROADMAP item that ports them
_NOT_PORTED = {
    "kmeans||": "queue A item 9 (k-means||, needs kernel B5)",
    "kmeansll": "queue A item 9 (k-means||, needs kernel B5)",
    "kmeans-parallel": "queue A item 9 (k-means||, needs kernel B5)",
    "scalable-kmeans++": "queue A item 9 (k-means||, needs kernel B5)",
    "afkmc2": "queue A item 10 (baselines)",
    "kmc2": "queue A item 10 (baselines)",
    "reservoir": "queue A item 11 (streaming)",
}


def resolve_init(name: str | InitStrategy) -> InitStrategy:
    """Look a strategy up by name or alias; passes strategy objects through."""
    if isinstance(name, InitStrategy):
        return name
    key = _ALIASES.get(name, name)
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"init {name!r} is not ported to repro_torch yet: ROADMAP {_NOT_PORTED[key]}"
        )
    raise ValueError(f"unknown init strategy {name!r}; known: {sorted(_REGISTRY)}")
