"""Name-based registry of seeding strategies. Counterpart of ``repro.api.inits``.

A strategy bundles the two places a driver needs randomness before Lloyd:
``seed_centroids`` picks the K initial centroids from a weighted point set
(BWKM's representatives), and ``sample`` draws the first-pass uniform sample
the streaming engine builds its initial partition from (default
:func:`~repro_torch.data.chunks.reservoir_sample`).

The port has ``kmeans++`` (the default, paper Algorithm 5 Step 1),
``kmeans||``, ``forgy`` and ``reservoir`` (the streaming-native name of
``kmeans++``: a reservoir sample for the initial partition, then weighted
K-means++ on the representatives). The reference's other strategies are
named here so that asking for one says which ROADMAP item brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import kmeans_ll, kmeanspp
from repro_torch.data.chunks import reservoir_sample

__all__ = ["InitStrategy", "resolve_init"]


@dataclasses.dataclass(frozen=True)
class InitStrategy:
    name: str
    description: str
    seed_centroids: Callable  # (key, points [n,d], weights [n], k) -> [k,d]
    sample: Callable = reservoir_sample  # (ChunkSource, size, seed) -> ndarray


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
            "kmeans||",
            "k-means|| oversampling (Bahmani et al. 2012): a few Bernoulli "
            "rounds through the min-d² fold kernel, then weighted K-means++ over "
            "the O(ℓ·rounds) candidates — rounds + 2 data passes instead of K",
            kmeans_ll.kmeans_parallel,
        ),
        InitStrategy(
            "forgy",
            "K rows drawn weight-proportionally without replacement (the paper's FKM seeding)",
            lambda key, x, w, k: kmeanspp.forgy(key, x, k, w),
        ),
        InitStrategy(
            "reservoir",
            "one-pass reservoir sample for the streaming engine's initial "
            "partition, then weighted K-means++ (as 'kmeans++' in core, where "
            "no sampling pass exists)",
            kmeanspp.weighted_kmeanspp,
        ),
    )
}
_ALIASES = {
    "kmeanspp": "kmeans++",
    "km++": "kmeans++",
    "kmeansll": "kmeans||",
    "kmeans-parallel": "kmeans||",
    "scalable-kmeans++": "kmeans||",
}

#: the reference's other strategies -> the ROADMAP item that ports them
_NOT_PORTED = {
    "afkmc2": "queue A item 10 (baselines)",
    "kmc2": "queue A item 10 (baselines)",
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
