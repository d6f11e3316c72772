"""Name-based registry of seeding strategies. Counterpart of ``repro.api.inits``.

A strategy bundles the two places a driver needs randomness before Lloyd:
``seed_centroids`` picks the K initial centroids from a weighted point set
(BWKM's representatives), and ``sample`` draws the first-pass uniform sample
the streaming engine builds its initial partition from (default
:func:`~repro_torch.data.chunks.reservoir_sample`).

The port has the reference's five: ``kmeans++`` (the default, paper
Algorithm 5 Step 1), ``kmeans||``, ``forgy``, ``afkmc2`` (which ignores the
weights, so ``BWKM`` warns) and ``reservoir`` (the streaming-native name of
``kmeans++``: a reservoir sample for the initial partition, then weighted
K-means++ on the representatives). :func:`register_init` is the extension
point.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import kmeans_ll, kmeanspp
from repro_torch.data.chunks import reservoir_sample

__all__ = ["InitStrategy", "list_inits", "register_init", "resolve_init"]


@dataclasses.dataclass(frozen=True)
class InitStrategy:
    name: str
    description: str
    seed_centroids: Callable  # (key, points [n,d], weights [n], k) -> [k,d]
    sample: Callable = reservoir_sample  # (ChunkSource, size, seed) -> ndarray
    supports_weights: bool = True


def _afkmc2_seed(key, x, w, k):
    # AFK-MC² seeds an unweighted point set. Zero-weight rows are dropped
    # first: representatives() parks inactive rows at the origin with w == 0,
    # and seeding them would plant centroids at the origin.
    return kmeanspp.afkmc2(key, x[w > 0], k)


_REGISTRY: dict[str, InitStrategy] = {}
_ALIASES: dict[str, str] = {}


def register_init(strategy: InitStrategy, *aliases: str) -> InitStrategy:
    """Make ``strategy`` resolvable by name (and ``aliases``) in every engine."""
    _REGISTRY[strategy.name] = strategy
    for a in aliases:
        _ALIASES[a] = strategy.name
    return strategy


def resolve_init(name: str | InitStrategy) -> InitStrategy:
    """Look a strategy up by name or alias; passes strategy objects through."""
    if isinstance(name, InitStrategy):
        return name
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        known = sorted(set(_REGISTRY) | set(_ALIASES))
        raise ValueError(f"unknown init strategy {name!r}; known: {known}")
    return _REGISTRY[key]


def list_inits() -> dict[str, str]:
    """``{name: description}`` for every registered strategy."""
    return {s.name: s.description for s in _REGISTRY.values()}


register_init(
    InitStrategy(
        "kmeans++",
        "weighted K-means++ over the weighted point set (Arthur & "
        "Vassilvitskii 2007; the paper's Algorithm 5 Step 1)",
        kmeanspp.weighted_kmeanspp,
    ),
    "kmeanspp",
    "km++",
)
register_init(
    InitStrategy(
        "kmeans||",
        "k-means|| oversampling (Bahmani et al. 2012): a few Bernoulli "
        "rounds through the min-d² fold kernel, then weighted K-means++ over "
        "the O(ℓ·rounds) candidates — rounds + 2 data passes instead of K",
        kmeans_ll.kmeans_parallel,
    ),
    "kmeansll",
    "kmeans-parallel",
    "scalable-kmeans++",
)
register_init(
    InitStrategy(
        "forgy",
        "K rows drawn weight-proportionally without replacement (the paper's FKM seeding)",
        lambda key, x, w, k: kmeanspp.forgy(key, x, k, w),
    ),
)
register_init(
    InitStrategy(
        "afkmc2",
        "AFK-MC² MCMC approximation of K-means++ (Bachem et al. 2016); "
        "weights on representatives are ignored",
        _afkmc2_seed,
        supports_weights=False,
    ),
    "kmc2",
)
register_init(
    InitStrategy(
        "reservoir",
        "one-pass reservoir sample for the streaming engine's initial "
        "partition, then weighted K-means++ (as 'kmeans++' in core, where "
        "no sampling pass exists)",
        kmeanspp.weighted_kmeanspp,
    ),
)
