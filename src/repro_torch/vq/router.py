"""MoE router seeding from clustered token representations.
Counterpart of ``repro.vq.router``.

Router logits are ``x @ W`` with ``W [d, E]``, so setting each column to a
unit-normalised cluster centroid of the token representation space gives
every expert a coherent region of that space from step 0, instead of a
random hyperplane. The clustering runs through the port's
:class:`~repro_torch.service.BWKMSession`, so the same session keeps
absorbing serving batches via ``partial_fit`` and re-seeds the router when
the traffic drifts.

Normalisation guard: BWKM can emit zero centroids (dead clusters) whose
norm is 0; dividing by it would poison a router column with NaN, which the
softmax spreads over every expert. Columns at or under the norm floor are
left at zero instead (the expert keeps a flat logit and stays reachable).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bwkm import BWKMConfig
from repro_torch.device import resolve_device
from repro_torch.models import moe
from repro_torch.service.session import BWKMSession, ServiceConfig

__all__ = ["router_from_centroids", "seed_router", "install_router"]

#: centroid norms at or below this are treated as dead (zero column)
NORM_FLOOR = 1e-8


def router_from_centroids(centroids, *, norm_floor: float = NORM_FLOOR,
                          device: str | torch.device | None = None) -> torch.Tensor:
    """``[E, d]`` centroids → router weights ``[d, E]`` f32 with unit
    columns, dead (zero-norm) centroids as zero columns, never NaN. A
    tensor stays on its device; anything else goes to ``device`` (CUDA
    unless given)."""
    if isinstance(centroids, torch.Tensor):
        c = centroids.float()
    else:
        c = torch.as_tensor(np.asarray(centroids, np.float32),
                            device=resolve_device(device or "cuda"))
    if c.ndim != 2:
        raise ValueError(f"centroids must be [E, d], got shape {tuple(c.shape)}")
    norms = torch.linalg.vector_norm(c, dim=1)
    live = norms > norm_floor
    safe = torch.where(live, norms, 1.0)
    return torch.where(live[:, None], c / safe[:, None], 0.0).T


def seed_router(
    hidden,
    n_experts: int,
    *,
    session: BWKMSession | None = None,
    config: ServiceConfig | None = None,
    seed: int = 0,
    max_iters: int = 10,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, BWKMSession]:
    """Cluster token representations ``[n, d]`` → router ``[d, E]``.

    Returns ``(router_w, session)``. Pass the returned session back in to
    refresh the router online: each call is one ``partial_fit`` mini-batch
    (decay → merge → track → drift-triggered refit), so the centroids, and
    the router derived from them, follow the serving distribution. A new
    session runs on ``device``."""
    if session is None:
        cfg = config or ServiceConfig(base=BWKMConfig(k=n_experts, max_iters=max_iters), seed=seed)
        if cfg.base.k != n_experts:
            raise ValueError(f"config clusters k={cfg.base.k} but n_experts={n_experts}")
        session = BWKMSession(cfg, device=device)
    elif session.config.base.k != n_experts:
        raise ValueError(
            f"session clusters k={session.config.base.k} but n_experts={n_experts}"
        )
    if isinstance(hidden, torch.Tensor):
        hidden = hidden.float()
    else:
        hidden = np.asarray(hidden, np.float32)
    session.partial_fit(hidden)
    return router_from_centroids(session.centroids), session


def install_router(params: dict, router_w) -> dict:
    """Install ``router_w [d, E]`` into every MoE layer of a stacked
    transformer param tree (a copy; ``params`` stays as it was)."""
    if "layers" not in params or "moe" not in params["layers"]:
        raise ValueError("params has no stacked MoE layers to install into")
    layers = dict(params["layers"])
    layers["moe"] = moe.replace_router(layers["moe"], router_w)
    return {**params, "layers": layers}
