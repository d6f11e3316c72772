"""The benchmark's inputs, made from the seed on the device.

A torch rewrite of the model behind ``repro_torch.data.synthetic.gmm_dataset``
(the stand-in for the paper's datasets): an anisotropic Gaussian mixture
with unbalanced Dirichlet(0.5) weights, centres ``N(0, center_scale²)`` and
per-mode, per-feature scales ``U(0.5, anisotropy)``. The mixture itself is
the deployment's dataset and comes from the configuration's
``mixture_seed``; the rows are drawn from the run's seed with a
``torch.Generator`` on the device, in a few large calls. The mode of a row
is drawn by inverse CDF from one uniform (``torch.multinomial`` with many
draws is not the same from run to run on CUDA).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Mixture", "derive", "draw", "mixture", "mixture_std"]

_MASK63 = (1 << 63) - 1


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and ``tags`` (any ints or strings):
    independent streams for rows, keys and batches."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & _MASK63


class Mixture(NamedTuple):
    centers: torch.Tensor  # [modes, d] f32
    scales: torch.Tensor  # [modes, d] f32
    cdf: torch.Tensor  # [modes] f64, the last entry 1
    weights: np.ndarray  # [modes] f64


def mixture(data: dict, device) -> Mixture:
    """The mixture of a configuration's ``data`` block on ``device``."""
    rng = np.random.default_rng(int(data["mixture_seed"]))
    modes, d = int(data["modes"]), int(data["d"])
    centers = rng.standard_normal((modes, d)) * float(data["center_scale"])
    weights = rng.dirichlet(np.full(modes, 0.5))
    scales = rng.uniform(0.5, float(data["anisotropy"]), size=(modes, d))
    cdf = np.cumsum(weights)
    cdf[-1] = 1.0
    return Mixture(
        torch.as_tensor(centers, dtype=torch.float32, device=device),
        torch.as_tensor(scales, dtype=torch.float32, device=device),
        torch.as_tensor(cdf, dtype=torch.float64, device=device),
        weights,
    )


def mixture_std(mix: Mixture) -> np.ndarray:
    """Each feature's standard deviation under the mixture (float64)."""
    w = mix.weights[:, None]
    mu = mix.centers.double().cpu().numpy()
    var = mix.scales.double().cpu().numpy() ** 2
    mean = (w * mu).sum(0)
    return np.sqrt((w * (var + mu**2)).sum(0) - mean**2)


def draw(mix: Mixture, n: int, seed: int) -> torch.Tensor:
    """``n`` rows ``f32 [n, d]`` of ``mix`` from ``seed`` on the mixture's
    device; the same seed gives the same rows there."""
    dev = mix.centers.device
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & _MASK63)
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    comp = torch.searchsorted(mix.cdf, u, right=True).clamp_(max=mix.cdf.shape[0] - 1)
    x = torch.randn(n, mix.centers.shape[1], generator=g, device=dev)
    return x.mul_(mix.scales[comp]).add_(mix.centers[comp])
