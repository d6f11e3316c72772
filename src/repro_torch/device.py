"""Where the port runs: CUDA unless the caller asks for another device."""

from __future__ import annotations

import torch

__all__ = ["as_points", "resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``, with a CUDA device's index made
    explicit. Without a CUDA device, asking for one raises: the port never
    carries on on the CPU unless it was asked to."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_points(x) -> torch.Tensor:
    """``x [n, d]`` as the kernels take points: a tensor stays on its
    device, anything else goes to CUDA (or raises without it); f32 unless
    it is bf16, which the kernels also load."""
    x = torch.as_tensor(x, device=x.device if isinstance(x, torch.Tensor) else resolve_device())
    return x if x.dtype == torch.bfloat16 else x.float()
