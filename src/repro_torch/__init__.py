"""BWKM (Boundary Weighted K-means) in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the ``repro`` package's main path: ``BWKM(k).fit(x)`` on a
resident tensor, then ``predict`` / ``score`` / ``transform``. It runs on
CUDA unless the caller passes ``device="cpu"``, where every kernel seam
takes its plain PyTorch version.
"""

from repro_torch.api.estimator import BWKM
from repro_torch.api.result import FitResult
from repro_torch.core.bwkm import BWKMConfig

__all__ = ["BWKM", "BWKMConfig", "FitResult"]
