"""BWKM (Boundary Weighted K-means) in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the ``repro`` package's main path: ``BWKM(k).fit(x)`` on a
resident tensor, then ``predict`` / ``score`` / ``transform``; k-means||
seeding; and the out-of-core streaming engine, which ``BWKM(k).fit`` picks
for a path, glob, directory, shard list, ``ChunkSource`` or an array over
1 GiB (``repro_torch.streaming`` has its entry points). It runs on CUDA
unless the caller passes ``device="cpu"``, where every kernel seam takes its
plain PyTorch version.
"""

from repro_torch.api.estimator import BWKM
from repro_torch.api.result import FitResult
from repro_torch.core.bwkm import BWKMConfig

__all__ = ["BWKM", "BWKMConfig", "FitResult"]
