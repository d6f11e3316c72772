"""The paper's algorithmic pieces on resident tensors: BWKM's config and
in-core entry point, Lloyd, the partition, k-means|| seeding, and the
baselines and metrics of the paper's comparison."""

from repro_torch.core.bwkm import BWKMConfig, BWKMResult, fit_incore
from repro_torch.core.kmeans_ll import KMeansLLResult, default_oversampling, kmeans_parallel
from repro_torch.core.lloyd import LloydResult
from repro_torch.core.partition import Partition, create_partition, split_blocks

__all__ = [
    "BWKMConfig",
    "BWKMResult",
    "KMeansLLResult",
    "LloydResult",
    "Partition",
    "create_partition",
    "default_oversampling",
    "fit_incore",
    "kmeans_parallel",
    "split_blocks",
]
