"""The paper's algorithmic pieces on resident tensors, and k-means|| seeding."""

from repro_torch.core.kmeans_ll import KMeansLLResult, default_oversampling, kmeans_parallel

__all__ = ["KMeansLLResult", "default_oversampling", "kmeans_parallel"]
