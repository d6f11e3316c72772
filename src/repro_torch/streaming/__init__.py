"""Out-of-core BWKM on the card: the entry points over the streaming plane.

Counterpart of ``repro.streaming``. The driver consumes fixed-size chunks of
a :class:`~repro_torch.data.chunks.ChunkSource` and keeps O(chunk + M·d) on
the device; the weighted Lloyd and boundary-split loop runs unchanged on the
block representatives.
"""

from repro_torch.streaming.init import default_init_sample_size, streaming_initial_partition
from repro_torch.streaming.kmeans_ll import StreamKMeansLLResult, kmeans_parallel_streaming
from repro_torch.streaming.stream_bwkm import (
    StreamBWKMResult,
    StreamingLloydResult,
    StreamStats,
    fit_streaming,
    streaming_error,
    streaming_lloyd,
    streaming_lloyd_step,
)

__all__ = [
    "StreamBWKMResult",
    "StreamKMeansLLResult",
    "StreamStats",
    "StreamingLloydResult",
    "default_init_sample_size",
    "fit_streaming",
    "kmeans_parallel_streaming",
    "streaming_error",
    "streaming_initial_partition",
    "streaming_lloyd",
    "streaming_lloyd_step",
]
