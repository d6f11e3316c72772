"""Synthetic datasets, out-of-core chunk sources and their fault-tolerant
wrapper, and the token stream of the models."""

from repro_torch.data.chunks import (
    ArrayChunkSource,
    ChunkReadError,
    ChunkSource,
    MemmapChunkSource,
    ShardedFileSource,
    as_chunk_source,
    padded_device_chunks,
    reservoir_sample,
    write_npy_shards,
)
from repro_torch.data.resilient import ChunkLostError, ResilientChunkSource, RetryPolicy
from repro_torch.data.synthetic import PAPER_DATASETS, gmm_dataset, paper_dataset
from repro_torch.data.tokens import TokenStream

__all__ = [
    "PAPER_DATASETS",
    "gmm_dataset",
    "paper_dataset",
    "ChunkLostError",
    "ChunkReadError",
    "ChunkSource",
    "ArrayChunkSource",
    "MemmapChunkSource",
    "ResilientChunkSource",
    "RetryPolicy",
    "ShardedFileSource",
    "TokenStream",
    "as_chunk_source",
    "padded_device_chunks",
    "reservoir_sample",
    "write_npy_shards",
]
