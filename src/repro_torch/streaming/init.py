"""The streaming initial partition: Algorithms 2–4 on a one-pass uniform
sample, then the whole stream routed through the sample's boxes.
Counterpart of ``repro.streaming.init``; the code lives in
:mod:`repro_torch.engine.streaming`, whose plane owns the first statistics
fold."""

from __future__ import annotations

from repro_torch.engine.streaming import default_init_sample_size, streaming_initial_partition

__all__ = ["default_init_sample_size", "streaming_initial_partition"]
