"""Long-lived clustering service: online BWKM over an unbounded stream.

Counterpart of ``repro.service``. The batch engines summarise a dataset
into a small weighted partition and drop the points, which is exactly the
state a long-running service keeps alive between batches:

  * :class:`BWKMSession`: consumes mini-batches through ``partial_fit``;
    decayed block statistics merge into the live partition, a short
    warm-started weighted Lloyd tracks the centroids, and the
    misassignment boundary decides when to re-split (refit) only the
    affected blocks.
  * :mod:`repro_torch.service.checkpoint`: whole-state save and restore
    (partition, centroids, bound state, key, stream cursor) on the
    reference's npz + manifest format; a resumed session replays the rest
    of the stream bit for bit.
  * :class:`BatchedPredictor`: serves ``predict``/``transform`` by
    coalescing concurrent requests into chunk-kernel calls.

Each runs on CUDA unless the caller passes ``device="cpu"``.
"""

from repro_torch.service.checkpoint import (
    load_session,
    save_session,
    session_state_template,
)
from repro_torch.service.predictor import BatchedPredictor
from repro_torch.service.session import (
    BWKMSession,
    ServiceConfig,
    SessionState,
    resume_service,
    run_service,
)

__all__ = [
    "BWKMSession",
    "BatchedPredictor",
    "ServiceConfig",
    "SessionState",
    "load_session",
    "resume_service",
    "run_service",
    "save_session",
    "session_state_template",
]
