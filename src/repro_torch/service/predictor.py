"""Request batching for serving: coalesce concurrent predicts into kernels.

Counterpart of ``repro.service.predictor``. Serving traffic arrives as many
small ragged requests; the chunk kernels want few large calls.
:class:`BatchedPredictor` queues requests under a lock, and ``flush``
concatenates everything pending into ``chunk_size`` segments: one
``ops.assign_top2_chunk`` (kernel B1) or ``ops.pairwise_sqdist_chunk``
call per segment, the ragged last segment zero-padded and sliced off, then
each caller's rows go back to its ticket. ``ceil(total_rows / chunk_size)``
calls for any mix of request sizes.

Submitting threads hand in numpy arrays and get numpy arrays back; only
``flush`` touches the device.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["BatchedPredictor", "Ticket"]


class Ticket:
    """Future for one queued request; ``result()`` blocks until a flush."""

    def __init__(self, n_rows: int, kind: str):
        self.n_rows = n_rows
        self.kind = kind  # "predict" | "transform"
        self._event = threading.Event()
        self._value: Any = None

    def _fulfill(self, value) -> None:
        self._value = value
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not flushed yet")
        return self._value


class BatchedPredictor:
    """Thread-safe batched predict/transform against fixed centroids on
    ``device`` (CUDA unless the caller asks for another)."""

    def __init__(self, centroids, *, chunk_size: int = 2048, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if isinstance(centroids, torch.Tensor):
            c = centroids.detach().to(self.device, torch.float32)
        else:
            c = torch.from_numpy(np.array(centroids, np.float32)).to(self.device)
        if c.ndim != 2:
            raise ValueError(f"expected [K, d] centroids, got {tuple(c.shape)}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.centroids = c.contiguous()
        self.chunk_size = int(chunk_size)
        self._lock = threading.Lock()
        self._pending: list[tuple[Ticket, np.ndarray]] = []
        self.stats = {
            "n_requests": 0,
            "n_rows": 0,
            "n_kernel_calls": 0,
            "rows_padded": 0,
            "n_flushes": 0,
        }

    def _check(self, x) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.centroids.shape[1]:
            raise ValueError(f"expected [n, {self.centroids.shape[1]}] request, got {x.shape}")
        return x

    def submit(self, x, *, kind: str = "predict") -> Ticket:
        """Queue a request; returns a :class:`Ticket` resolved at ``flush``."""
        if kind not in ("predict", "transform"):
            raise ValueError(f"unknown request kind {kind!r}")
        x = self._check(x)
        ticket = Ticket(x.shape[0], kind)
        with self._lock:
            self._pending.append((ticket, x))
            self.stats["n_requests"] += 1
            self.stats["n_rows"] += x.shape[0]
        return ticket

    def flush(self) -> int:
        """Serve everything pending; returns the number of requests served.
        Predict and transform requests are batched apart (their outputs
        differ), and each kind coalesces across requests."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        self.stats["n_flushes"] += 1
        for kind in ("predict", "transform"):
            group = [(t, x) for t, x in pending if t.kind == kind]
            if group:
                self._serve_group(kind, group)
        return len(pending)

    def _serve_group(self, kind: str, group: list[tuple[Ticket, np.ndarray]]) -> None:
        cs = self.chunk_size
        rows = torch.from_numpy(np.concatenate([x for _, x in group])).to(self.device)
        outs = []
        for start in range(0, rows.shape[0], cs):
            seg = rows[start : start + cs]
            if kind == "predict":
                outs.append(ops.assign_top2_chunk(seg, self.centroids, chunk_size=cs)[0])
            else:
                outs.append(ops.pairwise_sqdist_chunk(seg, self.centroids, chunk_size=cs))
            self.stats["n_kernel_calls"] += 1
            self.stats["rows_padded"] += cs - seg.shape[0]
        flat = torch.cat(outs).cpu().numpy()
        offset = 0
        for ticket, x in group:
            ticket._fulfill(flat[offset : offset + x.shape[0]])
            offset += x.shape[0]

    # -- conveniences --------------------------------------------------------

    def predict(self, x) -> np.ndarray:
        """Submit and flush one predict request."""
        t = self.submit(x, kind="predict")
        self.flush()
        return t.result()

    def transform(self, x) -> np.ndarray:
        """Submit and flush one transform request."""
        t = self.submit(x, kind="transform")
        self.flush()
        return t.result()

    def predict_many(self, requests) -> list[np.ndarray]:
        """Batch a list of predict requests through one flush."""
        tickets = [self.submit(x, kind="predict") for x in requests]
        self.flush()
        return [t.result() for t in tickets]

    def transform_many(self, requests) -> list[np.ndarray]:
        """Batch a list of transform requests through one flush."""
        tickets = [self.submit(x, kind="transform") for x in requests]
        self.flush()
        return [t.result() for t in tickets]
