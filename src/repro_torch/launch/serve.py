"""Batched serving drivers.

Counterpart of ``repro.launch.serve``. One task is ported: ``clusters``, the
long-lived clustering service. It opens or resumes a
:class:`~repro_torch.service.BWKMSession` from ``--checkpoint-dir``, consumes
a synthetic drifting stream, then serves a burst of concurrent predict
requests through the request-coalescing
:class:`~repro_torch.service.BatchedPredictor`, on CUDA unless ``--device
cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve --task clusters \\
        --checkpoint-dir /tmp/bwkm_svc --k 8 --stream-chunks 16

The reference's default task, ``lm`` (prefill and decode a transformer),
needs the models, which come with ROADMAP A15; asking for it raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

__all__ = ["cluster_main", "drifting_stream", "main"]


def drifting_stream(seed: int, n_chunks: int, rows: int, d: int, k: int) -> np.ndarray:
    """Synthetic non-stationary stream: cluster centers glide between the
    first and last chunk, enough drift to exercise the refit path. The same
    seed gives the reference's array."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d).astype(np.float32) * 4.0
    drift = rng.randn(k, d).astype(np.float32) * 2.0
    chunks = []
    for i in range(n_chunks):
        t = i / max(n_chunks - 1, 1)
        lab = rng.randint(0, k, rows)
        chunks.append(
            ((centers + t * drift)[lab] + 0.3 * rng.randn(rows, d)).astype(np.float32)
        )
    return np.concatenate(chunks)


def cluster_main(argv=None) -> dict:
    """The ``--task clusters`` driver; importable for tests."""
    from repro_torch.core.bwkm import BWKMConfig
    from repro_torch.data import chunks as ck
    from repro_torch.device import resolve_device
    from repro_torch.service import (
        BatchedPredictor,
        BWKMSession,
        ServiceConfig,
        resume_service,
        run_service,
    )

    ap = argparse.ArgumentParser(description="the long-lived clustering service")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--stream-chunks", type=int, default=16)
    ap.add_argument("--chunk-rows", type=int, default=1024)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--request-rows", type=int, default=100)
    ap.add_argument("--serve-chunk-size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    x = drifting_stream(args.seed + 1, args.stream_chunks, args.chunk_rows, args.dim, args.k)
    source = ck.ArrayChunkSource(x, args.chunk_rows)
    config = ServiceConfig(base=BWKMConfig(k=args.k, max_iters=5), decay=0.95, seed=args.seed)

    t0 = time.time()
    if args.checkpoint_dir:
        session, metrics = resume_service(
            args.checkpoint_dir, source, config=config,
            checkpoint_every=args.checkpoint_every, device=device,
        )
    else:
        session = BWKMSession(config, device=device)
        metrics = run_service(session, source)
    fit_dt = time.time() - t0
    n_fed = sum(m["n_points"] for m in metrics)
    pps = n_fed / fit_dt if fit_dt > 0 else float("inf")
    print(
        f"[serve:clusters] consumed {n_fed} pts in {len(metrics)} batches "
        f"({pps:.0f} pts/s), {sum(m['refit'] for m in metrics)} refits, "
        f"{int(session.state.partition.n_blocks)} blocks on {device}"
    )

    # a burst of concurrent predict requests: submitted from threads and
    # flushed once, they coalesce into ceil(total / chunk_size) kernel calls
    predictor = BatchedPredictor(session.centroids, chunk_size=args.serve_chunk_size,
                                 device=device)
    rng = np.random.RandomState(args.seed + 2)
    reqs = [x[rng.randint(0, x.shape[0], args.request_rows)] for _ in range(args.requests)]
    tickets: list = [None] * len(reqs)

    def _submit(i):
        tickets[i] = predictor.submit(reqs[i])

    threads = [threading.Thread(target=_submit, args=(i,)) for i in range(len(reqs))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    predictor.flush()
    labels = [t.result() for t in tickets]
    serve_dt = time.time() - t0
    served_rows = sum(lab.shape[0] for lab in labels)
    print(
        f"[serve:clusters] served {len(labels)} requests / {served_rows} rows in "
        f"{serve_dt * 1e3:.1f}ms via {predictor.stats['n_kernel_calls']} kernel "
        f"calls ({predictor.stats['rows_padded']} padded rows)"
    )
    return {
        "session": session,
        "metrics": metrics,
        "points_per_s": pps,
        "labels": labels,
        "predictor_stats": dict(predictor.stats),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--task", choices=("lm", "clusters"), default="lm")
    args, rest = ap.parse_known_args(argv)
    if args.task == "clusters":
        return cluster_main(rest)
    raise NotImplementedError(
        "serve --task lm needs the models and configs, which the port has not yet "
        "(ROADMAP A15); --task clusters is ported"
    )


if __name__ == "__main__":
    main()
