"""Batched serving drivers. Counterpart of ``repro.launch.serve``.

Two tasks share the entry point (``--task``):

* ``lm`` (default): prefill a batch of prompts, then decode greedily with
  the ring-buffer KV cache, from random weights made from ``--seed``; with
  ``--kv-quantize``, also fit a BWKM KV codebook and serve from codes,
  reporting perplexity, cache bytes and tokens/s beside the raw cache. The
  flags are the reference's: ``--reduced`` is always on, so the CLI runs
  the reduced config; it runs on CUDA (``lm_main(device=...)`` takes
  another device)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --batch 4 --prompt-len 32 --gen 32 --kv-quantize

* ``clusters``: the long-lived clustering service. It opens or resumes a
  :class:`~repro_torch.service.BWKMSession` from ``--checkpoint-dir``,
  consumes a synthetic drifting stream, then serves a burst of concurrent
  predict requests through the request-coalescing
  :class:`~repro_torch.service.BatchedPredictor`, on CUDA unless
  ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve --task clusters \\
        --checkpoint-dir /tmp/bwkm_svc --k 8 --stream-chunks 16
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

__all__ = ["cluster_main", "drifting_stream", "generate", "lm_main", "main"]


def generate(cfg, params, prompts, gen_len: int, *, greedy: bool = True, key=None):
    """prompts [B, P] int32 → generated [B, gen_len] int32 (teacher-free),
    on the parameters' device. Sampling (``greedy=False``) draws from
    ``key`` by Gumbel-max."""
    from repro_torch import random as rnd
    from repro_torch.models import transformer

    with torch.inference_mode():
        prompts = torch.as_tensor(prompts, dtype=torch.int32, device=params["embed"].device)
        b, p = prompts.shape
        last_logits, cache = transformer.prefill(cfg, params, prompts, max_seq_len=p + gen_len)
        token = torch.argmax(last_logits, dim=-1).to(torch.int32)
        out = [token]
        for i in range(gen_len - 1):
            logits = transformer._decode(cfg, params, cache, token, p + i)
            if not greedy:
                key, sub = rnd.split(key)
                logits = logits + rnd.gumbel(sub, logits.shape, device=logits.device)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(token)
        return torch.stack(out, dim=1)


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


def main(argv=None, *, device: str | torch.device = "cuda") -> dict:
    """``--task clusters`` takes its device from ``--device``; ``--task lm``
    from ``device``."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--task", choices=("lm", "clusters"), default="lm")
    args, rest = ap.parse_known_args(argv)
    if args.task == "clusters":
        return cluster_main(rest)
    return lm_main(rest, device=device)


def lm_main(argv=None, *, device: str | torch.device = "cuda") -> dict:
    """The ``--task lm`` driver, on ``device``; importable for tests."""
    from repro_torch import configs
    from repro_torch import random as rnd
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCHS, default="granite-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-quantize", action="store_true",
                    help="fit a BWKM KV codebook and serve from codes, "
                    "reporting perplexity/cache-bytes/tok-s deltas vs fp16")
    ap.add_argument("--codebook-k", type=int, default=8)
    ap.add_argument("--fit-prompts", type=int, default=8,
                    help="prompts in the codebook fitting dump")
    args = ap.parse_args(argv)

    device = resolve_device(device)
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced_config(cfg)
    params = transformer.init_params(cfg, rnd.key(args.seed), device=device)
    prompts = rnd.randint(rnd.key(args.seed + 1), (args.batch, args.prompt_len), 0, cfg.vocab,
                          device=device).to(torch.int32)
    t0 = time.time()
    tokens = generate(cfg, params, prompts, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    tps = args.batch * args.gen / dt
    print(f"[serve] {args.arch} generated [{args.batch}, {args.gen}] tokens "
          f"in {dt:.1f}s ({tps:.1f} tok/s on {device})")
    print("[serve] sample:", tokens[0, :16].tolist())
    result = {"tokens": tokens, "tok_per_s": tps}
    if args.kv_quantize:
        result.update(_kv_quantize_report(cfg, params, prompts, tokens, args))
    return result


def _kv_quantize_report(cfg, params, prompts, baseline_tokens, args) -> dict:
    """Fit a BWKM KV codebook, serve from codes, and report deltas vs fp16.

    Perplexity is teacher-forced on the fp16 baseline's own continuation: the
    fp16 model is near its own argmax there, so NLL degradation isolates
    quantization damage instead of drowning it in model entropy. A
    random-rows codebook at equal k is the control.
    """
    from repro_torch import random as rnd
    from repro_torch import vq
    from repro_torch.models import transformer

    device = params["embed"].device
    k = args.codebook_k
    fit_prompts = rnd.randint(rnd.key(args.seed + 2), (args.fit_prompts, args.prompt_len), 0,
                              cfg.vocab, device=device).to(torch.int32).cpu().numpy()
    t0 = time.time()
    codebook = vq.fit_kv_codebook(
        cfg, params, fit_prompts, k=k, chunk_size=512,
        prompt_batch=min(8, args.fit_prompts), seed=args.seed,
    )
    fit_dt = time.time() - t0
    rand = vq.random_kv_codebook(cfg, params, fit_prompts, k=k, seed=args.seed + 7,
                                 chunk_size=512)

    eval_toks = torch.cat([prompts, baseline_tokens], dim=1)
    p = prompts.shape[1]
    nll_fp16 = vq.teacher_forced_nll(cfg, params, eval_toks, prompt_len=p)
    nll_bwkm = vq.teacher_forced_nll(cfg, params, eval_toks, prompt_len=p, codebook=codebook)
    nll_rand = vq.teacher_forced_nll(cfg, params, eval_toks, prompt_len=p, codebook=rand)

    with torch.inference_mode():
        _, cache = transformer.prefill(cfg, params, prompts, max_seq_len=p + args.gen)
        raw_bytes = vq.kv_cache_nbytes(cache)
        qcache = vq.quantize_cache(codebook, cache)
        vq_bytes = vq.kv_cache_nbytes(qcache)
        del cache, qcache

    t0 = time.time()
    qtokens = vq.generate_quantized(cfg, params, codebook, prompts, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    q_dt = time.time() - t0
    q_tps = args.batch * args.gen / q_dt

    report = {
        "codebook_k": k,
        "fit_s": fit_dt,
        "fit_distance_ops": codebook.meta["distances_total"],
        "ppl_fp16": float(np.exp(nll_fp16)),
        "ppl_bwkm": float(np.exp(nll_bwkm)),
        "ppl_random": float(np.exp(nll_rand)),
        "cache_bytes_fp": int(raw_bytes),
        "cache_bytes_vq": int(vq_bytes),
        "codebook_bytes": int(codebook.nbytes),
        "tok_per_s_vq": q_tps,
        "tokens_vq": qtokens,
    }
    print(
        f"[serve:vq] k={k} codebook fit in {fit_dt:.1f}s "
        f"({codebook.meta['distances_total']:.2e} distance ops, streaming)"
    )
    print(
        f"[serve:vq] ppl fp16={report['ppl_fp16']:.3f} "
        f"bwkm={report['ppl_bwkm']:.3f} random-k={report['ppl_random']:.3f}"
    )
    print(
        f"[serve:vq] cache {raw_bytes} B -> {vq_bytes} B "
        f"({raw_bytes / max(vq_bytes, 1):.1f}x smaller, "
        f"+{report['codebook_bytes']} B codebook), {q_tps:.1f} tok/s quantized"
    )
    return report


if __name__ == "__main__":
    main()
