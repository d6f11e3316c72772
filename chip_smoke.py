#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BWKM on one NVIDIA GPU and check it.

Run from the root of the repository:

    python3 chip_smoke.py            # the check; needs one CUDA device
    python3 chip_smoke.py --profile DIR  # and torch.profiler breakdowns of the
                                         # fit, of k-means||, of the streaming fit,
                                         # of streaming k-means|| and of five
                                         # service batches, tables in DIR
    python3 chip_smoke.py --parent DIR   # and phase 5 times the kernels built from
                                         # DIR/src/repro_torch/kernels/csrc (an
                                         # earlier commit, same C interface) in
                                         # turns with these: parent, this, this,
                                         # parent; then the fit's and k-means||'s
                                         # walls with DIR's package and this one,
                                         # a process each, in the same turns

Phases, one line each (and a few detail lines), any failure exits non-zero:

1. build the four CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
   (one nvcc each, in parallel; with ``--parent``, the parent's four as well)
   and print the build seconds and each kernel's registers and spills;
2. hold each kernel (B1 assign_top2, B2 fused assign+update, B3 its pruned
   form, B4 cluster_sums, B5 the k-means|| min-d² fold) against its plain
   PyTorch version on the card, in f32 and bf16, at the main paths' shapes
   and at the edges (ragged n, K = 1, K > one tile, zero weights, B3 with no
   and with every row active, the k-means|| weighting passes' 561 and 2,001
   candidates with about half parked far away, empty clusters, invalid
   candidates, first and later folds), and at rows of 14,433 and 41,000
   features (the scan's wide-row form; B4's fold over two column chunks;
   B2/B3 at K = 1);
3. pruned ≡ dense bit for bit at 0 / 10 / 100 % active (fused at the
   representatives and over all 5,000,000 rows at the K = 27 weighting
   pass's 561 candidates and at K = 800, the widest the fused seam takes;
   two-pass where K·(d+1) > 16,384), two B2 runs bit-equal at each of those
   shapes, two B1, B4 and B5 runs and two ``block_stats`` runs over the full
   dataset bit-equal, and B5 over 400 slots of which about half are valid
   bit-equal to B5 over the valid ones alone;
4. ``repro_torch.BWKM(k=27).fit`` on the SUSY-profile 5,000,000 × 19 array
   (after a first fit and predict whose wall and peak memory, with the
   autotune tuning the keys still cold, are printed apart), then
   ``predict`` and ``score`` over all of it and ``transform`` over one
   chunk, with the kernels' launch counts (each must be > 0) and ``score``
   held against a float64 computation; then k-means|| seeding on the same
   array — ``kmeans_parallel`` at K = 27 (weighting pass through B2) and
   K = 100 (2,001 candidates: B1 + B4), each with its B5 launches, its
   weighting counts, its weighting sums against float64, its weighting
   labels and d1 against the plain distances over every row, and each of
   its B5 folds against the plain fold over every row — and
   ``BWKM(k=27, init="kmeans||").fit`` with its score against float64 and
   its six B5 folds over the representatives (min-d² against the plain
   fold; the kernel's and the plain fold's costs against the float64 fold,
   and the kernel's against the weighted sum of its own min-d²); each score
   is printed beside the plain version's on the same centroids (and the
   first, with ``--parent``, beside the parent's kernel's);
5. per-kernel times from CUDA events over CUDA-graph replays, beside the
   plain version, one PyTorch yardstick and the card's bound (from
   ``repro_torch.roofline.analysis``'s seam bounds): each kernel
   at the shape of most of its launches, then B1, B2 and B5 at the
   k-means|| runs' own inputs, with the two-pass route (B1 + B4) beside B2
   at 561 candidates and B2's scratch bytes there, then B5's other eight
   launches of phase 4 (the two seed folds at L = 1 over every row and the
   six folds over the 14,528 representatives), each with its bound and its
   library time, B4's fold and its reduction launched alone, every kernel
   at the wide rows of phase 2 beside its plain version, and the SM clock
   and power draw that ``nvidia-smi`` reads while B1 at 2,001 candidates
   and B5 at 112 run back to back. With ``--parent``, every row (and the
   two-pass route) also times the parent's kernel on the same inputs, in
   turns; B4 at K = 2,001 and B2 at 561 candidates over all 5,000,000 rows
   must be bit-equal to the parent's kernels (sums, counts, err); and the
   walls of the SUSY fit and of k-means|| at K = 27 and K = 100 are taken
   with the parent's package and with this one, each in a process of its
   own (parent, this, this, parent; three timed runs each).

6. (run right after phase 2, before the data goes on the card, so that the
   fit's peak memory is its own) the streaming engine: the same SUSY array
   written by ``write_npy_shards`` as 20 shards of 250,000 rows and streamed
   by glob in 65,536-row chunks (77, the last ragged). ``BWKM(k=27).fit(glob)``
   must take the streaming engine, stream ``passes × n`` rows exactly and
   peak under 256 MiB of device memory; its streamed block statistics
   against one ``block_stats`` over all rows from the plane's host
   memberships (counts and boxes bit-equal, sums within 1e-5 of Σ|x|);
   ``predict(glob)`` / ``score(glob)`` bit-equal to ``predict(x)`` /
   ``score(x)`` on the resident tensor and ``score`` within 1e-4 of float64;
   ``kmeans_parallel_streaming`` at K = 27 (weighting by B2) and K = 100 (B1
   then B4): rounds + 1 passes, weighting counts summing to n, each pass's
   first-chunk B5 fold against the plain fold, the last φ within 1e-5 of the
   float64 fold; ``streaming_lloyd`` from the fit's centroids pruned and
   dense, bit-equal; and, over the first 500,000 rows through
   ``ResilientChunkSource``, a fit under seeded transient faults bit-equal
   to the clean fit with ``retries`` equal to the schedule's faults, and
   ``quarantined_rows`` equal to the rows a ``CorruptChunkSource`` poisoned.
   The launches of each of its paths are read just after the path. The
   streamed score's gap to phase 4's in-core fit is printed, not gated.

7. (after phase 5) the online service: the SUSY array as a drifting stream
   of 77 batches of 65,536 rows, every feature shifted by +0.5 of its
   first-half standard deviation from row 2,500,000 on, through
   ``ServiceConfig(base=BWKMConfig(k=27), decay=0.9)``. Run 1: ``run_service``
   over an ``ArrayChunkSource``, checkpointing every 10 batches, with its
   wall, per-batch ms (median, p95; the bootstrap apart), CUDA-event spans of
   ``route_into_boxes``, ``block_stats`` and ``weighted_lloyd`` per batch,
   the synchronizing CUDA calls per batch (``torch.cuda.set_sync_debug_mode``),
   peak device memory, refits (there must be one after the drift), splits,
   the final block count, B1–B3 launches (each > 0) and ``score`` of the
   final centroids over all rows against float64 (1e-4). Run 2: the same
   stream through ``CrashingSource`` dies at batch 40, ``resume_service``
   continues from the newest checkpoint, and the final ``SessionState`` must
   be bit-equal to run 1's (every tensor, the key, the counters) with equal
   metrics for every batch after the cursor. One flipped byte of
   ``session§centroids`` in run 1's newest ``state.npz`` must make
   ``load_session`` raise ``CheckpointCorruptionError`` naming it. Serving:
   8 threads submit ragged predict requests (1–5,000 rows, 1,000,000 in
   all) and the main thread 8 transform requests to a ``BatchedPredictor``
   over the final centroids, then one flush: ``ceil(rows / 2048)`` chunk
   calls per kind, every request's labels bit-equal to ``ops.assign_top2``,
   the transforms equal to ``ops.pairwise_sqdist_chunk``. Then the first 8
   batches of 4,096 rows on the card and on the CPU with the draws made on
   the CPU: the bootstrap's error within rtol 1e-3, and each later batch
   taken on both devices from the card's state before it (equal refit,
   n_splits, n_blocks; error within rtol 1e-3); and
   ``BWKM(k=27).partial_fit`` over 5 batches bit-equal to a ``BWKMSession``.
   Its launches (run 1's and the flush's) join the JSON line's.

8. (after phase 7) the paper's trade-off at full scale, with
   ``benchmarks/bench_tradeoff.py``'s methods and settings: BWKM
   (``engine="incore", max_iters=20, trace=True``), FKM, KM++, KM++_init,
   KMC2 (chain 100), MB100/500/1000 (150 steps) and grid-RPKM on the SUSY
   array at K = 3, 9 and 27, and FKM, KM++, KM++_init and KMC2 on the WUY
   profile (45,811,883 × 5, made here from seed 0) at K = 27, each with
   ``rnd.key(K)``. One line per (dataset, K, method): distances,
   ``kmeans_error``, Ê_M, wall seconds (the method alone, after a
   synchronize) and the card's name and power limit; BWKM's per-iteration
   (distances, error) curve. Checks: (a) every ``kmeans_error`` within
   1e-4 of float64 over all rows; (b) every baseline's distances within
   1e-5 of the reference's formula for it; (c) grid-RPKM's level-1 cells
   and counts over all of SUSY equal ``np.unique(axis=0)``'s on the host;
   (d) KMC2, MB1000 and grid-RPKM at K = 27 run twice bit-equal; (e)
   1,000,000 categorical draws over WUY's 45,811,883 rows reach past 2^24
   in the expected share (within 0.005), and each KM++_init seed on WUY is
   a row of WUY; (f) B1–B4 launch in the phase and no plain distance or
   statistics function of ``kernels/ref.py`` is called. Then B1 and B4 at
   the mini-batch shapes and B2 at grid-RPKM's level-1 cells are timed
   beside their plain versions, library calls and bounds. Its launches join
   the JSON line's.

9. (after phase 8) the distributed engine on the same SUSY array. 9a, in
   this process, one rank over NCCL (``init_process_group``, then
   ``init_device_mesh(..., mesh_dim_names=("data",))`` and ``use_mesh``):
   ``engine="auto"`` must pick ``distributed``; ``BWKM(k=27,
   engine="distributed", checkpoint_dir=...).fit`` with its wall and peak
   memory beside phase 4's in-core fit, B1–B3 launched, its initial
   statistics bit-equal to ``block_stats`` over all rows with the plane's
   memberships, ``score`` within 1e-4 of float64 and the last checkpoint
   restoring the result; ``dist_lloyd`` from its centroids pruned ≡ dense
   bit for bit; ``dist_kmeans_parallel`` at K = 27 launching B5, its φ
   within 1e-5 of the float64 fold. 9b, four ranks spawned on the same card
   over gloo, rank r loading phase 6's shards 5r to 5r + 4 (its contiguous
   1,250,000 rows): on every rank the fit bit-equal to 9a's (centroids,
   stop reason, blocks, distances), ``dist_lloyd`` pruned ≡ dense and equal
   on every rank, ``dist_kmeans_parallel`` twice bit-equal and equal on
   every rank, ``shard_faults={1: [2]}`` completing with one lost shard, one
   degraded round and a lost mass of 0.25, and ``max_shard_loss_frac=0.2``
   raising ``ShardLossError`` on all four. 9c, the same four ranks after
   9b's work, build further meshes in turn: (a) ``("pod", "data",
   "model")`` (2, 2, 1) on 9b's rows: ``n_data_shards() == 4``, the fit
   bit-equal to 9a's and ``shard_faults={1: [2]}`` as in 9b; (b) ``("data",
   "model")`` (2, 2) on SUSY (d = 19 is odd, so every model rank holds its
   batch rank's 2,500,000 rows whole): the fit bit-equal to 9a's; (c) the
   same mesh on ``gmm_dataset(0, 1_048_576, 128, 27)`` (written by this
   process beside 9a), each rank holding 524,288 × 64 of it (a
   ``FeatureSlice``): the fit bit-equal to the same ranks' fit on a
   ``("data",)`` (4,) mesh and on every rank with B1–B3 launched,
   ``dist_lloyd`` pruned ≡ dense, ``dist_kmeans_parallel`` at K = 27
   launching B5 and equal on every rank. The ranks are joined under a
   deadline; each prints its walls and peak memory (9c: its resident
   ``x`` and the fit's collective bytes too), and their launches join the
   JSON line's. Four ranks on one card check correctness, not scaling.

10. (after phase 9) the measured autotune (``repro_torch.kernels.autotune``)
   from a fresh cache at the main path's shapes: B1 at the predict chunk
   [65,536, 19] × 27 (its seam ``assign_update``), B2 and B3 at the
   representatives [14,528, 19] × 27, B2 at the k-means|| weighting pass
   [5,000,000, 19] × 561 and B5 at a k-means|| round [5,000,000, 19], L =
   112. Each candidate's time (at the key's bucket shape), the analytic
   plan's and the choice, beside the card's name and power limit; every
   candidate plan and the choice give the analytic plan's outputs bit for
   bit on the real inputs; a second call is a cache hit that times nothing;
   after ``clear_memo`` every key comes back from the file. Then
   ``BWKM(k=27).fit`` from a fresh cache bit-equal to the fit with
   ``REPRO_AUTOTUNE=0`` (centroids, stop reason, iterations, distances),
   with its wall and peak memory, and the drivers as a user runs them:
   ``python -m repro_torch.launch.cluster --dataset SUSY --k 27 --compare``
   and ``python -m repro_torch.launch.serve --task clusters``.

11. (after phase 10) KV-cache quantisation (``repro_torch.vq``) on
   granite-8b at full width and depth from random weights made from a
   seed: 11a ``generate`` over 8 ``TokenStream`` prompts of 512 tokens and
   32 decode steps (tok/s, peak memory); (b) a codebook of the prefill
   cache's own rows (K = 34,816 a layer, uint16 codes), one
   ``decode_quantized`` step against ``decode`` within 1e-3 of max
   |logit|; (c) ``fit_kv_codebook(k=256)`` on K and V of every third
   layer, 24 streaming fits of 32,768 rows, every audit entry
   ``streaming``; (d) ``random_kv_codebook``, each fitted source's
   round-trip MSE beside random's (the mean must be lower for BWKM) and
   equal to B1's mean d1 on its rows within 1e-5; (e)-(f) serve from a
   codebook of BWKM's layers and random's elsewhere: (e) the uint8
   cache exactly 2·hd times smaller than the bf16 one; (f)
   ``generate_quantized`` and ``teacher_forced_nll`` for fp, BWKM and
   random (a readout); (g) B1, B4 and B5 launched and no plain distance
   function called; then B1 timed at the path's shapes. 11b seeds a MoE
   router at deepseek-moe-16b's widths with its depth cut to 2 of 28
   layers (unit or zero columns, a refresh from the session, a finite
   forward, the expert-load CV beside a random router's). 11c runs
   ``python -m repro_torch.launch.serve --task lm --kv-quantize``.

12. (after phase 11) the recurrent and vision families
   (``repro_torch.models``' ssm, hybrid and vlm) at their published widths
   from random weights made from a seed, 8 ``TokenStream`` prompts × 512
   tokens: 12a mamba2-130m and 12b zamba2-1.2b at full depth, each
   ``generate`` with 32 greedy steps (prefill s, ms a step, tok/s, peak
   memory), a teacher-forced check (``prefill`` of 256 tokens, then 4
   ``decode`` steps, against ``forward``'s logits at those positions) and
   bf16 against f32 on the same weights; 12a also holds one layer's chunked
   SSD over 512 tokens against 512 recurrent steps in f32 with stressed
   weights (rtol/atol 2e-3), where the carried state zeroed between chunks
   must fail; 12b checks the cache shapes, its 2-layer Mamba tail included.
   12c llama-3.2-vision-90b at full width, depth cut from 100 to 10 layers
   (the f32 tree of 100 layers is about 350 GB): seeded gates and bf16
   image embeddings [8, 1,601, 8,192], ``prefill`` and 32 ``decode``
   steps, the teacher-forced check in bf16 and in f32, the f32 logits moved
   by other image embeddings, and the prefill cache quantised with a
   codebook of 256 of its own rows per self layer and kind: B1 launched,
   held against its plain version at every shape, the image K/V passed
   through bit-equal, one ``decode`` step over the dequantised cache. 12d
   runs ``python -m repro_torch.launch.serve --task lm --arch mamba2-130m``
   and ``--arch zamba2-1.2b`` (exit 0) and ``--arch mamba2-130m
   --kv-quantize`` (the reference's ``ValueError``), the three at once.

13. (after phase 12) training at full width from random weights made from
   a seed, batches of 2 × 4,096 ``TokenStream`` tokens, AdamW at lr 1e-3 on
   one fixed batch, remat on: 13a qwen3-4b (d 2,560, 32 heads, kv 8, vocab
   151,936) with its depth cut from 36 to 4 layers (1.18 G parameters,
   about 19 GB of f32 weights, moments and gradients): ``_Flash``'s dq, dk,
   dv at q [1, 4,096, 32, 128] against autograd through ``masked_full`` in
   f32 (1e-4 of max |g|) and bf16 (1e-2), with each one's peak memory;
   five steps whose loss must fall (seconds a step, tokens/s, peak
   memory); a ``grad_accum=2`` step's loss against ``grad_accum=1``'s from
   the same parameters (relative 5e-3). 13b zamba2-1.2b as published,
   three steps (the SSD backward over 16 chunks, the shared block's flash
   backward), its loss falling and every leaf of the shared block and the
   Mamba layers with a finite, non-zero gradient at step 1. 13c
   deepseek-moe-16b with its depth cut to 2 of 28 layers, three steps, the
   router's gradient finite and non-zero. 13d ``python -m
   repro_torch.launch.train --arch granite-8b --reduced`` for 12 steps
   (checkpoints every 6) beside an uninterrupted 14-step run, then each
   resumed to 14: the same schedule's resume within 1e-4 of the
   uninterrupted losses, the 12-step run's within 2e-2 (its cosine
   schedule ran over 12 steps); whether the 12-step loss fell is printed,
   not gated (a new emission table every step: it falls for some seeds
   only, the reference's too).

14. (after phase 13) the dry run (``repro_torch.launch.dryrun``): 14a
   ``python -m repro_torch.launch.dryrun --cell ... --jobs 6`` traces one
   cell for each (family × kind), the family's cheapest arch, at full width
   and depth on the ``16x16`` mesh (a fake process group of 256 ranks)
   with no card visible, and beside it the vlm's prefill_32k at 10 of its
   100 layers (at full depth it alone takes about a minute of one core),
   then prints the report's tables and the cells it cut; 14b, beside them,
   traces qwen3-4b (train [1, 4,096] with remat, prefill [1, 32,768],
   decode [8] over a 32,768 cache) and deepseek-moe-16b (train [1, 4,096])
   at full width with 2 layers at one rank and runs the same steps on the
   card: the traced FLOPs equal ``FlopCounterMode``'s count on the card
   (relative 1e-9) and ``peak_bytes_est`` over the card's peak memory
   (above what was allocated before the cell's arguments) lies in [0.67,
   1.5].

15. (after phase 14) the FSDP step (``repro_torch.distributed.fsdp``) on
   two gloo ranks spawned on the one card (a failed or hung rank fails the
   phase; every rank is stopped), beside the smoke's own process at one
   rank with no mesh, which takes the ranks' rows as its micro-batches
   (``grad_accum`` = 2): 15a qwen3-4b at full width, 2 layers, bf16, remat,
   two steps on [2, 4,096]: the losses and grad-norms (relative 1e-5), the
   first moment (1e-4 of each leaf's max and of the tree's L2 norm) and the
   parameters after step 1 against one rank's, a control with each rank's
   gradient left unreduced that must miss the norm and the moment by 100×,
   each rank's collectives equal to the dry run's rule for the cell at
   W = 2, its resident bytes at most half of one rank's plus the
   replicated leaves and 64 MiB, and its peak beside ``peak_bytes_est``;
   15b the same shards serve, prefill [2, 512] and 4 decode steps
   teacher-forced on one rank's greedy tokens (3e-2 of max |logit|); 15c
   deepseek-moe-16b at full width, 1 of 28 layers, one step against one
   rank running each rank's row apart.

16. (after phase 15) the model axis (``repro_torch.distributed.tp``:
   tensor and sequence parallelism, the MoE's islands) on two gloo ranks
   spawned on the one card as a (1, 2) ``("data", "model")`` mesh, beside
   the smoke's own process at one rank on the whole batch: 16a qwen3-4b at
   full width, 2 layers, f32 (in bf16 GEMMs of other shapes round
   otherwise, as phase 15 found), remat, two steps on [2, 4,096] held
   against one rank's with phase 15's tolerances, a control with the row-parallel
   partials left unreduced that must miss the loss and the norm by 100×,
   each rank's collectives equal to the dry run's rule for the cell on the
   (1, 2) mesh, its resident bytes at most half of one rank's plus the
   model-replicated leaves and 64 MiB, its peak beside ``peak_bytes_est``,
   and the same shards serving (prefill [2, 512] over 258 cache slots a
   rank, 4 decode steps, each rank's vocabulary columns; 3e-2 of max
   |logit|); 16b deepseek-moe-16b, 1 of 28 layers, bf16, one step in the ``ep``
   island (32 of 64 experts a rank), the layer's output against the local
   MoE on each rank's own tokens (3e-2 of max |y|); 16c mamba2-130m (4 of
   24 layers; the Mamba heads split, the gated norm's sums added over the
   ranks), 16d zamba2-1.2b (6 of 38 layers: one group and the shared
   block) and 16e musicgen-medium (2 of 48 layers), each in f32 with 16a's
   checks, two steps on [2, 2,048], prefill [2, 512] and 4 decode steps
   (16e in a session of 517 slots, which the two ranks do not split: each
   holds the cache whole, gated on its slot count, and decodes over all of
   it with no combine);
   16f llama-3.2-vision-90b (5 of 100 layers: 4 self, 1 cross; bf16)
   serving only, prefill [2, 512] with bf16 image embeddings [2, 1,601,
   8,192] and 4 decode steps (3e-2 of max |logit|), each rank drawing the
   whole tree in turn.

The whole run keeps its autotune cache in a fresh temporary file
(``REPRO_AUTOTUNE_CACHE``), so every key is tuned on this card in this run.
Then the card's name and power limit, one JSON line of kernel records, and
the result line ``{"ok": true, "device": {...}}`` last. Without a CUDA
device, or without the rest of the repository beside it, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}
BIG = 3.0e38  # the masked-distance sentinel of the kernels
SUSY_K = 27
CAPACITY_REPS = 14_528  # BWKMConfig.resolve(5_000_000, 19) capacity at K = 27
CHUNK = 65_536


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- phase 2
def _data(torch, n, d, k, dtype, seed, wmode="uniform", far=None):
    """Random rows, weights and centroids; with ``far``, about half the
    centroids (never the first) sit at that value, as k-means|| parks the
    weighting pass's unfilled candidate slots."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, d, generator=g, device="cuda") * 3).to(dtype)
    c = (torch.randn(k, d, generator=g, device="cuda") * 3).to(dtype)
    u = torch.rand(n, generator=g, device="cuda")
    if wmode == "zeros-some":
        w = torch.where(u < 0.5, 0.0, 1.5)
    else:
        w = u * 3.0
    if far is not None:
        park = torch.rand(k, generator=g, device="cuda") < 0.5
        park[0] = False
        c[park] = far
    return x, w, c


def _maxerr(torch, a, b):
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    check(bool((torch.isfinite(a) == fin).all()), "finite pattern differs")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def _close(torch, a, b, tol, what, scale=None):
    """|a − b| <= atol + rtol·max(|b|, scale); ``scale`` is Σ|terms| for a
    sum, whose rounding depends on the order it was taken in. Returns the
    largest absolute and relative (to ``max(|b|, scale)``) differences."""
    err = _maxerr(torch, a, b)
    fin = torch.isfinite(b)
    a, b = a.double()[fin], b.double()[fin]
    mag = b.abs() if scale is None else torch.maximum(b.abs(), scale.double()[fin])
    diff = (a - b).abs()
    check(bool((diff <= tol["atol"] + tol["rtol"] * mag).all()), f"{what}: max abs err {err}")
    rel = float((diff / mag.clamp(min=1e-30)).max()) if diff.numel() else 0.0
    return err, rel


def _abs_sums(torch, ref, x, w, a, k):
    """Σ|w·x| and Σ|w| per cluster: the scale of the sums' rounding."""
    return ref.cluster_sums(x.float().abs(), w.abs(), a, k)


def _labels_ok(torch, ref, x, c, a, tol, what, rows=None):
    dd = ref.pairwise_sqdist(x, c).double()
    idx = torch.arange(x.shape[0], device=x.device)
    if rows is not None:
        dd, idx, a = dd[rows], idx[: int(rows.sum())], a[rows]
    check(bool(torch.isclose(dd[idx, a.long()], dd.min(1).values, **tol).all()),
          f"{what}: labels not at the minimum distance")


def phase_kernels(torch, ref, da, fau, far):
    # max |kernel − plain| of the per-row distances d1, d2, and the largest
    # relative difference of the statistics (sums, counts, err)
    errs = {(b, dt): 0.0 for b in ("B1", "B2", "B3") for dt in ("float32", "bfloat16")}
    rel = {(b, dt): 0.0 for b in ("B2", "B3") for dt in ("float32", "bfloat16")}
    cases = [  # (n, d, K, wmode, about half the centroids parked at ``far``)
        (CAPACITY_REPS, 19, SUSY_K, "uniform", False),  # the partition's representatives
        (CHUNK, 19, SUSY_K, "uniform", False),  # one predict/score chunk
        (1000, 19, SUSY_K, "uniform", False),  # n not a multiple of the 128-row CTA
        (777, 19, 1, "uniform", False),  # K = 1: d2 = +inf
        (3000, 19, 300, "uniform", False),  # K beyond one 32-centroid tile
        (CAPACITY_REPS, 19, SUSY_K, "zeros-some", False),  # half the weights zero
        # the k-means|| weighting passes' candidate sets: K = 27's 561 (B2,
        # over a chunk of rows and over the representatives) and K = 100's
        # 2,001 (beyond the fused limit: B1 only here, B4 below)
        (CHUNK, 19, 561, "uniform", True),
        (CAPACITY_REPS, 19, 561, "uniform", True),
        (CHUNK, 19, 2001, "uniform", True),
    ]
    n_checks = ties = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for i, (n, d, k, wmode, parked) in enumerate(cases):
            x, w, c = _data(torch, n, d, k, dtype, seed=100 + i, wmode=wmode,
                            far=far if parked else None)
            tag = f"{dtype} n={n} K={k} {wmode}" + (" half parked" if parked else "")
            # B1
            a, d1, d2 = da.assign_top2_cuda(x, c)
            ra, rd1, rd2 = ref.assign_top2(x, c)
            _labels_ok(torch, ref, x, c, a, tol, f"B1 {tag}")
            errs["B1", dname] = max(errs["B1", dname],
                                    _close(torch, d1, rd1, tol, f"B1 d1 {tag}")[0],
                                    _close(torch, d2, rd2, tol, f"B1 d2 {tag}")[0])
            if k == 1:
                check(bool(torch.isinf(d2).all()), "B1 K=1: d2 must be +inf")
            n_checks += 1
            if not fau.fused_supported(d, k):
                continue
            # B2; its statistics against the plain sums under its own labels,
            # once those are checked at the minimum, so a legal near-tie (a
            # row the plain version puts in the other of two equally close
            # clusters) cannot move a row between the two sides
            out = fau.fused_assign_update_cuda(x, w, c)
            r = ref.assign_update(x, w, c)
            _labels_ok(torch, ref, x, c, out[0], tol, f"B2 {tag}")
            ties = max(ties, int((out[0] != r.assign).sum()))
            sums, counts = ref.cluster_sums(x, w, out[0], k)
            r = r._replace(sums=sums, counts=counts)
            scale = (None, None, None) + _abs_sums(torch, ref, x, w, out[0], k)
            e = [_close(torch, out[j], r[j], tol, f"B2 {f} {tag}", scale[j])
                 for j, f in ((1, "d1"), (2, "d2"), (3, "sums"), (4, "counts"))]
            e.append(_close(torch, out[5], r.err, dict(rtol=max(tol["rtol"], 1e-5), atol=0.0),
                            f"B2 err {tag}"))
            errs["B2", dname] = max(errs["B2", dname], e[0][0], e[1][0])
            rel["B2", dname] = max(rel["B2", dname], *(r_ for _, r_ in e[2:]))
            # B3: half active, none active, all active
            g = torch.Generator(device="cuda").manual_seed(7 + i)
            cached = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
            half = torch.rand(n, generator=g, device="cuda") < 0.5
            for mode, act in (("half", half), ("none", torch.zeros_like(half)),
                              ("all", torch.ones_like(half))):
                p = fau.fused_assign_update_pruned_cuda(x, w, c, cached, act)
                rp = ref.assign_update_pruned(x, w, c, cached, act)
                check(bool((p[0][~act] == cached[~act]).all()), f"B3 {mode} {tag}: cached ids")
                if bool(act.any()):
                    _labels_ok(torch, ref, x, c, p[0], tol, f"B3 {mode} {tag}", rows=act)
                    errs["B3", dname] = max(
                        errs["B3", dname],
                        *(_close(torch, p[j][act], rp[j][act], tol, f"B3 {mode} {tag}")[0]
                          for j in (1, 2)))
                ties = max(ties, int((p[0] != rp.assign).sum()))
                stats = ref.cluster_sums(x, w, p[0], k)
                scale = _abs_sums(torch, ref, x, w, p[0], k)
                e = [_close(torch, p[j], stats[j - 3], tol, f"B3 {mode} {tag} stats",
                            scale[j - 3]) for j in (3, 4)]
                e.append(_close(torch, p[5], rp.err, dict(rtol=max(tol["rtol"], 1e-5),
                                                          atol=1e-6), f"B3 {mode} {tag} err"))
                rel["B3", dname] = max(rel["B3", dname], *(r_ for _, r_ in e))
                n_checks += 1
            n_checks += 1
    torch.cuda.synchronize()
    return errs, rel, n_checks, ties


def _fold_case(torch, n, d, l, dtype, seed, first, from_rows):
    """B5 inputs: candidates (rows of x, or random) with about 30 % invalid
    (the first always valid), and ``mind2`` = BIG on a first fold."""
    x, w, cand = _data(torch, n, d, l, dtype, seed=seed, wmode="zeros-some")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    if from_rows:
        cand = x[torch.randint(0, n, (l,), generator=g, device="cuda")]
    cvalid = (torch.rand(l, generator=g, device="cuda") > 0.3).float()
    cvalid[0] = 1.0
    mind2 = (torch.full((n,), BIG, device="cuda") if first
             else torch.rand(n, generator=g, device="cuda") * 300)
    return x, w, cand, cvalid, mind2


def phase_kernels_b45(torch, ref, cu, msu):
    """B4 and B5 against their plain versions (n <= 65,536: the plain
    cluster_sums is a dense [n, K] one-hot). Returns the largest absolute
    errors of B5's min-d² and B4's sums and the largest relative errors of
    B5's cost and B4's sums/counts (to Σ|terms|)."""
    errs = {(b, dt): 0.0 for b in ("B4", "B5") for dt in ("float32", "bfloat16")}
    rel = dict(errs)
    folds = [  # (n, d, L, first fold, candidates from the rows of x)
        (CHUNK, 19, 112, True, True),  # a round's batch, first fold
        (CHUNK - 51, 19, 400, False, True),  # K = 100's batch, a later fold, ragged n
        (1000, 19, 1, True, True),  # the seed fold
        (5000, 19, 112, False, False),
        (3000, 40, 70, True, False),  # d over one 32-feature chunk, L not a tile multiple
    ]
    sums_cases = [  # (n, d, K, wmode)
        (CHUNK, 19, 2001, "uniform"),  # the K = 100 weighting pass's width
        (CHUNK - 51, 19, 27, "zeros-some"),
        (777, 19, 1, "uniform"),
        (1000, 19, 2001, "zeros-some"),  # most clusters empty
        (3000, 40, 70, "uniform"),
        (20_000, 19, 4000, "uniform"),  # K·(d+1) over one shared partial
    ]
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for i, (n, d, l, first, from_rows) in enumerate(folds):
            x, w, cand, cvalid, mind2 = _fold_case(torch, n, d, l, dtype, 200 + i, first, from_rows)
            tag = f"B5 {dtype} n={n} L={l} first={first} rows={from_rows}"
            new, cost = msu.min_sqdist_update_cuda(x, w, cand, cvalid, mind2)
            r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
            # f32 rounding of ‖x‖² − 2x·c + ‖c‖² scales with ‖x‖² + ‖c‖²
            scale = (x.float() ** 2).sum(1) + (cand.float() ** 2).sum(1).max()
            errs["B5", dname] = max(errs["B5", dname],
                                    _close(torch, new, r.mind2, tol, tag, scale)[0])
            rel["B5", dname] = max(rel["B5", dname], _close(
                torch, cost, r.cost, dict(rtol=max(tol["rtol"], 1e-5), atol=0.0), f"{tag} cost")[1])
            check(bool((new <= mind2).all()), f"{tag}: the fold raised a min-d²")
            n_checks += 1
        for i, (n, d, k, wmode) in enumerate(sums_cases):
            x, w, _ = _data(torch, n, d, 1, dtype, seed=300 + i, wmode=wmode)
            g = torch.Generator(device="cuda").manual_seed(300 + i)
            a = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
            tag = f"B4 {dtype} n={n} K={k} {wmode}"
            sums, counts = cu.cluster_sums_cuda(x, w, a, k)
            rs, rc = ref.cluster_sums(x, w, a, k)
            ss, sc = _abs_sums(torch, ref, x, w, a, k)
            e = _close(torch, sums, rs, tol, f"{tag} sums", ss)
            errs["B4", dname] = max(errs["B4", dname], e[0])
            rel["B4", dname] = max(rel["B4", dname], e[1],
                                   _close(torch, counts, rc, tol, f"{tag} counts", sc)[1])
            check(bool((counts[torch.bincount(a.long(), minlength=k) == 0] == 0).all()),
                  f"{tag}: an empty cluster has a count")
            n_checks += 1
    torch.cuda.synchronize()
    return errs, rel, n_checks


WIDE_D = (14_433, 41_000)  # past the scan's four resident candidates, past B4's d + 1 = 40,960


def _wide_case(torch, d, seed, n=300, k=5):
    """Rows of ``d`` features: x, w (half zero), K candidates, random ids."""
    x, w, c = _data(torch, n, d, k, torch.float32, seed=seed, wmode="zeros-some")
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
    return x, w, c, ids


def phase_kernels_wide(torch, ref, da, fau, cu, msu):
    """B1, B4 and B5 at d = 14,433 and 41,000 (the scan's wide-row form, and
    B4's fold over two column chunks at 41,000), B2 and B3 at 14,433 with
    K = 1 (their fused partial K·(d + 1) <= 16,384 stays), each against its
    plain version within the f32 tolerance (sums relative to Σ|terms|).
    Returns the largest absolute error per kernel."""
    tol = TOL["float32"]
    errs = dict.fromkeys(("B1", "B2", "B3", "B4", "B5"), 0.0)
    for i, d in enumerate(WIDE_D):
        x, w, c, ids = _wide_case(torch, d, seed=400 + i)
        tag = f"d={d}"
        a, d1, d2 = da.assign_top2_cuda(x, c)
        _labels_ok(torch, ref, x, c, a, tol, f"B1 {tag}")
        _, rd1, rd2 = ref.assign_top2(x, c)
        errs["B1"] = max(errs["B1"], _close(torch, d1, rd1, tol, f"B1 d1 {tag}")[0],
                         _close(torch, d2, rd2, tol, f"B1 d2 {tag}")[0])
        sums, counts = cu.cluster_sums_cuda(x, w, ids, c.shape[0])
        rs, rc = ref.cluster_sums(x, w, ids, c.shape[0])
        ss, sc = _abs_sums(torch, ref, x, w, ids, c.shape[0])
        errs["B4"] = max(errs["B4"], _close(torch, sums, rs, tol, f"B4 sums {tag}", ss)[0],
                         _close(torch, counts, rc, tol, f"B4 counts {tag}", sc)[0])
        cvalid = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0], device="cuda")
        mind2 = torch.full((x.shape[0],), BIG, device="cuda")
        new, cost = msu.min_sqdist_update_cuda(x, w, c, cvalid, mind2)
        r = ref.min_sqdist_update(x, w, c, cvalid, mind2)
        errs["B5"] = max(errs["B5"], _close(torch, new, r.mind2, tol, f"B5 {tag}")[0])
        _close(torch, cost, r.cost, dict(rtol=1e-5, atol=0.0), f"B5 cost {tag}")
        if not fau.fused_supported(d, 1):  # K·(d + 1) past the fused partial even at K = 1
            continue
        c1 = c[:1].contiguous()
        out = fau.fused_assign_update_cuda(x, w, c1)
        r = ref.assign_update(x, w, c1)
        check(bool((out[0] == 0).all()) and bool(torch.isinf(out[2]).all()), f"B2 {tag} K=1")
        scale = (None,) * 3 + _abs_sums(torch, ref, x, w, out[0], 1)
        errs["B2"] = max(errs["B2"], _close(torch, out[1], r.d1, tol, f"B2 d1 {tag}")[0],
                         *(_close(torch, out[j], r[j], tol, f"B2 {tag}", scale[j])[0]
                           for j in (3, 4)))
        _close(torch, out[5], r.err, dict(rtol=1e-5, atol=0.0), f"B2 err {tag}")
        act = torch.rand(x.shape[0], generator=torch.Generator(device="cuda").manual_seed(9),
                         device="cuda") < 0.5
        p = fau.fused_assign_update_pruned_cuda(x, w, c1, out[0], act)
        check(torch.equal(p[3], out[3]) and torch.equal(p[4], out[4]),
              f"B3 {tag}: pruned statistics not bit-equal to dense")
        errs["B3"] = max(errs["B3"], _close(torch, p[1][act], r.d1[act], tol, f"B3 d1 {tag}")[0])
        _close(torch, p[5], (w * r.d1)[act].sum(), dict(rtol=1e-5, atol=0.0), f"B3 err {tag}")
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------- phase 3
def _fused_bit_checks(torch, fau, x, w, c, g, what):
    """Two B2 runs bit-equal, and B3 at 0 / 10 / 100 % active, given the
    dense ids as its cached ids, bit-equal to the dense statistics."""
    dense = fau.fused_assign_update_cuda(x, w, c)
    again = fau.fused_assign_update_cuda(x, w, c)
    check(all(torch.equal(a, b) for a, b in zip(dense, again)), f"two B2 runs differ ({what})")
    del again
    for frac in (0.0, 0.1, 1.0):
        act = torch.rand(x.shape[0], generator=g, device="cuda") < frac
        p = fau.fused_assign_update_pruned_cuda(x, w, c, dense[0], act)
        check(torch.equal(p[0], dense[0]), f"pruned ids differ ({what}, active {frac})")
        check(torch.equal(p[3], dense[3]) and torch.equal(p[4], dense[4]),
              f"pruned statistics not bit-equal to dense ({what}, active {frac})")
        del p


def phase_determinism(torch, ops, da, fau, cu, msu, partition, x_full, far):
    x, w, c = _data(torch, CAPACITY_REPS, 19, SUSY_K, torch.float32, seed=3)
    g = torch.Generator(device="cuda").manual_seed(5)
    _fused_bit_checks(torch, fau, x, w, c, g, "representatives, K = 27")
    # the fused pass over every row: the K = 27 weighting pass's 561
    # candidates (rows of x, about half parked as k-means|| parks its unfilled
    # slots), and the widest K the fused seam takes at d = 19 (K·(d+1) =
    # 16,000, a 64 KB shared partial), unit weights as the weighting pass has
    n = x_full.shape[0]
    ones = torch.ones(n, device="cuda")
    for k, parked in ((561, True), (800, False)):
        check(fau.fused_supported(19, k), f"K = {k} is beyond the fused limit")
        c = x_full[torch.randint(0, n, (k,), generator=g, device="cuda")].clone()
        if parked:
            park = torch.rand(k, generator=g, device="cuda") < 0.5
            park[0] = False
            c[park] = far
        _fused_bit_checks(torch, fau, x_full, ones, c, g, f"all {n} rows, K = {k}")
    # the two-pass regime: K·(d+1) = 18,000 > 16,384, so B1 + B4 on both seams
    c2 = _data(torch, 900, 19, 1, torch.float32, seed=4)[0]  # 900 centroids
    dense = ops.assign_update(x, w, c2)
    for frac in (0.0, 0.1, 1.0):
        act = torch.rand(x.shape[0], generator=g, device="cuda") < frac
        p = ops.assign_update_pruned(x, w, c2, dense.assign, act)
        check(torch.equal(p.assign, dense.assign), f"two-pass pruned ids differ (active {frac})")
        check(torch.equal(p.sums, dense.sums) and torch.equal(p.counts, dense.counts),
              f"two-pass pruned statistics not bit-equal to dense (active {frac})")
    # B4 and B5 at the k-means|| path's full width
    n = x_full.shape[0]
    ones = torch.ones(n, device="cuda")
    a = torch.randint(0, 2001, (n,), generator=g, device="cuda", dtype=torch.int32)
    s1, s2 = cu.cluster_sums_cuda(x_full, ones, a, 2001), cu.cluster_sums_cuda(x_full, ones, a, 2001)
    check(all(torch.equal(u, v) for u, v in zip(s1, s2)), "two B4 runs differ")
    check(float(s1[1].double().sum()) == n, "B4 counts do not add up to n")
    cand = x_full[torch.randint(0, n, (112,), generator=g, device="cuda")]
    cv = torch.ones(112, device="cuda")
    m0 = torch.full((n,), BIG, device="cuda")
    f1, f2 = msu.min_sqdist_update_cuda(x_full, ones, cand, cv, m0), \
        msu.min_sqdist_update_cuda(x_full, ones, cand, cv, m0)
    check(all(torch.equal(u, v) for u, v in zip(f1, f2)), "two B5 runs differ")
    c1 = x_full[torch.randint(0, n, (561,), generator=g, device="cuda")]
    b1 = da.assign_top2_cuda(x_full, c1)
    check(all(torch.equal(u, v) for u, v in zip(b1, da.assign_top2_cuda(x_full, c1))),
          "two B1 runs differ")
    del b1
    # B5 loads only its valid candidates: 400 slots, about half valid, give
    # the bits of the fold over the valid ones alone
    cand = x_full[torch.randint(0, n, (400,), generator=g, device="cuda")]
    cv = (torch.rand(400, generator=g, device="cuda") < 0.5).float()
    cv[0] = 1.0
    sub = cand[cv > 0].contiguous()
    full = msu.min_sqdist_update_cuda(x_full, ones, cand, cv, f1[0])
    only = msu.min_sqdist_update_cuda(x_full, ones, sub, torch.ones(sub.shape[0], device="cuda"),
                                      f1[0])
    check(all(torch.equal(u, v) for u, v in zip(full, only)),
          "B5 over valid and invalid slots differs from B5 over the valid ones")
    del full, only, f1, f2
    n = x_full.shape[0]
    bids = {
        "one block": torch.zeros(n, dtype=torch.int32, device="cuda"),
        "14528 blocks": torch.randint(0, CAPACITY_REPS, (n,), generator=g, device="cuda",
                                      dtype=torch.int32),
    }
    for name, bid in bids.items():
        s1 = partition.block_stats(x_full, bid, CAPACITY_REPS)
        s2 = partition.block_stats(x_full, bid, CAPACITY_REPS)
        check(all(torch.equal(a, b) for a, b in zip(s1, s2)), f"block_stats ({name}) differs")
        check(float(s1.count.sum()) == n, "block_stats counts do not add up to n")
    torch.cuda.synchronize()


# ---------------------------------------------------------------- phase 4
def _score_f64(torch, x, c):
    c64 = c.double()
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], CHUNK):
        xc = x[i : i + CHUNK].double()
        dd = ((xc[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
        total += dd.min(1).values.sum()
    return float(total)


def _score_plain(torch, ref, x, c):
    """``score`` from the plain version's d1 (the f32 decomposition by a
    matrix product), summed in float64 like ``BWKM.score``."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], CHUNK):
        total += ref.assign_top2(x[i : i + CHUNK], c)[1].sum(dtype=torch.float64)
    return float(total)


def _labels_vs_f64(torch, x, c, labels):
    c64 = c.double()
    mism, worst = 0, 0.0
    for i in range(0, x.shape[0], CHUNK):
        xc = x[i : i + CHUNK].double()
        dd = ((xc[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
        mn = dd.min(1).values
        got = dd.gather(1, labels[i : i + CHUNK].long()[:, None])[:, 0]
        gap = (got - mn) / (1.0 + (xc * xc).sum(1))  # f32 rounding scales with ‖x‖²
        mism += int((gap > 0).sum())
        worst = max(worst, float(gap.max()))
    return mism, worst


def phase_fit(torch, repro_torch, ref, da, fau, x, parent):
    from repro_torch.kernels import autotune

    counters = (da.assign_top2_cuda, fau.fused_assign_update_cuda,
                fau.fused_assign_update_pruned_cuda)
    # the first fit and predict on this process's cache tune the keys that
    # phases 3 and 6 left cold: their wall and peak are printed apart, and
    # the fit below is timed with the cache warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = sum(e.get("source") == "measured" for e in autotune._memo.values())
    t0 = time.perf_counter()
    first = repro_torch.BWKM(k=SUSY_K).fit(x)
    first.predict(x)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    tuned = sum(e.get("source") == "measured" for e in autotune._memo.values()) - before
    print(f"[fit] first fit and predict, autotune tuning {tuned} cold keys: "
          f"wall_s={t_first:.3f} peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30:.3f}")
    del first
    for f in counters:
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = repro_torch.BWKM(k=SUSY_K).fit(x)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = model.predict(x)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = model.score(x)
    t_score = time.perf_counter() - t0
    dist = model.transform(x[:CHUNK])
    torch.cuda.synchronize()
    launches = {"B1": counters[0].launches, "B2": counters[1].launches,
                "B3": counters[2].launches}
    peak = torch.cuda.max_memory_allocated()
    res = model.result_
    c = model.centroids_
    print(f"[fit] stop_reason={res.stop_reason} iterations={res.iterations} "
          f"distances={res.distances:.0f} blocks={res.metadata['n_blocks'][-1]} "
          f"score={score!r} fit_s={t_fit:.3f} predict_s={t_pred:.3f} score_s={t_score:.3f} "
          f"peak_mem_GiB={peak / 2**30:.3f} launches={launches}")
    print(f"[fit] n_blocks per iteration {res.metadata['n_blocks']}")
    check(tuple(c.shape) == (SUSY_K, x.shape[1]) and bool(torch.isfinite(c).all()),
          "centroids not finite [27, 19]")
    check(labels.shape == (x.shape[0],) and labels.dtype == torch.int32
          and int(labels.min()) >= 0 and int(labels.max()) < SUSY_K, "labels out of range")
    check(dist.shape == (CHUNK, SUSY_K) and bool(torch.isfinite(dist).all()), "transform shape")
    ref_score = _score_f64(torch, x, c)
    check(abs(score - ref_score) <= 1e-4 * abs(ref_score),
          f"score {score} vs float64 {ref_score}")
    mism, worst = _labels_vs_f64(torch, x, c, labels)
    plain_score = _score_plain(torch, ref, x, c)
    parent_s = ""
    if parent is not None:
        with parent.active():
            parent_score = model.score(x)
        parent_s = f", the parent's kernel's {(parent_score - ref_score) / ref_score:+.3e}"
    print(f"[fit] score vs float64 {(score - ref_score) / ref_score:+.3e} (the plain version's "
          f"{(plain_score - ref_score) / ref_score:+.3e}{parent_s} on the same centroids); "
          f"labels off the float64 argmin: {mism} rows, worst relative gap {worst:.3e}")
    check(worst <= 1e-5, "a label is farther than f32 rounding (1e-5·‖x‖²) from the float64 argmin")
    for name, cnt in launches.items():
        check(cnt > 0, f"kernel {name} was not launched on the main path")
    return launches, score, (t_fit, peak)


def _weighting_sums_vs_f64(torch, x, au):
    """The weighting pass's sums against float64 sums under the same
    assignment, relative to Σ|w·x| per element (w = 1 here)."""
    a = au.assign.long()
    k = au.sums.shape[0]
    s64 = torch.zeros(k, x.shape[1], dtype=torch.float64, device=x.device)
    abs64 = torch.zeros_like(s64)
    for i in range(0, x.shape[0], 1_000_000):
        xc = x[i : i + 1_000_000].double()
        s64.index_add_(0, a[i : i + 1_000_000], xc)
        abs64.index_add_(0, a[i : i + 1_000_000], xc.abs())
    worst = float(((au.sums.double() - s64).abs() / abs64.clamp(min=1e-30)).max())
    check(worst <= 1e-5, f"weighting sums off float64 by {worst:.3e} of Σ|w·x|")
    return worst


def _weighting_assign_vs_plain(torch, ref, x, c, au, far):
    """The weighting pass's labels and d1 against the plain distances, in row
    chunks (the [n, K] matrix does not fit at once): each label's plain
    distance is the row's plain minimum, and d1 is that distance, both within
    1e-5 of 1 + ‖x‖² + ‖c‖² (the f32 rounding scale of the decomposition).
    No row may go to a parked candidate. Returns the two largest gaps."""
    parked = (c == far).all(1)
    check(bool((au.counts[parked] == 0).all()), "a parked candidate drew weight")
    cn = (c.double() ** 2).sum(1)
    gap = d1_err = 0.0
    for i in range(0, x.shape[0], CHUNK):
        xc = x[i : i + CHUNK]
        dd = ref.pairwise_sqdist(xc, c)
        a = au.assign[i : i + CHUNK].long()
        check(int(a.min()) >= 0 and int(a.max()) < c.shape[0], "weighting label out of range")
        got = dd.gather(1, a[:, None])[:, 0].double()
        scale = 1.0 + (xc.double() ** 2).sum(1) + cn[a]
        gap = max(gap, float(((got - dd.min(1).values.double()) / scale).max()))
        d1_err = max(d1_err, float(((au.d1[i : i + CHUNK].double() - got).abs() / scale).max()))
    check(gap <= 1e-5, f"a weighting label is {gap:.3e} of ‖x‖² + ‖c‖² off the plain minimum")
    check(d1_err <= 1e-5, f"weighting d1 is {d1_err:.3e} of ‖x‖² + ‖c‖² off the plain distance")
    return gap, d1_err


def _folds_vs_plain(torch, ref, folds):
    """Each B5 fold of a run against the plain fold on the same inputs, over
    every row: min-d² within 1e-5 of ‖x‖² + max‖c‖² (f32 rounding of the
    decomposition), the cost φ within 1e-5 relative. Returns the largest
    absolute min-d² difference and the largest relative cost difference."""
    worst_m = worst_c = 0.0
    for args, out in folds:
        x, w, cand, cvalid, mind2 = args
        r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
        scale = (x.float() ** 2).sum(1) + (cand.float() ** 2).sum(1).max()
        tag = f"B5 fold n={x.shape[0]} L={cand.shape[0]}"
        worst_m = max(worst_m, _close(torch, out.mind2, r.mind2, TOL["float32"], tag, scale)[0])
        worst_c = max(worst_c, _close(torch, out.cost, r.cost, dict(rtol=1e-5, atol=0.0),
                                      f"{tag} cost")[1])
        del r
    return worst_m, worst_c


def _fold_f64(torch, x, w, cand, cvalid, mind2, rows=2048):
    """The fold in float64 from float64 distances (differences, not the
    ‖x‖² − 2·x·c + ‖c‖² decomposition): ``(min-d², cost)``."""
    c64 = cand.double()[cvalid != 0]
    new = mind2.double().clone()
    for i in range(0, x.shape[0], rows):
        if c64.shape[0]:
            dd = ((x[i : i + rows].double()[:, None, :] - c64[None]) ** 2).sum(-1)
            new[i : i + rows] = torch.minimum(new[i : i + rows], dd.min(1).values)
    return new, float((w.double() * new).sum())


def _weighted_folds_vs_f64(torch, ref, folds):
    """The folds over weighted representatives (the seeded fit's). A
    representative that is a candidate is at distance 0 only up to the f32
    rounding of the decomposition, and its block's weight multiplies that,
    so both the kernel's and the plain fold's costs are held against the
    float64 fold, within what the per-row tolerance of ``_close`` allows:
    1e-5 · Σ w·(1 + max(min-d², ‖x‖² + max‖c‖²)). Besides: min-d² against the plain fold
    (as ``_folds_vs_plain``), and the kernel's cost within 1e-5 relative of
    the float64 sum of its own min-d² (its reduction). Returns the largest
    min-d² difference and, per fold, the kernel's and the plain fold's cost
    relative to the float64 cost and the limit in the same units."""
    worst_m, rows = 0.0, []
    for args, out in folds:
        x, w, cand, cvalid, mind2 = args
        r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
        scale = (x.float() ** 2).sum(1) + (cand.float() ** 2).sum(1).max()
        tag = f"B5 fold n={x.shape[0]} L={cand.shape[0]}"
        worst_m = max(worst_m, _close(torch, out.mind2, r.mind2, TOL["float32"], tag, scale)[0])
        _close(torch, out.cost, (w.double() * out.mind2.double()).sum(),
               dict(rtol=1e-5, atol=0.0), f"{tag} cost against its own min-d²")
        new64, c64 = _fold_f64(torch, x, w, cand, cvalid, mind2)
        limit = 1e-5 * float((w.double() * (1.0 + torch.maximum(new64, scale.double()))).sum())
        for who, cost in (("kernel", float(out.cost)), ("plain", float(r.cost))):
            check(abs(cost - c64) <= limit,
                  f"{tag}: the {who} cost {cost!r} is {abs(cost - c64):.4g} from the float64 "
                  f"cost {c64!r}, past 1e-5·Σ w·(1 + max(min-d², ‖x‖² + max‖c‖²)) = {limit:.4g}")
        rows.append(((float(out.cost) - c64) / c64, (float(r.cost) - c64) / c64, limit / c64))
        del r
    return worst_m, rows


def phase_kmeans_ll(torch, repro_torch, rnd, kmeans_ll, ops, ref, counters, x):
    """k-means|| on the full array at K = 27 and K = 100, then a BWKM fit
    seeded by it. Each run's weighting pass and B5 folds are recorded and,
    after the run, held against their plain versions over every row. Returns
    each kernel's launches summed over the three runs (counts set to 0 just
    before each run and read just after), each K's weighting-pass inputs,
    last fold and seed fold, and the inputs of the seeded fit's folds: the
    shapes phase 5 times."""
    n = x.shape[0]
    total = dict.fromkeys(counters, 0)
    seen = {}
    plain = {"assign_update": ops.assign_update, "min_sqdist_update": ops.min_sqdist_update}

    def spy(name):
        def inner(*a, **kw):
            out = plain[name](*a, **kw)
            seen[name].append((a, out))
            return out
        return inner

    for k in (27, 100):
        seen.update(assign_update=[], min_sqdist_update=[])
        for f in counters.values():
            f.launches = 0
        for name in plain:
            setattr(ops, name, spy(name))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = kmeans_ll.kmeans_parallel(rnd.key(0), x, None, k, return_info=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for name, fn in plain.items():
                setattr(ops, name, fn)
        peak = torch.cuda.max_memory_allocated()
        launches = {b: f.launches for b, f in counters.items()}
        for b in total:
            total[b] += launches[b]
        (wx, _, wc), au = seen["assign_update"][-1]
        folds = seen["min_sqdist_update"]
        n_cap = au.counts.shape[0]
        check(tuple(out.centroids.shape) == (k, x.shape[1])
              and bool(torch.isfinite(out.centroids).all()), f"K={k}: seeds not finite [{k}, 19]")
        check(launches["B5"] == 6, f"K={k}: B5 launched {launches['B5']} times, not 6")
        check(float(au.counts.double().sum()) == n,
              f"K={k}: weighting counts add up to {float(au.counts.double().sum())}, not {n}")
        worst = _weighting_sums_vs_f64(torch, x, au)
        if k == 100:
            check(n_cap == 2001 and launches["B1"] > 0 and launches["B4"] > 0,
                  "K=100: the 2,001-candidate weighting pass did not take B1 + B4")
        else:
            check(n_cap == 561 and launches["B2"] > 0, "K=27: the weighting pass did not take B2")
        gap, d1_err = _weighting_assign_vs_plain(torch, ref, wx, wc, au, kmeans_ll._FAR)
        fold_m, fold_c = _folds_vs_plain(torch, ref, folds)
        print(f"[kmeans||] K={k}: wall_s={wall:.3f} candidates={float(out.n_candidates):.0f} "
              f"of {n_cap} distances={float(out.distances):.0f} passes={out.passes} "
              f"peak_mem_GiB={peak / 2**30:.3f} launches={launches} "
              f"weighting sums vs float64 {worst:.3e} of Σ|w·x|")
        print(f"[kmeans||] K={k}: weighting labels vs plain: largest gap {gap:.3e}, d1 "
              f"{d1_err:.3e} of 1 + ‖x‖² + ‖c‖²; {len(folds)} folds at L = "
              f"{[int(a[2].shape[0]) for a, _ in folds]} vs plain over all {n} rows: "
              f"min-d² max abs err {fold_m:.3g}, cost max rel err {fold_c:.3g}")
        seen[k] = (wc, folds[-1][0], folds[0][0])
        del folds, au
    seen["min_sqdist_update"] = []
    for f in counters.values():
        f.launches = 0
    ops.min_sqdist_update = spy("min_sqdist_update")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = repro_torch.BWKM(k=SUSY_K, init="kmeans||").fit(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.min_sqdist_update = plain["min_sqdist_update"]
    rep_folds = seen["min_sqdist_update"]
    check(len(rep_folds) == 6, f"BWKM(init='kmeans||'): {len(rep_folds)} folds recorded, not 6")
    launches = {b: f.launches for b, f in counters.items()}
    for b in total:
        total[b] += launches[b]
    check(launches["B5"] == 6, f"BWKM(init='kmeans||'): B5 launched {launches['B5']} times")
    res, c = model.result_, model.centroids_
    score = model.score(x)
    ref_score = _score_f64(torch, x, c)
    check(bool(torch.isfinite(c).all()), "BWKM(init='kmeans||'): centroids not finite")
    check(abs(score - ref_score) <= 1e-4 * abs(ref_score),
          f"BWKM(init='kmeans||'): score {score} vs float64 {ref_score}")
    plain_score = _score_plain(torch, ref, x, c)
    fold_m, fold_rows = _weighted_folds_vs_f64(torch, ref, rep_folds)
    print(f"[kmeans||] BWKM(k={SUSY_K}, init='kmeans||').fit: wall_s={wall:.3f} "
          f"stop_reason={res.stop_reason} iterations={res.iterations} "
          f"distances={res.distances:.0f} blocks={res.metadata['n_blocks'][-1]} score={score!r} "
          f"(vs float64 {(score - ref_score) / ref_score:+.3e}, the plain version's "
          f"{(plain_score - ref_score) / ref_score:+.3e} on the same centroids) "
          f"launches={launches}; its {len(rep_folds)} folds at L = "
          f"{[int(a[2].shape[0]) for a, _ in rep_folds]}: min-d² vs plain max abs err "
          f"{fold_m:.3g}")
    print("[kmeans||] its folds' costs vs the float64 fold (relative; limit "
          "1e-5·Σ w·(1 + max(min-d², ‖x‖² + max‖c‖²)) in the same units): kernel "
          + ", ".join(f"{a:+.3e}" for a, _, _ in fold_rows) + "; plain "
          + ", ".join(f"{b:+.3e}" for _, b, _ in fold_rows) + "; limit "
          + ", ".join(f"{lim:.3e}" for _, _, lim in fold_rows))
    return total, {k: seen[k] for k in (27, 100)}, [a for a, _ in rep_folds]


# ---------------------------------------------------------------- phase 6
STREAM_SHARD_ROWS = 250_000
STREAM_PEAK_LIMIT = 256 << 20  # bytes: two chunks, block_stats' scratch, a route tile, M·d state


def _cost_f64(torch, x, cand, rows=16_384):
    """Σ over rows of the squared distance to the nearest of ``cand``, from
    float64 distances (the decomposition, in float64)."""
    c = cand.double()
    cn = (c * c).sum(1)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], rows):
        xc = x[i : i + rows].double()
        dd = (xc * xc).sum(1)[:, None] - 2.0 * (xc @ c.T) + cn[None]
        total += dd.clamp(min=0.0).min(1).values.sum()
    return float(total)


def _zero(counters):
    for f in counters.values():
        f.launches = 0


def _read(counters):
    return {b: f.launches for b, f in counters.items()}


def _stream_fit(torch, repro_torch, glob, counters, planes):
    from repro_torch.engine import streaming as eng

    class Recorded(eng.StreamingPlane):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            planes.append(self)

    plain = eng.StreamingPlane
    _zero(counters)
    eng.StreamingPlane = Recorded
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = repro_torch.BWKM(k=SUSY_K).fit(glob)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng.StreamingPlane = plain
    return model, wall, torch.cuda.max_memory_allocated(), _read(counters)


def _stream_kmeans_ll(torch, rnd, ops, ref, fau, counters, glob, x, k):
    """Streaming k-means|| at ``k`` over the shards, with the B5 fold of each
    pass's first chunk held against the plain fold, the weighting counts
    summed, the last φ held against the float64 fold of every candidate
    folded so far, and the weighting pass's route checked."""
    from repro_torch import streaming
    from repro_torch.data.chunks import as_chunk_source

    n = x.shape[0]
    src = as_chunk_source(glob, CHUNK)
    plain = {"min_sqdist_update_chunk": ops.min_sqdist_update_chunk,
             "assign_update_chunk": ops.assign_update_chunk}
    calls = {name: [] for name in plain}

    def spy(name):
        def inner(*a, **kw):
            out = plain[name](*a, **kw)
            calls[name].append((a, out))
            return out
        return inner

    _zero(counters)
    for name in plain:
        setattr(ops, name, spy(name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = streaming.kmeans_parallel_streaming(rnd.key(0), src, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in plain.items():
            setattr(ops, name, fn)
    launches = _read(counters)
    folds = calls["min_sqdist_update_chunk"]
    weigh = calls["assign_update_chunk"]
    nc = src.n_chunks
    check(len(folds) % nc == 0 and len(weigh) == nc,
          f"k-means|| K={k}: {len(folds)} fold and {len(weigh)} weighting chunk calls")
    check(out.passes == 5 + 1 == len(folds) // nc + 1,
          f"k-means|| K={k}: {out.passes} passes, not rounds + 1 = 6")
    check(tuple(out.centroids.shape) == (k, x.shape[1]) and bool(torch.isfinite(out.centroids).all()),
          f"k-means|| K={k}: seeds not finite [{k}, 19]")
    total = sum(float(au.counts.double().sum()) for _, au in weigh)
    check(total == n, f"k-means|| K={k}: weighting counts add up to {total}, not {n}")
    firsts = [(a, o) for a, o in folds[::nc]]
    fold_m, fold_c = _folds_vs_plain(torch, ref, [(a[:5], o) for a, o in firsts])
    last_phi = sum(float(o.cost.double()) for _, o in folds[-nc:])
    check(last_phi == out.normalisers[-1],
          f"k-means|| K={k}: the last fold's chunk costs sum to {last_phi!r}, φ is {out.normalisers[-1]!r}")
    cands = torch.cat([a[2][a[3] > 0] for a, _ in firsts])
    phi64 = _cost_f64(torch, x, cands)
    gap = (last_phi - phi64) / phi64
    check(abs(gap) <= 1e-5, f"k-means|| K={k}: φ {last_phi!r} is {gap:+.3e} off the float64 fold")
    route = ("B2",) if fau.fused_supported(x.shape[1], out.n_candidates) else ("B1", "B4")
    check(launches["B5"] == len(folds) and all(launches[b] >= nc for b in route),
          f"k-means|| K={k}: launches {launches}, weighting route {route}")
    print(f"[stream] kmeans_parallel_streaming K={k}: wall_s={wall:.3f} passes={out.passes} "
          f"candidates={out.n_candidates} weighting {'+'.join(route)} launches={launches}; "
          f"first-chunk folds vs plain: min-d² max abs err {fold_m:.3g}, cost max rel err "
          f"{fold_c:.3g}; last φ vs float64 over {cands.shape[0]} candidates {gap:+.3e}")
    return launches


def phase_stream(torch, repro_torch, rnd, ops, ref, fau, partition, counters, xs, tmp):
    """Phase 6: the streaming engine over the SUSY profile written as 20
    ``.npy`` shards into ``tmp`` (phase 9 reads them again), run before the
    data goes on the card so that the fit's peak memory is its own. Returns
    the launches of its paths summed, the data on the card, and the
    streamed fit's score."""
    import numpy as np

    from repro_torch import streaming
    from repro_torch.data.chunks import ArrayChunkSource, as_chunk_source, write_npy_shards
    from repro_torch.data.resilient import ResilientChunkSource, RetryPolicy
    from repro_torch.testing.faults import (
        CorruptChunkSource, FakeClock, FlakyIOSource, seeded_fault_schedule,
    )

    n = xs.shape[0]
    total = dict.fromkeys(counters, 0)
    t0 = time.perf_counter()
    paths = write_npy_shards(xs, tmp, rows_per_shard=STREAM_SHARD_ROWS)
    glob = f"{tmp}/*.npy"
    check(len(paths) == 20, f"{len(paths)} shards written, not 20")
    print(f"[stream] {len(paths)} shards of {STREAM_SHARD_ROWS:,} rows written in "
          f"{time.perf_counter() - t0:.1f} s; streamed by glob in {CHUNK:,}-row chunks")
    # 1. the fit
    planes = []
    model, wall, peak, launches = _stream_fit(torch, repro_torch, glob, counters, planes)
    res, md = model.result_, model.result_.metadata
    print(f"[stream] BWKM(k={SUSY_K}).fit(glob): engine={model.engine_} "
          f"stop_reason={res.stop_reason} iterations={res.iterations} "
          f"blocks={md['n_blocks'][-1]} passes={md['passes']} "
          f"points_streamed={md['points_streamed']} chunks={md['n_chunks']} wall_s={wall:.3f} "
          f"peak_mem_MiB={peak / 2**20:.1f} launches={launches}")
    check(model.engine_ == "streaming", f"fit(glob) took engine {model.engine_!r}")
    check(md["n_chunks"] == -(-n // CHUNK) == 77 and md["chunk_size"] == CHUNK,
          f"{md['n_chunks']} chunks of {md['chunk_size']}")
    check(md["points_streamed"] == md["passes"] * n,
          f"points_streamed {md['points_streamed']} != passes {md['passes']} × n")
    check(peak < STREAM_PEAK_LIMIT, f"streaming fit peak {peak / 2**20:.1f} MiB ≥ 256 MiB")
    c = model.centroids_
    check(tuple(c.shape) == (SUSY_K, xs.shape[1]) and bool(torch.isfinite(c).all()),
          "streamed centroids not finite [27, 19]")
    for b in ("B1", "B2", "B3"):
        check(launches[b] > 0, f"streaming fit: kernel {b} was not launched")
    for b in total:
        total[b] += launches[b]
    # 2. the streamed statistics against one recomputation over all rows
    x = torch.from_numpy(xs).cuda()
    part = md["partition"]
    bids = torch.from_numpy(np.concatenate(planes[0].bids)).cuda()
    check(bids.shape[0] == n, f"{bids.shape[0]} host memberships, not {n}")
    one = partition.block_stats(x, bids, part.capacity)
    check(torch.equal(one.count, part.count), "streamed block counts differ from one pass")
    check(float(part.count.double().sum()) == n, "streamed block counts do not add up to n")
    check(torch.equal(one.lo, part.lo) and torch.equal(one.hi, part.hi),
          "streamed block boxes differ from one pass")
    absum = partition.block_stats(x.abs(), bids, part.capacity).psum.double()
    psum_gap = float(((part.psum.double() - one.psum.double()).abs()
                      / absum.clamp(min=1e-30)).max())
    check(psum_gap <= 1e-5, f"streamed block sums {psum_gap:.3e} of Σ|x| off one pass")
    print(f"[stream] block statistics vs one pass over all {n:,} rows: counts and boxes "
          f"bit-equal over {int(part.n_blocks)} blocks, sums within {psum_gap:.3e} of Σ|x|")
    del one, absum, bids
    # 3. out-of-core predict/score against in memory
    _zero(counters)
    t0 = time.perf_counter()
    lab_glob = model.predict(glob)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_glob = model.score(glob)
    t_score = time.perf_counter() - t0
    launches = _read(counters)
    check(launches["B1"] == 2 * md["n_chunks"], f"out-of-core predict/score launches {launches}")
    total["B1"] += launches["B1"]
    lab_x, s_x = model.predict(x), model.score(x)
    check(torch.equal(lab_glob, lab_x), "predict(glob) differs from predict(x)")
    check(s_glob == s_x, f"score(glob) {s_glob!r} != score(x) {s_x!r}")
    ref_score = _score_f64(torch, x, c)
    check(abs(s_glob - ref_score) <= 1e-4 * abs(ref_score),
          f"score(glob) {s_glob} vs float64 {ref_score}")
    print(f"[stream] predict(glob) bit-equal to predict(x), score(glob) == score(x) = "
          f"{s_glob!r} (vs float64 {(s_glob - ref_score) / ref_score:+.3e}); "
          f"predict_s={t_pred:.3f} score_s={t_score:.3f}")
    # 4. streaming k-means||
    for k in (27, 100):
        launches = _stream_kmeans_ll(torch, rnd, ops, ref, fau, counters, glob, x, k)
        for b in total:
            total[b] += launches[b]
    # 5. full-stream Lloyd, pruned and dense
    src = as_chunk_source(glob, CHUNK)
    runs = {}
    for prune in (True, False):
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[prune] = streaming.streaming_lloyd(src, c, max_iters=10, prune=prune)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read(counters)
        r = runs[prune]
        print(f"[stream] streaming_lloyd prune={prune}: wall_s={wall:.3f} iters={r.iters} "
              f"error={r.error!r} distances={r.distances:.0f} launches={launches} "
              f"active fractions {[round(a, 4) for a in r.active_fractions]}")
        check(launches["B2" if not prune else "B3"] > 0, f"streaming_lloyd launches {launches}")
        for b in total:
            total[b] += launches[b]
    pr, de = runs[True], runs[False]
    check(pr.iters == de.iters, f"streaming_lloyd: {pr.iters} pruned iterations, {de.iters} dense")
    check(torch.equal(pr.centroids, de.centroids), "streaming_lloyd: pruned != dense centroids")
    check(pr.distances < de.distances, "streaming_lloyd: pruning saved no distance")
    # 6. faults, on the first 500,000 rows (8 chunks)
    base = ArrayChunkSource(xs[:500_000], CHUNK)
    sched = seeded_fault_schedule(base.n_chunks, rate=0.4, seed=1, fails=2)
    check(bool(sched), "the seeded fault schedule is empty")

    def resilient(inner):
        clock = FakeClock()
        return ResilientChunkSource(inner, policy=RetryPolicy(max_attempts=4, base_delay_s=0.001),
                                    sleep=clock.sleep, clock=clock.time)

    clean = repro_torch.BWKM(k=SUSY_K).fit(base).result_
    flaky = repro_torch.BWKM(k=SUSY_K).fit(resilient(FlakyIOSource(base, sched))).result_
    check(torch.equal(clean.centroids, flaky.centroids)
          and clean.metadata["n_blocks"] == flaky.metadata["n_blocks"]
          and clean.stop_reason == flaky.stop_reason,
          "the fit under transient faults differs from the clean fit")
    check(flaky.metadata["health"]["retries"] == sum(sched.values()),
          f"retries {flaky.metadata['health']['retries']}, schedule {sched}")
    corrupt = CorruptChunkSource(base, {2: 5, 6: 3})
    bad = repro_torch.BWKM(k=SUSY_K).fit(resilient(corrupt)).result_
    want_q = (5 + 3) * bad.metadata["passes"]  # the same rows are poisoned on every pass
    check(bad.metadata["health"]["quarantined_rows"] == want_q,
          f"quarantined {bad.metadata['health']['quarantined_rows']} rows, corrupted {want_q}")
    check(bool(torch.isfinite(bad.centroids).all()), "the fit over corrupt chunks is not finite")
    print(f"[stream] faults over 500,000 rows ({base.n_chunks} chunks): schedule {sched} -> "
          f"bit-identical fit ({clean.stop_reason}, {clean.iterations} iterations), retries "
          f"{flaky.metadata['health']['retries']}; 8 corrupt rows a pass over "
          f"{bad.metadata['passes']} passes -> quarantined_rows "
          f"{bad.metadata['health']['quarantined_rows']}")
    return total, x, s_glob


# ---------------------------------------------------------------- phase 7
SERVICE_CRASH_AT = 40  # the crashed run dies reading this chunk
SERVICE_CKPT_EVERY = 10
SERVICE_SHIFT_SD = 0.5  # the drift: every feature moves by this many of its first-half std
SERVICE_SERVE_ROWS = 1_000_000
SERVICE_SMALL_ROWS = 4_096  # the card-against-CPU run's batches
SERVICE_BOOT_ITERS = 8  # the bootstrap fit's outer iterations
SERVICE_MAX_SPLITS = 64  # splits a refit at most


class _CpuDrawKey:
    """The production key with every draw made on the CPU and moved to the
    device asked for, so a session on the card and one on the CPU draw the
    same numbers (CPU and CUDA generators differ)."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return tuple(_CpuDrawKey(k) for k in self.key.split(num))

    def fold_in(self, data):
        return _CpuDrawKey(self.key.fold_in(data))

    def randint(self, shape, minval, maxval, device):
        return self.key.randint(shape, minval, maxval, "cpu").to(device)

    def categorical(self, logits, shape=None):
        return self.key.categorical(logits.cpu(), shape).to(logits.device)

    def uniform(self, shape, device):
        return self.key.uniform(shape, "cpu").to(device)

    def gumbel(self, shape, device):
        return self.key.gumbel(shape, "cpu").to(device)

    def choice(self, n, shape, device):
        return self.key.choice(n, shape, "cpu").to(device)


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class _BatchProbe:
    """Per ``partial_fit`` call: host wall (ending in a synchronize), the
    synchronizing CUDA calls that ``torch.cuda.set_sync_debug_mode`` reports
    inside it, and CUDA-event spans of the named functions it calls."""

    def __init__(self, torch, session_cls, spans):
        self.torch, self.session_cls, self.spans = torch, session_cls, spans
        self.batches = []  # (wall_s, syncs, {span: [(e0, e1)]})

    @contextlib.contextmanager
    def active(self):
        import warnings

        torch = self.torch
        fit = self.session_cls.partial_fit
        probe = self

        def timed_fit(session, batch):
            events: dict[str, list] = {}
            probe._events = events
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    out = fit(session, batch)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            probe.batches.append((wall, syncs, events))
            return out

        def span(name, fn):
            def inner(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                probe._events.setdefault(name, []).append((e0, e1))
                return out
            return inner

        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(self.session_cls, "partial_fit", timed_fit))
            for name, (mod, attr) in self.spans.items():
                stack.enter_context(_patched(mod, attr, span(name, getattr(mod, attr))))
            yield self

    def span_ms(self, name, batches):
        return [sum(e0.elapsed_time(e1) for e0, e1 in self.batches[i][2].get(name, []))
                for i in batches]


def _pct(a, q):
    import numpy as np

    return float(np.percentile(np.asarray(a, dtype=np.float64), q))


def _state_bit_equal(torch, a, b) -> list[str]:
    """The fields of two SessionStates that differ in any bit (the key by
    its 64-bit seed)."""
    bad = []
    for f in a.partition._fields:
        x, y = getattr(a.partition, f), getattr(b.partition, f)
        if x.dtype != y.dtype or not torch.equal(x, y):
            bad.append(f"partition.{f}")
    for f in ("centroids", "d1", "d2", "batches", "points"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not torch.equal(x, y):
            bad.append(f)
    if a.key.seed != b.key.seed:
        bad.append("key")
    return bad


def _state_to(state, device):
    """A SessionState with its tensors copied to ``device``."""
    part = state.partition._replace(**{f: getattr(state.partition, f).to(device)
                                       for f in state.partition._fields})
    return state._replace(partition=part, **{f: getattr(state, f).to(device)
                                             for f in ("centroids", "d1", "d2", "batches", "points")})


def phase_service(torch, repro_torch, rnd, ops, counters, x):
    """Phase 7: the online service over the SUSY profile as a drifting
    stream of 77 batches. Returns the launches of its paths."""
    import tempfile

    import numpy as np

    from repro_torch.core import lloyd
    from repro_torch.core import partition as part_mod
    from repro_torch.core.bwkm import BWKMConfig
    from repro_torch.data.chunks import ArrayChunkSource
    from repro_torch.service import (
        BatchedPredictor, BWKMSession, ServiceConfig, load_session, resume_service, run_service,
    )
    from repro_torch.service import session as smod
    from repro_torch.testing.faults import CrashingSource, InjectedCrash
    from repro_torch.train.checkpoint import CheckpointCorruptionError

    t_phase = time.perf_counter()
    n, d = x.shape
    stream = x.cpu().numpy()
    half = n // 2
    sd = stream[:half].std(axis=0, dtype=np.float64)
    shift = (SERVICE_SHIFT_SD * sd).astype(np.float32)
    stream[half:] += shift
    src = ArrayChunkSource(stream, CHUNK)
    nb = src.n_chunks
    drift_batch = half // CHUNK
    print(f"[service] stream: SUSY profile {n:,} × {d} as {nb} batches of {CHUNK:,} rows (the last "
          f"{n - (nb - 1) * CHUNK:,}); from row {half:,} (inside batch {drift_batch}) every feature "
          f"shifted by {SERVICE_SHIFT_SD} of its first-half std: "
          + "[" + ", ".join(f"{v:.4f}" for v in shift) + "]")
    check(nb == 77, f"{nb} batches, not 77")
    # BWKMConfig(k=27)'s own bootstrap fills all 14,528 block rows (stop reason
    # "capacity"), and a service at capacity never refits: 8 outer iterations
    # leave about 8,800 rows free, and at most 64 splits a refit spread them
    # over the whole stream, so the refit path runs after the drift too
    cfg = ServiceConfig(base=BWKMConfig(k=SUSY_K, max_iters=SERVICE_BOOT_ITERS), decay=0.9,
                        max_splits_per_refit=SERVICE_MAX_SPLITS)
    total = dict.fromkeys(counters, 0)
    with tempfile.TemporaryDirectory(prefix="bwkm_service_") as tmp:
        d1, d2 = f"{tmp}/run1", f"{tmp}/run2"
        # 1. the uninterrupted run, checkpointing every 10 batches
        probe = _BatchProbe(torch, BWKMSession, {
            "route": (part_mod, "route_into_boxes"), "block_stats": (part_mod, "block_stats"),
            "lloyd": (lloyd, "weighted_lloyd"),
        })
        session = BWKMSession(cfg)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        t0 = time.perf_counter()
        with probe.active():
            metrics = run_service(session, src, checkpoint_dir=d1,
                                  checkpoint_every=SERVICE_CKPT_EVERY)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches = _read(counters)
        peak = torch.cuda.max_memory_allocated() - base_mem
        for b in total:
            total[b] += launches[b]
        check(len(metrics) == nb, f"{len(metrics)} batches consumed, not {nb}")
        walls = [w for w, _, _ in probe.batches]
        syncs = [s for _, s, _ in probe.batches]
        upd = range(1, nb)
        route = probe.span_ms("route", upd)
        bstats = probe.span_ms("block_stats", upd)
        lloyd_ms = probe.span_ms("lloyd", upd)
        step_ms = [1e3 * walls[i] for i in upd]
        refits = [i for i, m in enumerate(metrics) if m["refit"] and i > 0]
        after = [i for i in refits if i >= drift_batch]
        splits = sum(m["n_splits"] for m in metrics[1:])
        st = session.state
        print(f"[service] run 1 (uninterrupted, checkpoint every {SERVICE_CKPT_EVERY}): wall_s={wall1:.3f} "
              f"bootstrap_ms={1e3 * walls[0]:.1f} ({metrics[0]['n_blocks']} blocks) per-batch ms "
              f"median {_pct(step_ms, 50):.2f} p95 {_pct(step_ms, 95):.2f} (max {max(step_ms):.2f}); "
              f"peak_mem_MiB={peak / 2**20:.1f} above the resident data ({base_mem / 2**20:.1f} MiB); "
              f"refits={len(refits)} ({len(after)} from batch {drift_batch} on) splits={splits} "
              f"final n_blocks={metrics[-1]['n_blocks']} of {st.partition.capacity}; launches={launches}")
        print(f"[service] run 1 per update batch, CUDA-event spans (median, and share of the sum of "
              f"the batch walls): route_into_boxes {_pct(route, 50):.2f} ms "
              f"({100 * sum(route) / sum(step_ms):.1f} %), block_stats {_pct(bstats, 50):.2f} ms "
              f"({100 * sum(bstats) / sum(step_ms):.1f} %), weighted_lloyd (tracking and any refit) "
              f"{_pct(lloyd_ms, 50):.2f} ms ({100 * sum(lloyd_ms) / sum(step_ms):.1f} %); "
              f"synchronizing CUDA calls per update batch median {_pct(syncs[1:], 50):.0f} "
              f"(min {min(syncs[1:])}, max {max(syncs[1:])}), bootstrap {syncs[0]}")
        print(f"[service] run 1 metrics per batch (refit, n_splits, n_blocks, boundary_frac): "
              + " ".join(f"{i}:{int(m['refit'])},{m['n_splits']},{m['n_blocks']},{m['boundary_frac']:.4f}"
                         for i, m in enumerate(metrics)))
        check(len(after) > 0, "no refit after the drift")
        for b in ("B1", "B2", "B3"):
            check(launches[b] > 0, f"service run: kernel {b} was not launched")
        c = st.centroids
        check(tuple(c.shape) == (SUSY_K, d) and bool(torch.isfinite(c).all()),
              "service centroids not finite [27, 19]")
        check(int(st.batches) == nb and float(st.points) == float(n),
              f"state counters batches={int(st.batches)} points={float(st.points)}")
        xd = torch.from_numpy(stream).cuda()
        score = repro_torch.BWKM.from_centroids(c.cpu().numpy()).score(xd)
        ref_score = _score_f64(torch, xd, c)
        check(abs(score - ref_score) <= 1e-4 * abs(ref_score),
              f"service score {score} vs float64 {ref_score}")
        print(f"[service] score of the final centroids over all {n:,} rows {score!r} "
              f"(vs float64 {(score - ref_score) / ref_score:+.3e})")
        del xd
        # 2. crash at batch 40, resume from the newest checkpoint
        crashed = BWKMSession(cfg)
        t0 = time.perf_counter()
        try:
            run_service(crashed, CrashingSource(src, SERVICE_CRASH_AT), checkpoint_dir=d2,
                        checkpoint_every=SERVICE_CKPT_EVERY)
        except InjectedCrash:
            pass
        else:
            check(False, "the crashing source did not crash")
        t_crash = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed, metrics2 = resume_service(d2, src, checkpoint_every=SERVICE_CKPT_EVERY)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
        cursor = nb - len(metrics2)
        check(cursor == SERVICE_CRASH_AT, f"resumed at cursor {cursor}, not {SERVICE_CRASH_AT}")
        check(metrics2 == metrics[cursor:], "resumed batches' metrics differ from run 1's")
        bad = _state_bit_equal(torch, st, resumed.state)
        check(not bad, f"resumed state differs from run 1's in {bad}")
        print(f"[service] run 2: crashed reading batch {SERVICE_CRASH_AT} after {t_crash:.3f} s, "
              f"resumed from cursor {cursor} and ran {len(metrics2)} batches in {t_resume:.3f} s: "
              f"the final state (every tensor, the key, batches, points) bit-equal to run 1's, the "
              f"metrics of all {len(metrics2)} batches equal")
        # 3. a flipped byte in the newest checkpoint is refused by name
        newest = sorted(pathlib.Path(d1).glob("step_*"))[-1] / "state.npz"
        data = dict(np.load(newest))
        victim = "session§centroids"
        data[victim] = data[victim].copy()
        data[victim].reshape(-1).view(np.uint8)[7] ^= 0x04
        np.savez(newest, **data)
        try:
            load_session(d1)
        except CheckpointCorruptionError as e:
            check(f"'{victim}'" in str(e), f"the corruption error does not name {victim}: {e}")
            print(f"[service] one byte of {victim} flipped in {newest.parent.name}: load_session "
                  f"raised CheckpointCorruptionError naming it")
        else:
            check(False, "load_session accepted a corrupted checkpoint")
    # 4. serving: 8 threads of ragged predict requests, one flush
    import threading

    rng = np.random.default_rng(0)
    sizes = []
    while sum(sizes) < SERVICE_SERVE_ROWS:
        sizes.append(min(int(rng.integers(1, 5001)), SERVICE_SERVE_ROWS - sum(sizes)))
    starts = rng.integers(0, n - 5000, len(sizes))
    reqs = [stream[a : a + s] for a, s in zip(starts, sizes)]
    t_sizes = [int(v) for v in rng.integers(1, 5001, 8)]
    t_reqs = [stream[a : a + s] for a, s in zip(rng.integers(0, n - 5000, 8), t_sizes)]
    predictor = BatchedPredictor(c)
    tickets = [None] * len(reqs)

    def submit(j):
        for i in range(j, len(reqs), 8):
            tickets[i] = predictor.submit(reqs[i])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submit, args=(j,)) for j in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    check(not any(t.is_alive() for t in threads), "a submitting thread did not finish")
    t_tickets = [predictor.submit(r, kind="transform") for r in t_reqs]
    t_submit = time.perf_counter() - t0
    _zero(counters)
    t0 = time.perf_counter()
    served = predictor.flush()
    t_flush = time.perf_counter() - t0
    launches = _read(counters)
    total["B1"] += launches["B1"]
    cs = predictor.chunk_size
    want_calls = -(-SERVICE_SERVE_ROWS // cs) + -(-sum(t_sizes) // cs)
    check(served == len(reqs) + len(t_reqs), f"flush served {served} requests")
    check(predictor.stats["n_kernel_calls"] == want_calls,
          f"{predictor.stats['n_kernel_calls']} chunk calls, not {want_calls}")
    check(launches["B1"] == -(-SERVICE_SERVE_ROWS // cs), f"serving launches {launches}")
    for r, t in zip(reqs, tickets):
        got = t.result(timeout=0)
        want = ops.assign_top2(torch.from_numpy(r).cuda(), c)[0].cpu().numpy()
        check(got.dtype == np.int32 and np.array_equal(got, want),
              f"a served request's labels differ from assign_top2 over its {r.shape[0]} rows")
    rows = torch.from_numpy(np.concatenate(t_reqs)).cuda()
    want = torch.cat([ops.pairwise_sqdist_chunk(rows[i : i + cs], c, chunk_size=cs)
                      for i in range(0, rows.shape[0], cs)]).cpu().numpy()
    got = np.concatenate([t.result(timeout=0) for t in t_tickets])
    check(np.array_equal(got, want), "served transforms differ from pairwise_sqdist_chunk")
    print(f"[service] BatchedPredictor: {len(reqs)} predict requests of 1–5,000 rows "
          f"({SERVICE_SERVE_ROWS:,} rows) from 8 threads and {len(t_reqs)} transform requests "
          f"({sum(t_sizes):,} rows), submitted in {t_submit:.3f} s, one flush of {t_flush:.3f} s "
          f"({SERVICE_SERVE_ROWS / t_flush:,.0f} predict rows/s with the transforms in it); "
          f"{predictor.stats['n_kernel_calls']} chunk calls of {cs} rows, B1 launches "
          f"{launches['B1']}; every request's labels bit-equal to assign_top2, transforms equal "
          f"to pairwise_sqdist_chunk")
    # 5. the card against the CPU: 8 batches of 4,096 rows, draws on the CPU.
    # The bootstrap is the in-core fit, which splits on near-ties of the
    # kernels' and the plain distances at K = 27 on this data, so the two
    # free-running sessions part after it; each update is therefore taken on
    # both devices from the card's state before it, where the decisions must
    # be the same.
    small = [stream[i * SERVICE_SMALL_ROWS : (i + 1) * SERVICE_SMALL_ROWS] for i in range(8)]
    with _patched(smod, "_session_key", lambda seed: _CpuDrawKey(rnd.key(seed))):
        card, cpu = BWKMSession(cfg), BWKMSession(cfg, device="cpu")
        t0 = time.perf_counter()
        boot = (card.partial_fit(small[0]), cpu.partial_fit(small[0]))
        t_boot = time.perf_counter() - t0
        rel = [abs(boot[0]["error"] - boot[1]["error"]) / abs(boot[1]["error"])]
        check(rel[0] <= 1e-3, f"bootstrap error on the card {boot[0]} vs CPU {boot[1]}")
        pairs = []
        for b in small[1:]:
            cpu.state = _state_to(card.state, "cpu")
            pairs.append((card.partial_fit(b), cpu.partial_fit(b)))
    for i, (g, p) in enumerate(pairs, 1):
        same = (g["refit"], g["n_splits"], g["n_blocks"]) == (p["refit"], p["n_splits"], p["n_blocks"])
        check(same, f"batch {i}: card {g} and CPU {p} differ in refit/n_splits/n_blocks")
        rel.append(abs(g["error"] - p["error"]) / abs(p["error"]))
        check(rel[-1] <= 1e-3, f"batch {i}: error on the card {g['error']} vs CPU {p['error']}")
    print(f"[service] card against CPU, 8 batches of {SERVICE_SMALL_ROWS:,} rows with the draws on the "
          f"CPU: bootstrap n_blocks {boot[0]['n_blocks']} on the card, {boot[1]['n_blocks']} on the "
          f"CPU ({t_boot:.2f} s for both); each update from the card's state: refit, n_splits, "
          f"n_blocks equal in all {len(pairs)} (n_splits {[g['n_splits'] for g, _ in pairs]}); "
          f"error within {max(rel):.2e} (bootstrap {rel[0]:.2e})")
    # 6. the estimator: partial_fit is the session
    model = repro_torch.BWKM(k=SUSY_K)
    plain = BWKMSession(ServiceConfig(base=BWKMConfig(k=SUSY_K)))
    ms = []
    for i in range(5):
        b = src.chunk_at(i)
        model.partial_fit(b)
        plain.partial_fit(b)
        ms.append(model.session_.last_metrics)
    check(model.engine_ == "service" and model.n_iter_ == 5, f"estimator {model!r} n_iter_ {model.n_iter_}")
    check(torch.equal(model.centroids_, plain.centroids),
          "BWKM.partial_fit centroids differ from the session's")
    print(f"[service] BWKM(k={SUSY_K}).partial_fit over 5 batches (the default configuration): "
          f"centroids bit-equal to a BWKMSession with the same config; n_blocks "
          f"{[m['n_blocks'] for m in ms]}, refits after the bootstrap "
          f"{sum(m['refit'] for m in ms[1:])}; phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------- phase 5
def _time_graph(torch, fn, reps=20):
    """Milliseconds per call of ``fn`` replayed from a CUDA graph (so the
    host's launch cost is not measured), after warm-up."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _clock_under_load(torch, what, fn, seconds=2.0):
    """Print the SM clock and power draw that ``nvidia-smi`` reads every
    50 ms while ``fn`` runs back to back for about ``seconds``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = sorted((float(a), float(b)) for a, b in
                  (line.split(",") for line in out.splitlines() if line.count(",") == 1))
    check(len(rows) >= 5, f"nvidia-smi gave {len(rows)} samples under load")
    mhz = [r[0] for r in rows]
    watts = sorted(r[1] for r in rows)
    print(f"[clock] {what} back to back for {seconds:.0f} s: SM clock median {mhz[len(mhz) // 2]:.0f} "
          f"MHz (min {mhz[0]:.0f}, max {mhz[-1]:.0f}), power draw median "
          f"{watts[len(watts) // 2]:.1f} W over {len(rows)} samples")


class _Parent:
    """An earlier commit's kernel libraries, built from its sources with the
    same flags. The C interface must be the same (the ``_ex`` entry points
    that take a launch plan), so while :meth:`active` the port's wrappers
    launch the parent's kernels."""

    def __init__(self, build, procs):
        self.build, self.procs, self.libs = build, procs, None

    @classmethod
    def start(cls, build, tree):
        csrc = pathlib.Path(tree).resolve() / "src" / "repro_torch" / "kernels" / "csrc"
        check(csrc.is_dir(), f"--parent: {csrc} not found")
        out = ROOT / "build" / "parent-kernels"
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, src in build.SOURCES.items():
            lib = out / f"lib{name}.so"
            procs[name] = (lib, subprocess.Popen(
                [build._nvcc(), *build._NVCC_FLAGS, "-o", str(lib), str(csrc / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        return cls(build, procs)

    def finish(self):
        import ctypes

        self.libs = {}
        for name, (lib, proc) in self.procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"the parent's {name} did not build:\n{log}")
            self.libs[name] = ctypes.CDLL(str(lib))

    @contextlib.contextmanager
    def active(self):
        saved = dict(self.build._loaded)
        self.build._loaded.update(self.libs)
        try:
            yield
        finally:
            self.build._loaded.clear()
            self.build._loaded.update(saved)


def _timed(torch, fn, reps, parent):
    """``fn``'s milliseconds from ``_time_graph``; given the parent's
    libraries, in turns with them (parent, this, this, parent) on the same
    inputs."""
    if parent is None:
        return {"ms": _time_graph(torch, fn, reps)}
    with parent.active():
        p1 = _time_graph(torch, fn, reps)
    c1, c2 = _time_graph(torch, fn, reps), _time_graph(torch, fn, reps)
    with parent.active():
        p2 = _time_graph(torch, fn, reps)
    return {"ms": c1, "ms_again": c2, "parent_ms": (p1, p2)}


def _b5_row(torch, ref, msu, args, what, parent, reps=10, plain_reps=10):
    """A B5 record on one fold's own inputs ``(x, w, cand, cvalid, mind2)``.
    Its bound counts the valid candidates' operations."""
    from repro_torch.roofline import analysis

    fx, fw, fc, fv, fm = args
    n, d = fx.shape
    l, n_valid = fc.shape[0], int(fv.sum())

    def lib():
        dd = torch.cdist(fx, fc) ** 2
        new = torch.minimum(fm, dd.masked_fill(fv[None, :] == 0, BIG).amin(1))
        return new, (fw * new).sum()

    return dict(
        shape=f"{what}x[{n},{d}] f32, L={l}, {n_valid} valid",
        **_timed(torch, lambda: msu.min_sqdist_update_cuda(fx, fw, fc, fv, fm), reps, parent),
        plain_ms=_time_graph(torch, lambda: ref.min_sqdist_update(fx, fw, fc, fv, fm),
                             reps=plain_reps),
        library_ms=_time_graph(torch, lib, reps=plain_reps),
        bound=analysis.min_sqdist_bound(n, d, l, n_valid),
    )


def _ms_s(r):
    """``_timed``'s record as text: this commit's times, then the parent's."""
    if "parent_ms" not in r:
        return f"{r['ms']:.4f} ms"
    return (f"{r['ms']:.4f} / {r['ms_again']:.4f} ms, parent {r['parent_ms'][0]:.4f} / "
            f"{r['parent_ms'][1]:.4f} ms")


def _parent_bits(torch, cu, fau, parent, x_full, c561, a2001):
    """This commit's statistics fold against the parent's, bit for bit, over
    every row: B4 at K = 2,001 (the K = 100 weighting pass's width) and B2 at
    the K = 27 weighting pass's 561 candidates (its sums, counts and err, and
    its ids and distances), with unit weights as the weighting passes have
    and with random weights in [0, 3), half of them zero."""
    n = x_full.shape[0]
    g = torch.Generator(device="cuda").manual_seed(17)
    u = torch.rand(n, generator=g, device="cuda")
    weights = {"unit": torch.ones(n, device="cuda"), "random": torch.where(u < 0.5, 0.0, 6 * u)}
    for name, w in weights.items():
        mine = cu.cluster_sums_cuda(x_full, w, a2001, 2001)
        with parent.active():
            theirs = cu.cluster_sums_cuda(x_full, w, a2001, 2001)
        check(all(torch.equal(u_, v_) for u_, v_ in zip(mine, theirs)),
              f"B4 at K = 2001 ({name} weights) differs from the parent's kernel")
        mine = fau.fused_assign_update_cuda(x_full, w, c561)
        with parent.active():
            theirs = fau.fused_assign_update_cuda(x_full, w, c561)
        check(all(torch.equal(u_, v_) for u_, v_ in zip(mine, theirs)),
              f"B2 at K = {c561.shape[0]} ({name} weights) differs from the parent's kernel")
        del mine, theirs
    print(f"[parent] B4 at K = 2001 and B2 at K = {c561.shape[0]} over all {n} rows, with unit "
          "and with random weights: sums, counts, err (and B2's ids, d1, d2) bit-equal to the "
          "parent's kernels")


def _wide_times(torch, ref, da, fau, cu, msu):
    """Each kernel at the wide rows of phase 2 beside its plain version, a
    library call computing the same function (``cdist`` with ``topk``,
    ``index_add_`` or a masked ``amin``) and its bound."""
    from repro_torch.roofline import analysis

    for i, d in enumerate(WIDE_D):
        x, w, c, ids = _wide_case(torch, d, seed=400 + i)
        n, k = x.shape[0], c.shape[0]
        cv = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0], device="cuda")
        m0 = torch.full((n,), BIG, device="cuda")

        def lib_sums(a, k, rows=x, w=w):
            sums = torch.zeros(k, d, device="cuda").index_add_(0, a, rows * w[:, None])
            return sums, torch.zeros(k, device="cuda").index_add_(0, a, w)

        def lib_b5():
            new = torch.minimum(m0, (torch.cdist(x, c) ** 2).masked_fill(cv[None, :] == 0, BIG)
                                .amin(1))
            return new, (w * new).sum()

        rows = [("B1", lambda: da.assign_top2_cuda(x, c), lambda: ref.assign_top2(x, c),
                 lambda: torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False),
                 analysis.assign_top2_bound(n, d, k)),
                ("B4", lambda: cu.cluster_sums_cuda(x, w, ids, k),
                 lambda: ref.cluster_sums(x, w, ids, k), lambda: lib_sums(ids.long(), k),
                 analysis.cluster_sums_bound(n, d, k)),
                ("B5", lambda: msu.min_sqdist_update_cuda(x, w, c, cv, m0),
                 lambda: ref.min_sqdist_update(x, w, c, cv, m0), lib_b5,
                 analysis.min_sqdist_bound(n, d, k, int(cv.sum())))]
        if fau.fused_supported(d, 1):
            c1 = c[:1].contiguous()
            act = torch.arange(n, device="cuda") % 2 == 0
            zero = torch.zeros(n, dtype=torch.long, device="cuda")

            def lib_b2():
                dist = torch.cdist(x, c1)[:, 0] ** 2
                return (*lib_sums(zero, 1), (w * dist).sum())

            rows += [("B2 (K=1)", lambda: fau.fused_assign_update_cuda(x, w, c1),
                      lambda: ref.assign_update(x, w, c1), lib_b2,
                      analysis.assign_update_bound(n, d, 1)),
                     ("B3 (K=1, half active)",
                      lambda: fau.fused_assign_update_pruned_cuda(x, w, c1, ids * 0, act),
                      lambda: ref.assign_update_pruned(x, w, c1, ids * 0, act), lib_b2,
                      analysis.assign_update_pruned_bound(n, d, 1, int(act.sum())))]
        print(f"[time] wide rows x[{n},{d}] f32, K = {k}: " + "; ".join(
            f"{name} kernel {_time_graph(torch, kern, reps=3):.4f} ms, plain "
            f"{_time_graph(torch, plain, reps=3):.4f} ms, library "
            f"{_time_graph(torch, lib, reps=3):.4f} ms, bound {bound.ms:.6f} ms ({bound.by})"
            for name, kern, plain, lib, bound in rows))


def phase_times(torch, ref, da, fau, cu, msu, x_full, path, rep_folds, parent):
    """Each kernel at the shape that carries most of its launches (the
    records of the JSON line), then B1, B2 and B5 at the k-means|| path's
    own inputs from phase 4 (``path``: K -> weighting candidates, last
    fold, seed fold) and B5 at the folds over the representatives of the
    seeded fit (``rep_folds``). Where a plain version or a library call does
    not fit at full n (an [n, K] matrix), it is timed on the first 65,536
    rows beside the kernel on the same rows. Given ``parent``, every row but
    B4's times the parent's kernel too, in turns. The bounds come from
    ``repro_torch.roofline.analysis``."""
    from repro_torch.roofline import analysis

    d, k = 19, SUSY_K
    out = {}
    # B1 at the predict/score chunk, the shape that carries most of its launches
    x, w, c = _data(torch, CHUNK, d, k, torch.float32, seed=11)
    n = CHUNK
    lib = lambda: torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False)  # noqa: E731
    out["B1"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32",
        **_timed(torch, lambda: da.assign_top2_cuda(x, c), 20, parent),
        plain_ms=_time_graph(torch, lambda: ref.assign_top2(x, c)),
        library_ms=_time_graph(torch, lib),
        bound=analysis.assign_top2_bound(n, d, k),
    )
    # B2/B3 at the partition's representatives
    n = CAPACITY_REPS
    x, w, c = _data(torch, n, d, k, torch.float32, seed=12)

    def lib2():
        dist, idx = torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False)
        a = idx[:, 0]
        sums = torch.zeros(k, d, device="cuda").index_add_(0, a, x * w[:, None])
        counts = torch.zeros(k, device="cuda").index_add_(0, a, w)
        return sums, counts, (w * dist[:, 0]).sum()

    out["B2"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32",
        **_timed(torch, lambda: fau.fused_assign_update_cuda(x, w, c), 20, parent),
        plain_ms=_time_graph(torch, lambda: ref.assign_update(x, w, c)),
        library_ms=_time_graph(torch, lib2),
        bound=analysis.assign_update_bound(n, d, k),
    )
    g = torch.Generator(device="cuda").manual_seed(13)
    cached = fau.fused_assign_update_cuda(x, w, c)[0]
    act = torch.rand(n, generator=g, device="cuda") < 0.1
    n_act = int(act.sum())

    def lib3():
        dist, idx = torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False)
        a = torch.where(act, idx[:, 0], cached.long())
        sums = torch.zeros(k, d, device="cuda").index_add_(0, a, x * w[:, None])
        counts = torch.zeros(k, device="cuda").index_add_(0, a, w)
        return sums, counts, torch.where(act, w * dist[:, 0], 0.0).sum()

    out["B3"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32, {n_act} rows active",
        **_timed(torch, lambda: fau.fused_assign_update_pruned_cuda(x, w, c, cached, act), 20,
                 parent),
        plain_ms=_time_graph(torch, lambda: ref.assign_update_pruned(x, w, c, cached, act)),
        library_ms=_time_graph(torch, lib3),
        bound=analysis.assign_update_pruned_bound(n, d, k, n_act),
    )
    # B4 at the K = 100 weighting pass: every row, 2,001 candidates; its plain
    # version (a dense [n, K] one-hot) is timed on the first 65,536 rows
    n, k = x_full.shape[0], 2001
    ones = torch.ones(n, device="cuda")
    a = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
    a_long = a.long()

    def lib4():
        sums = torch.zeros(k, d, device="cuda").index_add_(0, a_long, x_full)
        return sums, torch.zeros(k, device="cuda").index_add_(0, a_long, ones)

    out["B4"] = dict(
        shape=f"x[{n},{d}] f32, K={k} (plain on the first {CHUNK} rows)",
        **_timed(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a, k), 10, parent),
        plain_ms=_time_graph(torch, lambda: ref.cluster_sums(
            x_full[:CHUNK], ones[:CHUNK], a[:CHUNK], k), reps=10),
        library_ms=_time_graph(torch, lib4, reps=10),
        bound=analysis.cluster_sums_bound(n, d, k),
    )
    fold_ms = _time_graph(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a, k, _phases=1),
                          reps=10)
    reduce_ms = _time_graph(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a, k, _phases=2),
                            reps=10)
    print(f"[time] B4 x[{n},{d}] K={k}: the fold {fold_ms:.4f} ms, the reduction of its "
          f"{cu.fold_ctas(n)} partials {reduce_ms:.4f} ms (each launched alone); on the same "
          f"{CHUNK} rows as its plain version: kernel "
          f"{_time_graph(torch, lambda: cu.cluster_sums_cuda(x_full[:CHUNK], ones[:CHUNK], a[:CHUNK], k)):.4f} ms")
    # B5 at a k-means|| round over every row: 112 candidates, all valid
    l = 112
    cand = x_full[torch.randint(0, n, (l,), generator=g, device="cuda")]
    cv = torch.ones(l, device="cuda")
    mind2 = msu.min_sqdist_update_cuda(x_full, ones, x_full[:1], cv[:1],
                                       torch.full((n,), BIG, device="cuda"))[0]
    out["B5"] = _b5_row(torch, ref, msu, (x_full, ones, cand, cv, mind2), "", parent)
    _clock_under_load(torch, "B5 at L = 112",
                      lambda: msu.min_sqdist_update_cuda(x_full, ones, cand, cv, mind2))
    xc, oc = x_full[:CHUNK], ones[:CHUNK]
    # B1 over the K = 100 weighting pass's 2,001 candidates (half parked)
    c = path[100][0]
    k = c.shape[0]
    out["B1@2001"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32 (plain, library and 'kernel on the chunk' on "
              f"the first {CHUNK} rows)",
        **_timed(torch, lambda: da.assign_top2_cuda(x_full, c), 2, parent),
        chunk_ms=_time_graph(torch, lambda: da.assign_top2_cuda(xc, c), reps=5),
        plain_ms=_time_graph(torch, lambda: ref.assign_top2(xc, c), reps=5),
        library_ms=_time_graph(
            torch, lambda: torch.topk(torch.cdist(xc, c) ** 2, 2, dim=1, largest=False), reps=5),
        bound=analysis.assign_top2_bound(n, d, k),
    )
    _clock_under_load(torch, "B1@2001", lambda: da.assign_top2_cuda(x_full, c))
    # B2 over the K = 27 weighting pass's 561 candidates, unit weights

    def lib_b2(xx, ww, cc):
        kk = cc.shape[0]
        dist, idx = torch.topk(torch.cdist(xx, cc) ** 2, 2, dim=1, largest=False)
        a = idx[:, 0]
        sums = torch.zeros(kk, d, device="cuda").index_add_(0, a, xx * ww[:, None])
        counts = torch.zeros(kk, device="cuda").index_add_(0, a, ww)
        return sums, counts, (ww * dist[:, 0]).sum()

    c = path[27][0]
    k = c.shape[0]
    out["B2@561"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32 (plain, library and 'kernel on the chunk' on "
              f"the first {CHUNK} rows)",
        **_timed(torch, lambda: fau.fused_assign_update_cuda(x_full, ones, c), 2, parent),
        chunk_ms=_time_graph(torch, lambda: fau.fused_assign_update_cuda(xc, oc, c), reps=5),
        plain_ms=_time_graph(torch, lambda: ref.assign_update(xc, oc, c), reps=5),
        library_ms=_time_graph(torch, lambda: lib_b2(xc, oc, c), reps=5),
        bound=analysis.assign_update_bound(n, d, k),
    )
    # the two-pass route at the same shape, B1 then B4 (what ops.assign_update
    # runs beyond the fused limit), and the fused pass's scratch there
    two = _timed(torch, lambda: cu.cluster_sums_cuda(
        x_full, ones, da.assign_top2_cuda(x_full, c)[0], k), 2, parent)
    a561 = da.assign_top2_cuda(x_full, c)[0]
    b1_ms = _time_graph(torch, lambda: da.assign_top2_cuda(x_full, c), reps=2)
    b4 = _timed(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a561, k), 5, parent)
    print(f"[time] two-pass route B1 + B4 at x[{n},{d}] c[{k},{d}] f32: {_ms_s(two)} "
          f"(B1 alone {b1_ms:.4f} ms, B4 alone under its ids {_ms_s(b4)}; B2 there "
          f"{out['B2@561']['ms']:.4f} ms)")
    if parent is not None:
        _parent_bits(torch, cu, fau, parent, x_full, c, a)
    scratch = 4 * fau.fused_scratch_floats(n, d, k)
    print(f"[scratch] B2 at x[{n},{d}] c[{k},{d}]: {scratch} bytes ({scratch / 1e6:.3f} MB) "
          f"of fold partials, min(128, ceil(n/256))·(K·(d+1)+1) floats")
    # B5 at the K = 100 run's last fold: 400 slots, some invalid, finite min-d²
    out["B5@400"] = _b5_row(torch, ref, msu, path[100][1], "K = 100's last fold: ", parent,
                            plain_reps=2)
    # B5's other eight launches on the path: the two seed folds (L = 1, every
    # row) and the six folds of the seeded fit over the representatives
    for kk in (27, 100):
        out[f"B5 seed K={kk}"] = _b5_row(torch, ref, msu, path[kk][2], f"K = {kk}'s seed fold: ",
                                         parent, plain_reps=2)
    for i, args in enumerate(rep_folds):
        out[f"B5 reps {i}"] = _b5_row(torch, ref, msu, args,
                                      f"BWKM(init='kmeans||') fold {i} over the representatives: ",
                                      parent, reps=20, plain_reps=20)
    _wide_times(torch, ref, da, fau, cu, msu)
    for name, r in out.items():
        lib_s = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        chunk_s = f" (on the chunk {r['chunk_ms']:.4f} ms)" if "chunk_ms" in r else ""
        again_s = f" / {r['ms_again']:.4f}" if "ms_again" in r else ""
        parent_s = (f", parent {r['parent_ms'][0]:.4f} / {r['parent_ms'][1]:.4f} ms"
                    if "parent_ms" in r else "")
        print(f"[time] {name} {r['shape']}: kernel {r['ms']:.4f}{again_s} ms{chunk_s}{parent_s}, "
              f"plain {r['plain_ms']:.4f} ms, library {lib_s} ms, bound {r['bound'].ms:.5f} ms "
              f"({r['bound'].by})")
    return out


# ---------------------------------------------------------------- phase 8
TRADEOFF_KS = (3, 9, 27)  # the paper's sweep
KMC2_CHAIN = 100  # bench_tradeoff's chain length
MB_ITERS = 150  # bench_tradeoff's mini-batch steps
MB_BATCHES = (100, 500, 1000)
TRADEOFF_METHODS = ("BWKM", "FKM", "KM++", "KM++_init", "KMC2", "MB100", "MB500", "MB1000", "RPKM")
#: the plain distance and statistics functions of kernels/ref.py, none of
#: which may run on the card in phase 8
PLAIN_FNS = ("assign_top2", "cluster_sums", "assign_update", "assign_update_pruned",
             "min_sqdist_update", "weighted_error")


def _tradeoff_methods(repro_torch, baselines, k, names):
    """bench_tradeoff's methods (``benchmarks/bench_tradeoff.py:48-57``):
    name -> fit(key, x) returning a ``FitResult``."""
    methods = {
        "BWKM": lambda key, x: repro_torch.BWKM(
            k=k, device=x.device, engine="incore", max_iters=20, trace=True).fit(
                x, key=key).result_,
        "FKM": lambda key, x: baselines.forgy_kmeans(key, x, k),
        "KM++": lambda key, x: baselines.kmeanspp_kmeans(key, x, k),
        "KM++_init": lambda key, x: baselines.kmeanspp_kmeans(key, x, k, init_only=True),
        "KMC2": lambda key, x: baselines.kmc2_kmeans(key, x, k, chain_length=KMC2_CHAIN),
        **{f"MB{b}": (lambda key, x, b=b: baselines.minibatch_kmeans(
            key, x, k, batch=b, iters=MB_ITERS)) for b in MB_BATCHES},
        "RPKM": lambda key, x: baselines.grid_rpkm(key, x, k),
    }
    return {m: methods[m] for m in names}


def _expected_distances(method, res, n, k):
    """The reference's accounting of a baseline's distances (None for BWKM)."""
    dense = (res.iterations + 1) * n * k
    if method == "FKM":
        return dense
    if method == "KM++":
        return n * k + dense
    if method == "KM++_init":
        return n * k
    if method == "KMC2":
        return n + (k - 1) * KMC2_CHAIN * k + dense
    if method.startswith("MB"):
        return int(method[2:]) * k * MB_ITERS
    if method == "RPKM":
        return sum(m * k * (it + 1) for m, it in
                   zip(res.metadata["cells"], res.metadata["lloyd_iters"]))
    return None


class _ShapeTally:
    """Launches of B1, B2, B4 (and B5, given ``msu``) by shape while
    :meth:`active`: each wrapper is replaced by one that counts
    ``(kernel, rows, K)`` (B5: K is its candidate slots) and calls it. A
    wrapper counts its launches on the module's name for it, so the
    stand-in carries the count meanwhile and hands it back."""

    def __init__(self, da, fau, cu, msu=None):
        self.mods = ((da, "assign_top2_cuda", "B1"), (fau, "fused_assign_update_cuda", "B2"),
                     (cu, "cluster_sums_cuda", "B4"))
        if msu is not None:
            self.mods += ((msu, "min_sqdist_update_cuda", "B5"),)
        self.counts: dict[tuple, int] = {}

    @contextlib.contextmanager
    def active(self):
        with contextlib.ExitStack() as stack:
            for mod, attr, b in self.mods:
                fn = getattr(mod, attr)

                def counted(*a, _fn=fn, _b=b, **kw):
                    k = a[-1] if _b == "B4" else a[2 if _b == "B5" else -1].shape[0]
                    key = (_b, a[0].shape[0], int(k))
                    self.counts[key] = self.counts.get(key, 0) + 1
                    return _fn(*a, **kw)

                counted.launches = fn.launches
                stack.callback(lambda fn=fn, c=counted: setattr(fn, "launches", c.launches))
                stack.enter_context(_patched(mod, attr, counted))
            yield self


@contextlib.contextmanager
def _plain_calls(ref):
    """While active, count the calls of :data:`PLAIN_FNS` of ``ref``; yields
    the dict of counts."""
    calls = {f: 0 for f in PLAIN_FNS}
    with contextlib.ExitStack() as stack:
        for name in PLAIN_FNS:
            fn = getattr(ref, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] += 1
                return _fn(*a, **kw)

            stack.enter_context(_patched(ref, name, counted))
        yield calls


def _sync_calls(torch, fn) -> int:
    """The synchronizing CUDA calls that ``torch.cuda.set_sync_debug_mode``
    reports while ``fn`` runs."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def _rows_present(torch, x, rows, chunk=CHUNK):
    """Whether each of ``rows`` equals some row of ``x`` exactly."""
    found = torch.zeros(rows.shape[0], dtype=torch.bool, device=x.device)
    for i in range(0, x.shape[0], chunk):
        found |= (x[i : i + chunk, None, :] == rows[None]).all(-1).any(0)
    return bool(found.all())


def _run_tradeoff(torch, rnd, metrics, methods, x, k, ds, smi):
    """Run ``methods`` on ``x`` with ``rnd.key(k)``; check (a) and (b) and
    print a line per method and BWKM's curve. Returns name -> FitResult."""
    n = x.shape[0]
    results, errors, walls = {}, {}, {}
    for name, fit in methods.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(rnd.key(k), x)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        c = res.centroids
        check(tuple(c.shape) == (k, x.shape[1]) and c.is_cuda and bool(torch.isfinite(c).all()),
              f"{ds} K={k} {name}: centroids not finite [{k}, {x.shape[1]}] on the card")
        err = float(metrics.kmeans_error(x, c))
        want = _score_f64(torch, x, c)
        check(abs(err - want) <= 1e-4 * abs(want),
              f"(a) {ds} K={k} {name}: kmeans_error {err!r} vs float64 {want!r}")
        expected = _expected_distances(name, res, n, k)
        if expected is not None:
            check(abs(res.distances - expected) <= 1e-5 * expected,
                  f"(b) {ds} K={k} {name}: distances {res.distances!r} vs formula {expected}")
        results[name], errors[name] = res, err
    rel = metrics.relative_errors(errors)
    for name, res in results.items():
        extra = ""
        if name.startswith("MB"):
            extra = f" ms_per_step={walls[name] / MB_ITERS * 1e3:.4f}"
        if name == "RPKM":
            extra = (f" cells_per_level={res.metadata['cells']} "
                     f"lloyd_iters_per_level={res.metadata['lloyd_iters']}")
        print(f"[tradeoff] {ds} n={n} K={k} {name}: distances={res.distances!r} "
              f"error={errors[name]!r} rel_error={rel[name]!r} wall_s={walls[name]!r} "
              f"stop={res.stop_reason} iterations={res.iterations}{extra} | {smi}")
    bwkm = results.get("BWKM")
    if bwkm is not None:
        curve = [(t["distances"], float(metrics.kmeans_error(
            x, torch.from_numpy(t["centroids"]).to(x.device)))) for t in bwkm.trace]
        print(f"[tradeoff] {ds} K={k} BWKM curve (distances, error) per iteration: "
              + ", ".join(f"({dd!r}, {e!r})" for dd, e in curve) + f" | {smi}")
    return results


def _tradeoff_times(torch, ref, da, fau, cu, x, k, mb_c, rpkm, tally):
    """B1 and B4 at mini-batch K-means' batches and B2 at grid-RPKM's
    level-1 cells, beside the plain version, the library call and the
    bound, with the phase's launches at each shape."""
    from repro_torch.core import baselines
    from repro_torch.roofline import analysis

    d = x.shape[1]
    g = torch.Generator(device="cuda").manual_seed(81)
    rows = []
    for b in MB_BATCHES:
        xb = x[torch.randint(0, x.shape[0], (b,), generator=g, device="cuda")]
        c = mb_c[b]
        a = da.assign_top2_cuda(xb, c)[0]
        ones = torch.ones(b, device="cuda")
        a_long = a.long()

        def lib4(xb=xb, a_long=a_long, ones=ones):
            sums = torch.zeros(k, d, device="cuda").index_add_(0, a_long, xb)
            return sums, torch.zeros(k, device="cuda").index_add_(0, a_long, ones)

        rows.append((f"B1 MB{b}", f"x[{b},{d}] c[{k},{d}] f32", tally.get(("B1", b, k), 0),
                     _time_graph(torch, lambda xb=xb, c=c: da.assign_top2_cuda(xb, c)),
                     _time_graph(torch, lambda xb=xb, c=c: ref.assign_top2(xb, c)),
                     _time_graph(torch, lambda xb=xb, c=c: torch.topk(
                         torch.cdist(xb, c) ** 2, 2, dim=1, largest=False)),
                     analysis.assign_top2_bound(b, d, k)))
        rows.append((f"B4 MB{b}", f"x[{b},{d}] f32, K={k}", tally.get(("B4", b, k), 0),
                     _time_graph(torch, lambda xb=xb, a=a, ones=ones: cu.cluster_sums_cuda(
                         xb, ones, a, k)),
                     _time_graph(torch, lambda xb=xb, a=a, ones=ones: ref.cluster_sums(
                         xb, ones, a, k)),
                     _time_graph(torch, lib4),
                     analysis.cluster_sums_bound(b, d, k)))
    lo, hi = x.min(0).values, x.max(0).values
    span = torch.where(hi > lo, hi - lo, 1.0)
    _, inverse, counts = baselines.grid_cells(x, lo, span, 1)
    reps, w = baselines.cell_means(x, inverse, counts), counts.float()
    m, c = reps.shape[0], rpkm

    def lib2():
        dist, idx = torch.topk(torch.cdist(reps, c) ** 2, 2, dim=1, largest=False)
        a = idx[:, 0]
        sums = torch.zeros(k, d, device="cuda").index_add_(0, a, reps * w[:, None])
        return sums, torch.zeros(k, device="cuda").index_add_(0, a, w), (w * dist[:, 0]).sum()

    rows.append(("B2 RPKM L1", f"x[{m},{d}] c[{k},{d}] f32, w = cell counts",
                 tally.get(("B2", m, k), 0),
                 _time_graph(torch, lambda: fau.fused_assign_update_cuda(reps, w, c)),
                 _time_graph(torch, lambda: ref.assign_update(reps, w, c)),
                 _time_graph(torch, lib2),
                 analysis.assign_update_bound(m, d, k)))
    for name, shape, launches, ms, plain, lib, bound in rows:
        print(f"[time] {name} {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms, bound {bound.ms:.6f} ms ({bound.by}), phase 8 launches at this "
              f"shape {launches}")


def phase_tradeoff(torch, repro_torch, rnd, ref, da, fau, cu, counters, x, smi):
    """Phase 8: the paper's trade-off at full scale, bench_tradeoff's
    methods on SUSY at K = 3, 9, 27 and FKM, KM++, KM++_init and KMC2 on
    WUY at K = 27, with checks (a)–(f). Returns the launches of its paths."""
    import numpy as np

    from repro_torch.core import baselines, metrics
    from repro_torch.data.synthetic import paper_dataset

    t_phase = time.perf_counter()
    n, d = x.shape
    tally = _ShapeTally(da, fau, cu)
    _zero(counters)
    with _plain_calls(ref) as plain, tally.active():
        susy = {k: _run_tradeoff(torch, rnd, metrics,
                                 _tradeoff_methods(repro_torch, baselines, k, TRADEOFF_METHODS),
                                 x, k,
                                 "SUSY", smi)
                for k in TRADEOFF_KS}
        # (d) run twice with the same key, bit-equal
        for name in ("KMC2", "MB1000", "RPKM"):
            again = _tradeoff_methods(repro_torch, baselines, 27, [name])[name](rnd.key(27), x)
            check(torch.equal(again.centroids, susy[27][name].centroids),
                  f"(d) SUSY K=27 {name}: a second run with the same key differs")
        t0 = time.perf_counter()
        xw_host = paper_dataset("WUY", seed=0)
        xw = torch.from_numpy(xw_host).cuda()
        del xw_host
        nw = xw.shape[0]
        print(f"[data] WUY profile {tuple(xw.shape)} made and moved to the card in "
              f"{time.perf_counter() - t0:.1f} s")
        wuy = _run_tradeoff(torch, rnd, metrics, _tradeoff_methods(
            repro_torch, baselines, 27, ["FKM", "KM++", "KM++_init", "KMC2"]), xw, 27, "WUY", smi)
        # (e) the draw past 2^24 categories at full scale
        big = 1 << 24
        draws = rnd.key(27).categorical(torch.zeros(nw, device="cuda"), shape=(1_000_000,))
        share = float((draws >= big).float().mean())
        want_share = (nw - big) / nw
        print(f"[tradeoff] C8: 1,000,000 draws over {nw:,} uniform logits: largest "
              f"{int(draws.max()):,}, smallest {int(draws.min()):,}, share >= 2^24 {share!r} "
              f"(expected {want_share!r})")
        check(int(draws.max()) >= big and int(draws.max()) < nw and int(draws.min()) >= 0,
              "(e) the draws over WUY's rows do not reach past 2^24 or leave the range")
        check(abs(share - want_share) <= 0.005, f"(e) share past 2^24 {share} vs {want_share}")
        check(_rows_present(torch, xw, wuy["KM++_init"].centroids),
              "(e) a KM++_init seed on WUY is not a row of WUY")
        syncs = {ds: _sync_calls(torch, lambda xx=xx: baselines.kmeanspp_kmeans(
            rnd.key(27), xx, 27, init_only=True)) for ds, xx in (("SUSY", x), ("WUY", xw))}
        print(f"[tradeoff] synchronizing CUDA calls in KM++_init at K = 27: {syncs} (SUSY's "
              f"{n:,} rows draw by torch.multinomial, WUY's {nw:,} by inverse CDF)")
        del xw, wuy
    launches = _read(counters)
    print(f"[tradeoff] phase 8 launches {launches}; plain-version calls {plain}")
    for b in ("B1", "B2", "B3", "B4"):
        check(launches[b] > 0, f"(f) kernel {b} was not launched in phase 8")
    check(not any(plain.values()), f"(f) plain versions ran on the card: {plain}")
    # (c) grid-RPKM's level-1 cells on the card against numpy's over all rows,
    # and the cells of the first three levels with their times on the card
    lo, hi = x.min(0).values, x.max(0).values
    span = torch.where(hi > lo, hi - lo, 1.0)
    levels = []
    for level in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cells, _, counts = baselines.grid_cells(x, lo, span, level)
        torch.cuda.synchronize()
        levels.append((cells.shape[0], time.perf_counter() - t0))
        if level == 1:
            cells1, counts1 = cells, counts
    xh = x.cpu().numpy()
    t0 = time.perf_counter()
    lo_h, hi_h = xh.min(axis=0), xh.max(axis=0)
    span_h = np.where(hi_h > lo_h, hi_h - lo_h, 1.0)
    q = np.minimum(((xh - lo_h) / span_h * 2).astype(np.int64), 1)
    want_cells, want_counts = np.unique(q, axis=0, return_counts=True)
    t_host = time.perf_counter() - t0
    check(np.array_equal(cells1.cpu().numpy(), want_cells)
          and np.array_equal(counts1.cpu().numpy(), want_counts),
          "(c) grid-RPKM's level-1 cells or counts differ from np.unique's")
    print(f"[tradeoff] RPKM's level-1 cells equal np.unique's over all {n:,} rows "
          f"({t_host:.3f} s on the host); cells and grid_cells seconds on the card per level: "
          + ", ".join(f"level {i + 1}: {m:,} in {t:.3f} s" for i, (m, t) in enumerate(levels))
          + "; RPKM stopped " + ", ".join(
              f"K={k}: {susy[k]['RPKM'].stop_reason} after level {susy[k]['RPKM'].iterations}"
              for k in TRADEOFF_KS))
    _tradeoff_times(torch, ref, da, fau, cu, x, 27,
                    {b: susy[27][f"MB{b}"].centroids for b in MB_BATCHES},
                    susy[27]["RPKM"].centroids, tally.counts)
    print(f"[tradeoff] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 9
DIST_WORLD = 4  # ranks of 9b and 9c, all on the one card
DIST_LLOYD_ITERS = 20
DIST_RANK_SECONDS = 480  # the parent's deadline for 9b's and 9c's ranks: a hang fails the phase
#: 9c(c)'s set: ``gmm_dataset(seed, n, d, modes)`` at the KV width the vq codebooks cluster
DIST_GMM = (0, 1_048_576, 128, 27)


def _kernel_counters():
    from repro_torch.kernels import cluster_update as cu
    from repro_torch.kernels import distance_assign as da
    from repro_torch.kernels import fused_assign_update as fau
    from repro_torch.kernels import min_sqdist_update as msu

    return {"B1": da.assign_top2_cuda, "B2": fau.fused_assign_update_cuda,
            "B3": fau.fused_assign_update_pruned_cuda, "B4": cu.cluster_sums_cuda,
            "B5": msu.min_sqdist_update_cuda}


class _DistRecorder:
    """Swaps ``engine.sharded``'s plane and k-means|| session for subclasses
    that keep every instance and each statistics round's memberships and
    result, and times the plane's routing of all rows into the sample's
    boxes and its statistics rounds (``spans``, seconds between two
    synchronizes), so the phase can read them after a run."""

    def __init__(self):
        from repro_torch.engine import sharded

        self.sharded, self.planes, self.sessions = sharded, [], []
        self.spans = {"route": 0.0, "stats": 0.0}

    def _timed(self, name, fn):
        import torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.spans[name] += time.perf_counter() - t0
            return out

        return run

    def __enter__(self):
        sharded, planes, sessions = self.sharded, self.planes, self.sessions
        self.saved_fns = sharded._route_into_boxes, sharded._recompute_stats_ok
        sharded._route_into_boxes = self._timed("route", sharded._route_into_boxes)
        sharded._recompute_stats_ok = self._timed("stats", sharded._recompute_stats_ok)

        class Plane(sharded.ShardedPlane):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.rounds = []
                planes.append(self)

            def _stats_round(self, part_in, bid_in, round_index):
                out = super()._stats_round(part_in, bid_in, round_index)
                self.rounds.append((bid_in, out))
                return out

        class Session(sharded.ShardedLLSession):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                sessions.append(self)

        self.saved = sharded.ShardedPlane, sharded.ShardedLLSession
        sharded.ShardedPlane, sharded.ShardedLLSession = Plane, Session
        return self

    def __exit__(self, *exc):
        self.sharded.ShardedPlane, self.sharded.ShardedLLSession = self.saved
        self.sharded._route_into_boxes, self.sharded._recompute_stats_ok = self.saved_fns


def _timed_path(torch, counters, fn):
    """``(result, wall seconds, launches)`` of ``fn()``, the counts set to 0
    just before and read just after."""
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _read(counters)


def _dist_lloyd_pair(torch, dist_bwkm, counters, x, c):
    """``dist_lloyd`` from ``c`` pruned and dense: ``({prune: result}, launches)``."""
    runs, launches = {}, dict.fromkeys(counters, 0)
    for prune in (True, False):
        runs[prune], wall, got = _timed_path(
            torch, counters,
            lambda: dist_bwkm.dist_lloyd(x, c, max_iters=DIST_LLOYD_ITERS, prune=prune))
        runs[prune] = (runs[prune], wall)
        for b in launches:
            launches[b] += got[b]
    return runs, launches


def _dist_9c(torch, counters, x, rank: int, world: int, paths, gmm_path: str) -> dict:
    """9c on one rank, after 9b's work in the same gloo group: the further
    meshes, built in turn and in the same order on every rank. (a) a
    ``("pod", "data", "model")`` (2, 2, 1) mesh on 9b's rows ``x`` (batch
    rank = rank); (b) a ``("data", "model")`` (2, 2) mesh on SUSY, batch
    rank ``rank // 2`` loading shards ``10·b`` to ``10·b + 9`` whole (d = 19
    is odd); (c) the same mesh on :data:`DIST_GMM`, each rank holding
    524,288 × 64 of it, then the same set on a ``("data",)`` (4,) mesh."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import random as rnd
    from repro_torch.core.bwkm import BWKMConfig
    from repro_torch.distributed import dist_bwkm, dist_kmeans_ll
    from repro_torch.distributed import sharding as sh

    cfg = BWKMConfig(k=SUSY_K)
    out = {"launches": dict.fromkeys(counters, 0)}

    def fit(xs, **kw):
        res, wall, launches = _timed_path(
            torch, counters, lambda: dist_bwkm.fit_distributed(rnd.key(0), xs, cfg, **kw))
        for b in launches:
            out["launches"][b] += launches[b]
        return res, (res.centroids.cpu(), res.stop_reason, res.iterations, res.n_blocks,
                     res.distances), wall, launches

    t0 = time.perf_counter()
    with sh.use_mesh(init_device_mesh("cuda", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))):
        out["a_shards"] = dist_bwkm.n_data_shards()
        _, out["a_fit"], out["a_s"], _ = fit(x)
        res, *_ = fit(x, shard_faults={1: [2]})
        out["a_fault"] = (res.health.as_dict(), bool(torch.isfinite(res.centroids).all()))
    per, b = len(paths) // 2, rank // 2
    xb = torch.from_numpy(np.concatenate([np.load(p) for p in paths[b * per:(b + 1) * per]]))
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    with sh.use_mesh(mesh):
        _, out["b_fit"], out["b_s"], _ = fit(xb.to(x.device))
    del xb
    data = np.load(gmm_path, mmap_mode="r")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_c = time.perf_counter()
    with sh.use_mesh(mesh):
        xs = dist_bwkm.shard_points(data, device=x.device)
        out["c_resident"] = (type(xs).__name__, tuple(xs.shape), xs.numel() * xs.element_size())
        before = {k: v["bytes"] for k, v in sh.COLLECTIVE_COUNTS.items()}
        res, out["c_fit"], out["c_s"], out["c_fit_launches"] = fit(xs)
        out["c_moved"] = {k: v["bytes"] - before[k] for k, v in sh.COLLECTIVE_COUNTS.items()}
        runs, launches = _dist_lloyd_pair(torch, dist_bwkm, counters, xs, res.centroids)
        for k in launches:
            out["launches"][k] += launches[k]
        out["c_lloyd"] = {p: (r.centroids.cpu(), r.iters, r.distances, wall)
                          for p, (r, wall) in runs.items()}
        out["c_ll"], out["c_ll_s"], out["c_ll_launches"] = _timed_path(
            torch, counters, lambda: dist_kmeans_ll.dist_kmeans_parallel(rnd.key(0), xs, SUSY_K).cpu())
        for k in launches:
            out["launches"][k] += out["c_ll_launches"][k]
        del xs
    with sh.use_mesh(init_device_mesh("cuda", (world,), mesh_dim_names=("data",))):
        xs = dist_bwkm.shard_points(data, device=x.device)
        out["c_rows_resident"] = xs.numel() * xs.element_size()
        _, out["c_rows_fit"], out["c_rows_s"], _ = fit(xs)
        del xs
    out["c_peak"] = torch.cuda.max_memory_allocated()
    out["c_wall_s"] = time.perf_counter() - t_c
    out["wall_s"] = time.perf_counter() - t0
    return out


def _dist_rank(rank: int, world: int, init: str, shard_dir: str, out_dir: str,
               gmm_path: str) -> None:
    """One rank of 9b and 9c: a gloo group on the one card, rank ``rank``
    loading shards ``5·rank`` to ``5·rank + 4`` (its contiguous 1,250,000
    rows) and running the distributed engine's paths on a ``("data",)``
    mesh (9b), then on the further meshes (:func:`_dist_9c`); what it saw
    goes to ``out_dir/rank<r>.pt``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import random as rnd
    from repro_torch.core.bwkm import BWKMConfig
    from repro_torch.distributed import dist_bwkm, dist_kmeans_ll
    from repro_torch.distributed import sharding as sh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _kernel_counters()
    paths = sorted(pathlib.Path(shard_dir).glob("*.npy"))
    per = len(paths) // world
    x = torch.from_numpy(np.concatenate([np.load(p) for p in paths[rank * per:(rank + 1) * per]]))
    x = x.cuda()
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    out = {"rank": rank, "rows": x.shape[0], "launches": dict.fromkeys(counters, 0)}

    def add(launches):
        for b in out["launches"]:
            out["launches"][b] += launches[b]

    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        cfg = BWKMConfig(k=SUSY_K)
        with sh.use_mesh(mesh):
            torch.cuda.reset_peak_memory_stats()
            res, out["fit_s"], launches = _timed_path(
                torch, counters, lambda: dist_bwkm.fit_distributed(rnd.key(0), x, cfg))
            add(launches)
            out["fit_launches"] = launches
            out["fit"] = (res.centroids.cpu(), res.stop_reason, res.iterations, res.n_blocks,
                          res.distances)
            runs, launches = _dist_lloyd_pair(torch, dist_bwkm, counters, x, res.centroids)
            add(launches)
            out["lloyd"] = {p: (r.centroids.cpu(), r.iters, r.distances, wall)
                            for p, (r, wall) in runs.items()}
            seeds, out["ll_s"], launches = _timed_path(torch, counters, lambda: [
                dist_kmeans_ll.dist_kmeans_parallel(rnd.key(0), x, SUSY_K).cpu()
                for _ in range(2)])
            add(launches)
            out["ll"] = seeds
            res, out["fault_s"], launches = _timed_path(torch, counters, lambda: dist_bwkm.fit_distributed(
                rnd.key(0), x, cfg, shard_faults={1: [2]}))
            add(launches)
            out["fault"] = (res.health.as_dict(), res.stop_reason,
                            bool(torch.isfinite(res.centroids).all()))
            try:
                dist_bwkm.fit_distributed(rnd.key(0), x, cfg, shard_faults={1: [2]},
                                          max_shard_loss_frac=0.2)
                out["abort"] = None
            except dist_bwkm.ShardLossError as e:
                out["abort"] = str(e)
            out["peak"] = torch.cuda.max_memory_allocated()
        out["wall_s"] = time.perf_counter() - t_start
        out["c"] = _dist_9c(torch, counters, x, rank, world, paths, gmm_path)
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn_ranks(torch, shard_dir: str, tmp: str, gmm_path: str) -> list[dict]:
    """9b's and 9c's four ranks, joined under :data:`DIST_RANK_SECONDS`: a
    hang or a rank's failure fails the phase, and every rank is stopped."""
    import torch.multiprocessing as mp

    out_dir = pathlib.Path(tmp) / "ranks"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _dist_rank,
        args=(DIST_WORLD, f"file://{tmp}/rendezvous_gloo", shard_dir, str(out_dir), gmm_path),
        nprocs=DIST_WORLD, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + DIST_RANK_SECONDS
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"9b/9c: the {DIST_WORLD} ranks did not finish in {DIST_RANK_SECONDS} s")
    except mp.ProcessRaisedException as e:
        raise SmokeFailure(f"9b/9c: a rank failed:\n{e}") from e
    except mp.ProcessExitedException as e:
        raise SmokeFailure(f"9b/9c: a rank exited: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DIST_WORLD)]


def _write_gmm(path: str) -> None:
    """9c(c)'s set (:data:`DIST_GMM`) to ``path`` as one ``.npy``."""
    import numpy as np

    from repro_torch.data.synthetic import gmm_dataset

    np.save(path, gmm_dataset(*DIST_GMM))


def _check_9c(torch, ranks, want, smi) -> None:
    """9c's gates on the ranks' records, against 9a's fit ``want``
    (centroids, stop reason, iterations, blocks, distances)."""

    def same(a, b):
        return torch.equal(a[0], b[0]) and a[1:] == b[1:]

    first = ranks[0]["c"]
    for r in ranks:
        c, who = r["c"], f"9c rank {r['rank']}"
        check(c["a_shards"] == 4, f"{who}: n_data_shards() = {c['a_shards']} on (2, 2, 1)")
        check(same(c["a_fit"], want), f"{who}: the (2, 2, 1) fit differs from 9a's")
        health, finite = c["a_fault"]
        check(finite and (health["lost_shards"], health["degraded_rounds"],
                          health["lost_mass_frac"]) == (1, 1, 0.25),
              f"{who}: shard_faults={{1: [2]}} on (2, 2, 1) gave {health}")
        check(same(c["b_fit"], want), f"{who}: the (2, 2) SUSY fit differs from 9a's")
        kind, shape, nbytes = c["c_resident"]
        check(kind == "FeatureSlice" and shape == (DIST_GMM[1] // 2, DIST_GMM[2] // 2),
              f"{who}: (2, 2) holds {kind} {shape}")
        check(same(c["c_fit"], c["c_rows_fit"]), f"{who}: the (2, 2) GMM fit differs from (4,)'s")
        check(same(c["c_fit"], first["c_fit"]), f"{who}: the GMM fit differs from rank 0's")
        for b in ("B1", "B2", "B3"):
            check(c["c_fit_launches"][b] > 0, f"{who}: {b} not launched by the GMM fit")
        check(c["c_ll_launches"]["B5"] > 0, f"{who}: B5 not launched by k-means||")
        check(torch.equal(c["c_ll"], first["c_ll"]), f"{who}: k-means|| differs from rank 0's")
        pr, de = c["c_lloyd"][True], c["c_lloyd"][False]
        check(torch.equal(pr[0], de[0]) and pr[1] == de[1] and pr[2] < de[2],
              f"{who}: dist_lloyd pruned != dense on (2, 2)")
        print(f"[dist] {who}/{DIST_WORLD} (gloo): (2, 2, 1) SUSY fit_s={c['a_s']:.3f}; (2, 2) "
              f"SUSY fit_s={c['b_s']:.3f}; GMM {DIST_GMM[1]:,} × {DIST_GMM[2]} on (2, 2): resident "
              f"x {shape[0]:,} × {shape[1]} = {nbytes / 2**20:.1f} MiB (on (4,): "
              f"{c['c_rows_resident'] / 2**20:.1f} MiB), fit_s={c['c_s']:.3f} (on (4,): "
              f"{c['c_rows_s']:.3f}), the fit's collectives (bytes) {c['c_moved']}, dist_lloyd_s "
              f"{pr[3]:.3f} / {de[3]:.3f} ({pr[1]} iterations), k-means||_s={c['c_ll_s']:.3f}; "
              f"(c) wall_s={c['c_wall_s']:.1f} peak_mem_GiB={c['c_peak'] / 2**30:.3f}; 9c wall_s="
              f"{c['wall_s']:.1f} launches={c['launches']} ({smi})")
    print(f"[dist] 9c: {DIST_WORLD} gloo ranks on one card ({smi}; correctness, not scaling): "
          f"(2, 2, 1) 4 shards, fit bit-equal to 9a, one lost shard of 4 reweighted; (2, 2) SUSY "
          f"(features whole) bit-equal to 9a; GMM on (2, 2) (features split) bit-equal to (4,) "
          f"and on every rank ({first['c_fit'][1]}, {first['c_fit'][2]} iterations), B1-B3 in "
          f"the fit, B5 in k-means|| (equal on every rank), dist_lloyd pruned == dense")


def phase_distributed(torch, repro_torch, rnd, partition, counters, x, shard_dir, incore, smi):
    """Phase 9: the distributed engine on SUSY. 9a in this process, one
    rank over NCCL; 9b four ranks spawned on the same card over gloo, and
    9c the same ranks on the further meshes (:func:`_dist_9c`). ``incore``
    is phase 4's ``(fit seconds, peak bytes)``. Returns the launches of
    all three."""
    import tempfile
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.api import engines
    from repro_torch.distributed import dist_bwkm, dist_kmeans_ll
    from repro_torch.distributed import sharding as sh
    from repro_torch.train import checkpoint

    t_phase = time.perf_counter()
    total = dict.fromkeys(counters, 0)

    def add(launches):
        for b in total:
            total[b] += launches[b]

    with tempfile.TemporaryDirectory(prefix="bwkm_dist_") as tmp:
        gmm_path = f"{tmp}/gmm.npy"
        gmm = threading.Thread(target=_write_gmm, args=(gmm_path,))
        gmm.start()  # on the host, beside 9a
        # 9a: one rank over NCCL, in this process
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous_nccl", rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            with sh.use_mesh(mesh):
                check(engines.select_engine(x) == "distributed",
                      "engine='auto' did not pick the distributed engine under use_mesh")
                torch.cuda.reset_peak_memory_stats()
                with _DistRecorder() as rec:
                    model, wall, launches = _timed_path(torch, counters, lambda: repro_torch.BWKM(
                        k=SUSY_K, engine="distributed", checkpoint_dir=f"{tmp}/ckpt").fit(x))
                peak = torch.cuda.max_memory_allocated()
                add(launches)
                res, c = model.result_, model.centroids_
                n_blocks = res.metadata["n_blocks"]
                print(f"[dist] 9a BWKM(k={SUSY_K}, engine='distributed').fit over NCCL, 1 rank: "
                      f"engine={model.engine_} stop_reason={res.stop_reason} "
                      f"iterations={res.iterations} distances={res.distances:.0f} "
                      f"blocks={n_blocks[-1]} fit_s={wall:.3f} peak_mem_GiB={peak / 2**30:.3f} "
                      f"launches={launches}; phase 4's in-core fit: fit_s={incore[0]:.3f} "
                      f"peak_mem_GiB={incore[1] / 2**30:.3f} ({smi})")
                check(model.engine_ == "distributed", f"the fit took engine {model.engine_!r}")
                check(tuple(c.shape) == (SUSY_K, x.shape[1]) and bool(torch.isfinite(c).all()),
                      "9a centroids not finite [27, 19]")
                for b in ("B1", "B2", "B3"):
                    check(launches[b] > 0, f"9a: kernel {b} was not launched by the fit")
                bid0, st0 = rec.planes[0].rounds[0]
                one = partition.block_stats(x, bid0, st0.capacity)
                check(all(torch.equal(a, b) for a, b in zip(
                    (st0.psum, st0.count, st0.lo, st0.hi), one)),
                      "9a: the initial round's statistics differ from block_stats over all rows")
                del one
                score = model.score(x)
                ref_score = _score_f64(torch, x, c)
                check(abs(score - ref_score) <= 1e-4 * abs(ref_score),
                      f"9a score {score} vs float64 {ref_score}")
                n_rounds = len(rec.planes[0].rounds)
                print(f"[dist] 9a fit breakdown (host clock between synchronizes): routing all "
                      f"rows into the sample's boxes {rec.spans['route']:.3f} s, {n_rounds} "
                      f"statistics rounds {rec.spans['stats']:.3f} s, the rest (Algorithms 2–4 "
                      f"on the sample, Lloyd over the representatives, splits) "
                      f"{wall - rec.spans['route'] - rec.spans['stats']:.3f} s")
                print(f"[dist] 9a: initial statistics bit-equal to block_stats over all "
                      f"{x.shape[0]:,} rows ({int(st0.n_blocks)} blocks); score={score!r} "
                      f"(vs float64 {(score - ref_score) / ref_score:+.3e}; phase 4's in-core "
                      f"fit starts from another partition, so the two are not compared)")
                step = checkpoint.latest_step(f"{tmp}/ckpt")
                part = res.metadata["partition"]
                template = {"centroids": c, "boxes": {"lo": part.lo, "hi": part.hi,
                                                      "active": part.active,
                                                      "n_blocks": part.n_blocks}}
                state, _ = checkpoint.restore(f"{tmp}/ckpt", step, template)
                check(step == res.iterations and torch.equal(state["centroids"], c)
                      and all(torch.equal(state["boxes"][f], template["boxes"][f])
                              for f in template["boxes"]),
                      f"9a: checkpoint step {step} does not restore the result")
                runs, launches = _dist_lloyd_pair(torch, dist_bwkm, counters, x, c)
                add(launches)
                (pr, pr_s), (de, de_s) = runs[True], runs[False]
                check(pr.iters == de.iters and torch.equal(pr.centroids, de.centroids),
                      "9a: dist_lloyd pruned != dense")
                check(pr.distances < de.distances, "9a: dist_lloyd pruning saved no distance")
                check(launches["B2"] > 0 and launches["B3"] > 0, f"9a: dist_lloyd launches {launches}")
                print(f"[dist] 9a: checkpoint step {step} restores the result; dist_lloyd from the "
                      f"fit: {pr.iters} iterations, pruned == dense bit for bit, distances "
                      f"{pr.distances:.0f} pruned / {de.distances:.0f} dense, wall_s "
                      f"{pr_s:.3f} / {de_s:.3f}, launches={launches}")
                with _DistRecorder() as rec:
                    seeds, ll_s, launches = _timed_path(
                        torch, counters,
                        lambda: dist_kmeans_ll.dist_kmeans_parallel(rnd.key(0), x, SUSY_K))
                add(launches)
                sess = rec.sessions[0]
                phi = float(sess.phi)
                phi64 = _cost_f64(torch, x, sess.cand[sess.cvalid > 0])
                check(launches["B5"] > 0, f"9a: dist_kmeans_parallel launches {launches}")
                check(abs(phi - phi64) <= 1e-5 * phi64, f"9a: φ {phi} vs float64 fold {phi64}")
                check(tuple(seeds.shape) == (SUSY_K, x.shape[1]) and bool(torch.isfinite(seeds).all()),
                      "9a: k-means|| seeds not finite [27, 19]")
                print(f"[dist] 9a: dist_kmeans_parallel k={SUSY_K}: wall_s={ll_s:.3f} "
                      f"candidates={int(sess.cvalid.sum())} φ={phi!r} (vs float64 fold "
                      f"{(phi - phi64) / phi64:+.3e}) launches={launches}")
        finally:
            dist.destroy_process_group()
        # 9b and 9c: four ranks on the one card over gloo
        gmm.join()
        t0 = time.perf_counter()
        ranks = _spawn_ranks(torch, shard_dir, tmp, gmm_path)
        t_9b = time.perf_counter() - t0
    for r in ranks:
        rc, stop, iters, blocks, distances = r["fit"]
        check(torch.equal(rc, c.cpu()) and stop == res.stop_reason and iters == res.iterations
              and blocks == n_blocks and distances == res.distances,
              f"9b rank {r['rank']}: the fit differs from 9a's")
        check(torch.equal(r["lloyd"][True][0], r["lloyd"][False][0])
              and r["lloyd"][True][1] == r["lloyd"][False][1]
              and r["lloyd"][True][2] < r["lloyd"][False][2],
              f"9b rank {r['rank']}: dist_lloyd pruned != dense")
        check(torch.equal(r["ll"][0], r["ll"][1]), f"9b rank {r['rank']}: k-means|| did not repeat")
        for other in ("lloyd", "ll"):
            mine = r[other][True][0] if other == "lloyd" else r[other][0]
            first = ranks[0][other][True][0] if other == "lloyd" else ranks[0][other][0]
            check(torch.equal(mine, first), f"9b rank {r['rank']}: {other} differs from rank 0's")
        health, stop, finite = r["fault"]
        check(finite and (health["lost_shards"], health["degraded_rounds"],
                          health["lost_mass_frac"]) == (1, 1, 0.25),
              f"9b rank {r['rank']}: shard_faults={{1: [2]}} gave {health}")
        check(r["abort"] is not None and "aborting" in r["abort"],
              f"9b rank {r['rank']}: max_shard_loss_frac=0.2 did not raise ShardLossError")
        for b in ("B1", "B2", "B3"):
            check(r["fit_launches"][b] > 0, f"9b rank {r['rank']}: kernel {b} not launched by the fit")
        check(r["launches"]["B5"] > 0, f"9b rank {r['rank']}: B5 not launched")
        add(r["launches"])
        add(r["c"]["launches"])
        print(f"[dist] 9b rank {r['rank']}/{DIST_WORLD} (gloo, {r['rows']:,} rows): wall_s="
              f"{r['wall_s']:.1f} (fit_s={r['fit_s']:.3f}, dist_lloyd_s "
              f"{r['lloyd'][True][3]:.3f} / {r['lloyd'][False][3]:.3f}, k-means||×2_s="
              f"{r['ll_s']:.3f}, faulted fit_s={r['fault_s']:.3f}) peak_mem_GiB="
              f"{r['peak'] / 2**30:.3f} launches={r['launches']} ({smi})")
    print(f"[dist] 9b: {DIST_WORLD} gloo ranks on one card ({smi}; this checks correctness, not "
          f"scaling): fit bit-equal to 9a on every rank ({res.stop_reason}, {res.iterations} "
          f"iterations, {n_blocks[-1]} blocks), dist_lloyd pruned == dense, k-means|| twice "
          f"bit-equal, shard_faults={{1: [2]}} -> lost_shards 1, degraded_rounds 1, "
          f"lost_mass_frac 0.25; max_shard_loss_frac=0.2 raised ShardLossError on all "
          f"{DIST_WORLD} ranks")
    _check_9c(torch, ranks, (c.cpu(), res.stop_reason, res.iterations, n_blocks, res.distances),
              smi)
    print(f"[dist] 9b and 9c took {t_9b:.1f} s (9c {max(r['c']['wall_s'] for r in ranks):.1f} s "
          f"of it on the slowest rank)")
    print(f"[dist] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------- walls
def _walls_child(src: str, reps: int) -> int:
    """``--walls SRC REPS``, run by :func:`phase_walls` in a process of its
    own: the SUSY fit and k-means|| at K = 27 and K = 100 with the package
    under SRC (its kernels built first), one untimed round, then ``reps``
    timed ones; their walls as one JSON line."""
    import torch

    sys.path.insert(0, src)
    import repro_torch
    from repro_torch import random as rnd
    from repro_torch.core import kmeans_ll
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build

    _build.build_all()
    x = torch.from_numpy(paper_dataset("SUSY", seed=0)).cuda()
    runs = {
        "fit": lambda: repro_torch.BWKM(k=SUSY_K).fit(x),
        "kmeans|| K=27": lambda: kmeans_ll.kmeans_parallel(rnd.key(0), x, None, 27),
        "kmeans|| K=100": lambda: kmeans_ll.kmeans_parallel(rnd.key(0), x, None, 100),
    }
    walls = {name: [] for name in runs}
    for i in range(reps + 1):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                walls[name].append(time.perf_counter() - t0)
    print(json.dumps(walls))
    return 0


def phase_walls(parent_tree, reps=3):
    """The walls of the SUSY fit and of k-means|| at K = 27 and K = 100
    with the parent's package (its Python and its kernels) and with this
    one, each in a process of its own, in turns: parent, this, this,
    parent, ``reps`` timed runs in each."""
    parent_src = pathlib.Path(parent_tree).resolve() / "src"
    for who, src in (("parent", parent_src), ("this", ROOT / "src"), ("this", ROOT / "src"),
                     ("parent", parent_src)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--walls", str(src), str(reps)],
            capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"the walls of {who} failed:\n{proc.stderr[-3000:]}")
        walls = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[walls] {who}: " + "; ".join(
            f"{name} " + " / ".join(f"{v:.4f}" for v in vs) + " s" for name, vs in walls.items()))


# ---------------------------------------------------------------- profile
def _profile_run(torch, label, fn, spans, out_file: pathlib.Path):
    """Run ``fn`` once under ``torch.profiler`` with ``record_function``
    spans around the ``(owner, attribute)`` callables of ``spans``; print
    the wall, the device's busy and idle shares, the spans, the host syncs
    and the largest kernels, and write the full table to ``out_file``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def wrap(fn_, name):
        def inner(*a, **kw):
            with record_function(name):
                return fn_(*a, **kw)
        return inner

    saved = {}
    for (owner, attr), name in spans.items():
        saved[(owner, attr)] = getattr(owner, attr)
        setattr(owner, attr, wrap(saved[(owner, attr)], name))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(f"span:{label}"):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (owner, attr), fn_ in saved.items():
            setattr(owner, attr, fn_)
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA and not e.key.startswith("span:")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    tag = f"[profile {label}]"
    print(f"{tag} wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms, "
          f"device idle {100 * (1 - busy / (wall * 1e3)):.1f}% of the wall")
    host = {e.key: e for e in avg if e.key.startswith("span:") and e.cpu_time_total > 0}
    dev = {e.key: e for e in avg if e.key.startswith("span:") and e.device_type == DeviceType.CUDA}
    for key, e in sorted(host.items(), key=lambda kv: -kv[1].cpu_time_total):
        d = dev.get(key)
        d_ms = "n/a" if d is None else f"{d.device_time_total / 1e3:.1f} ms"
        print(f"{tag} {key[5:]}: calls {e.count}, host {e.cpu_time_total / 1e3:.1f} ms, "
              f"device range {d_ms}")
    for e in avg:
        if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize", "aten::nonzero"):
            print(f"{tag} host sync {e.key}: calls {e.count}, host {e.cpu_time_total / 1e3:.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"{tag} kernel {e.key[:60]}: calls {e.count}, {e.self_device_time_total / 1e3:.2f} ms")
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(avg.table(sort_by="self_device_time_total", row_limit=60))


def phase_profile(torch, repro_torch, rnd, x, out_dir: pathlib.Path):
    """One profiled SUSY fit with spans around the driver's steps, and one
    profiled k-means|| run at K = 27 and at K = 100 with spans around the
    folds, the round's packing, the weighting pass and the reduction."""
    from repro_torch.core import init_partition, kmeans_ll, kmeanspp, lloyd, partition
    from repro_torch.engine import incore
    from repro_torch.kernels import ops

    _profile_run(torch, "fit", lambda: repro_torch.BWKM(k=SUSY_K).fit(x), {
        (partition, "block_stats"): "span:block_stats",
        (partition, "route_split"): "span:route_split",
        (init_partition, "cutting_probabilities_alg4"): "span:algorithm4",
        (init_partition, "starting_partition"): "span:algorithm3",
        (lloyd, "weighted_lloyd"): "span:lloyd_over_reps",
    }, out_dir / "susy_fit_profile.txt")
    for k in (27, 100):
        _profile_run(torch, f"kmeans|| K={k}",
                     lambda: kmeans_ll.kmeans_parallel(rnd.key(0), x, None, k), {
                         (ops, "min_sqdist_update"): "span:fold (B5)",
                         (incore.InCoreLLSession, "select"): "span:draw and pack",
                         (ops, "assign_update"): "span:weighting pass",
                         (kmeanspp, "weighted_kmeanspp"): "span:kmeans++ reduction",
                     }, out_dir / f"kmeans_ll_k{k}_profile.txt")
    _profile_stream(torch, repro_torch, rnd, x, out_dir)
    _profile_service(torch, x, out_dir)


def _profile_service(torch, x, out_dir: pathlib.Path):
    """Five update batches of phase 7's service (after its bootstrap on the
    first batch), profiled with spans around the steps of an update."""
    from repro_torch.core import lloyd, misassignment, partition
    from repro_torch.core.bwkm import BWKMConfig
    from repro_torch.service import BWKMSession, ServiceConfig

    cfg = ServiceConfig(base=BWKMConfig(k=SUSY_K, max_iters=SERVICE_BOOT_ITERS), decay=0.9,
                        max_splits_per_refit=SERVICE_MAX_SPLITS)
    session = BWKMSession(cfg)
    session.partial_fit(x[:CHUNK])
    batches = [x[i * CHUNK : (i + 1) * CHUNK] for i in range(1, 6)]
    _profile_run(torch, "service 5 batches", lambda: [session.partial_fit(b) for b in batches], {
        (partition, "route_into_boxes"): "span:route_into_boxes",
        (partition, "block_stats"): "span:block_stats",
        (lloyd, "weighted_lloyd"): "span:weighted_lloyd (tracking, refit)",
        (misassignment, "sample_boundary"): "span:sample_boundary",
        (partition, "split_blocks_virtual"): "span:split_blocks_virtual",
    }, out_dir / "susy_service_profile.txt")


def _profile_stream(torch, repro_torch, rnd, x, out_dir: pathlib.Path):
    """The streaming fit and streaming k-means|| at K = 27 over the data as
    20 shards, profiled with spans around the passes and their steps."""
    import tempfile

    from repro_torch import streaming
    from repro_torch.core import kmeanspp, lloyd, partition
    from repro_torch.data.chunks import as_chunk_source, write_npy_shards
    from repro_torch.engine import streaming as eng
    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory(prefix="bwkm_shards_") as tmp:
        write_npy_shards(x.cpu().numpy(), tmp, rows_per_shard=STREAM_SHARD_ROWS)
        glob = f"{tmp}/*.npy"
        _profile_run(torch, "streaming fit", lambda: repro_torch.BWKM(k=SUSY_K).fit(glob), {
            (eng, "streaming_initial_partition"): "span:sample pass and Algorithms 2-4",
            (eng, "_routing_pass"): "span:routing pass",
            (eng, "_split_pass"): "span:split passes",
            (partition, "route_into_boxes"): "span:route_into_boxes",
            (partition, "block_stats"): "span:block_stats",
            (partition, "route_split"): "span:route_split",
            (lloyd, "weighted_lloyd"): "span:lloyd_over_reps",
        }, out_dir / "susy_stream_fit_profile.txt")
        src = as_chunk_source(glob, CHUNK)
        _profile_run(torch, "streaming kmeans|| K=27",
                     lambda: streaming.kmeans_parallel_streaming(rnd.key(0), src, SUSY_K), {
                         (ops, "min_sqdist_update_chunk"): "span:fold (B5)",
                         (eng.StreamLLSession, "begin_round"): "span:begin_round (folds, draws)",
                         (eng.StreamLLSession, "select"): "span:select and gather",
                         (ops, "assign_update_chunk"): "span:weighting (B2)",
                         (kmeanspp, "weighted_kmeanspp"): "span:kmeans++ reduction",
                     }, out_dir / "susy_stream_kmeans_ll_profile.txt")


# ---------------------------------------------------------------- phase 10
def _tune_case(torch, autotune, label, seam, x, k, run, smi, sms):
    """Tune one seam at ``x``'s shape with a cold key, print every
    candidate's time, then check that every candidate (and the choice) gives
    the analytic plan's outputs bit for bit on ``run``'s inputs, and that a
    second call is a cache hit that times nothing. Returns the entry."""
    n, d = x.shape
    blk = autotune.blocking(seam, n=n, d=d, k=k, dtype=x.dtype)
    check(blk["source"] == "measured", f"{label}: autotune gave a {blk['source']} plan, not a "
          "measured one, for a cold key on the card")
    nb = autotune.n_bucket(n)
    for knobs, sec in blk["timings"]:
        print(f"[autotune] {label} {seam} x[{n},{d}] K={k} timed at n={nb}: "
              f"{json.dumps(knobs) if knobs else 'analytic'} {sec * 1e3:.4f} ms ({smi})")
    print(f"[autotune] {label} {seam} x[{n},{d}] K={k} timed at n={nb}: "
          f"{blk['candidates_timed']} candidates timed, {blk['candidates_refused']} refused; "
          f"analytic {blk['analytic_seconds'] * 1e3:.4f} ms, tuned {blk['seconds'] * 1e3:.4f} ms "
          f"({json.dumps(blk['knobs']) if blk['knobs'] else 'the analytic plan'}), speedup "
          f"{blk['speedup_vs_analytic']:.3f}x ({smi})")
    cands = autotune.candidate_blockings(seam, d, k, n=n, dtype_bytes=x.element_size(), sms=sms)
    base = run(cands[0])
    for cand in [*cands[1:], blk]:
        out = run(cand)
        check(all(torch.equal(u, v) for u, v in zip(out, base)),
              f"{label}: the plan {cand['knobs']} changes an output bit")
    calls = []
    hit = autotune.blocking(seam, n=n, d=d, k=k, dtype=x.dtype,
                            measure=lambda plan: calls.append(plan) or 0.0)
    check(hit["source"] == "cache" and not calls and hit["knobs"] == blk["knobs"],
          f"{label}: the second call was not a cache hit that times nothing")
    print(f"[autotune] {label}: {len(cands)} candidate plans at x[{n},{d}] K={k} bit-equal to "
          "the analytic plan; a second call hit the cache with 0 measure calls")
    return blk, cands[0]


def phase_autotune(torch, repro_torch, x, ll_path, smi):
    """Phase 10: the measured autotune at the main path's shapes, from a
    fresh cache, each candidate's time beside the card; every candidate
    bit-equal; cache hits; the file reloaded; a fit tuned from a fresh cache
    bit-equal to one with ``REPRO_AUTOTUNE=0``; and the clustering drivers
    (``launch.cluster --compare``, ``launch.serve --task clusters``) run as
    a user runs them."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import distance_assign as da
    from repro_torch.kernels import fused_assign_update as fau
    from repro_torch.kernels import min_sqdist_update as msu

    t_phase = time.perf_counter()
    n, d = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(101)
    ones = torch.ones(n, device="cuda")
    reps = x[torch.randint(0, n, (CAPACITY_REPS,), generator=g, device="cuda")]
    wr = torch.rand(CAPACITY_REPS, generator=g, device="cuda") * 50
    c27 = x[torch.randint(0, n, (SUSY_K,), generator=g, device="cuda")]
    cached = da.assign_top2_cuda(reps, c27)[0]
    act = torch.rand(CAPACITY_REPS, generator=g, device="cuda") < 0.1
    c561 = ll_path[27][0]
    cand = x[torch.randint(0, n, (112,), generator=g, device="cuda")]
    cv = torch.ones(112, device="cuda")
    mind2 = msu.min_sqdist_update_cuda(x, ones, x[:1], cv[:1],
                                       torch.full((n,), BIG, device="cuda"))[0]
    chunk = x[:CHUNK]
    cases = [
        ("B1", "assign_update", chunk, SUSY_K,
         lambda plan: da.assign_top2_cuda(chunk, c27, plan=plan)),
        ("B2", "assign_update", reps, SUSY_K,
         lambda plan: fau.fused_assign_update_cuda(reps, wr, c27, plan=plan)),
        ("B3", "assign_update_pruned", reps, SUSY_K,
         lambda plan: fau.fused_assign_update_pruned_cuda(reps, wr, c27, cached, act, plan=plan)),
        ("B2@561", "assign_update", x, c561.shape[0],
         lambda plan: fau.fused_assign_update_cuda(x, ones, c561, plan=plan)),
        ("B5@112", "min_sqdist_update", x, 112,
         lambda plan: msu.min_sqdist_update_cuda(x, ones, cand, cv, mind2, plan=plan)),
    ]
    with tempfile.TemporaryDirectory(prefix="bwkm_phase10_") as tmp:
        cache = pathlib.Path(tmp) / "autotune.json"
        os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
        autotune.clear_memo()
        entries = {}
        for label, seam, xx, k, run in cases:
            entries[label] = _tune_case(torch, autotune, label, seam, xx, k, run, smi, sms)
        # B1 takes the scan part of the assign_update plan tuned above
        blk, ana = entries["B1"]
        print(f"[autotune] B1 alone at x[{CHUNK},{d}] K={SUSY_K} (CUDA-graph replays): analytic "
              f"plan {_time_graph(torch, lambda: da.assign_top2_cuda(chunk, c27, plan=ana)):.4f} "
              f"ms, tuned plan "
              f"{_time_graph(torch, lambda: da.assign_top2_cuda(chunk, c27, plan=blk)):.4f} ms "
              f"({smi})")
        autotune.clear_memo()  # as a new process: the file is read back
        for label, seam, xx, k, _ in cases:
            hit = autotune.blocking(seam, n=xx.shape[0], d=d, k=k, dtype=xx.dtype,
                                    measure=lambda plan: check(False, "a reloaded hit timed"))
            check(hit["source"] == "cache" and hit["knobs"] == entries[label][0]["knobs"],
                  f"{label}: the cache file did not give back the tuned plan")
        print(f"[autotune] after clear_memo every key came back from {cache.name} "
              f"({len(json.loads(cache.read_text())['entries'])} entries) without timing")

        # phase 4's fit from a fresh cache, against the fit with autotune off
        os.environ["REPRO_AUTOTUNE_CACHE"] = str(pathlib.Path(tmp) / "fit.json")
        autotune.clear_memo()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tuned = repro_torch.BWKM(k=SUSY_K).fit(x)
        torch.cuda.synchronize()
        wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        measured = sum(e.get("source") == "measured" for e in autotune._memo.values())
        os.environ["REPRO_AUTOTUNE"] = "0"
        try:
            plain = repro_torch.BWKM(k=SUSY_K).fit(x)
        finally:
            del os.environ["REPRO_AUTOTUNE"]
        rt, rp = tuned.result_, plain.result_
        check(torch.equal(tuned.centroids_, plain.centroids_)
              and (rt.stop_reason, rt.iterations, rt.distances)
              == (rp.stop_reason, rp.iterations, rp.distances),
              "the fit tuned from a fresh cache differs from the fit with REPRO_AUTOTUNE=0")
        print(f"[autotune] BWKM(k={SUSY_K}).fit from a fresh cache ({measured} keys measured): "
              f"wall_s={wall:.3f} peak_mem_GiB={peak / 2**30:.3f}; centroids, stop reason "
              f"({rt.stop_reason}), iterations ({rt.iterations}) and distances bit-equal to "
              f"the fit with REPRO_AUTOTUNE=0 ({smi})")

        # the clustering system's own drivers, as a user runs them
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_AUTOTUNE_CACHE=str(cache))
        for argv, marker in (
            (["-m", "repro_torch.launch.cluster", "--dataset", "SUSY", "--k", "27", "--compare"],
             "[cluster] relative errors:"),
            (["-m", "repro_torch.launch.serve", "--task", "clusters"], "[serve:clusters] served"),
        ):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(r.returncode == 0 and marker in r.stdout,
                  f"python {' '.join(argv)} failed ({r.returncode}):\n{r.stdout[-3000:]}\n"
                  f"{r.stderr[-3000:]}")
            for line in r.stdout.splitlines():
                print(f"[launch] {line}")
            print(f"[launch] python {' '.join(argv)}: exit 0 in {wall:.1f} s, process start "
                  f"included ({smi})")
    print(f"[autotune] phase 10 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 11
VQ_ARCH = "granite-8b"  # the reference's serve.py, tests/test_vq.py and BENCH_vq.json default
VQ_FULL = dict(n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, hd=128, d_ff=14336,
               vocab=49152)
VQ_BATCH, VQ_PROMPT, VQ_STEPS = 8, 512, 32  # prompts, tokens each, greedy decode steps
VQ_K = 256  # the codebooks' k: uint8 codes
#: the KV layers 11a fits: K and V of every third layer, 24 of the 72 sources;
#: the others serve from the random codebook
VQ_FIT_LAYERS = range(0, 36, 3)
ROUTER_ARCH, ROUTER_LAYERS = "deepseek-moe-16b", 2  # widths as published, depth cut from 28
ROUTER_TOKENS = (64, 512)


def _expert_load_cv(torch, h, w, top_k):
    """Coefficient of variation of the expert loads of ``h @ w`` under top-k
    routing (``examples/router_init.py``'s ``load_imbalance``)."""
    idx = torch.topk(h @ w, top_k, dim=-1).indices
    counts = torch.bincount(idx.reshape(-1), minlength=w.shape[1]).double()
    return float(counts.std(unbiased=False) / counts.mean())


def _router_ok(torch, w):
    """Every column of ``w [d, E]`` has unit norm or is zero, none NaN."""
    norms = torch.linalg.vector_norm(w, dim=0)
    return bool(torch.isfinite(w).all()) and bool(((norms - 1).abs() < 1e-5).logical_or(
        norms == 0).all())


def _vq_times(torch, ref, da, tally):
    """B1 at the vq path's shapes (a 4,096-row ``quantize_rows`` chunk and
    the 64 rows a decode step re-quantizes, against [256, 128]; a chunk
    against (b)'s exact codebook of 34,816 rows), beside the plain version,
    ``cdist`` + ``topk`` and the bound."""
    from repro_torch.roofline import analysis

    g = torch.Generator(device="cuda").manual_seed(111)
    exact_k = VQ_BATCH * (VQ_PROMPT + VQ_STEPS) * 8
    for n, k in ((4096, VQ_K), (64, VQ_K), (4096, exact_k)):
        c = torch.randn(k, 128, generator=g, device="cuda") * 1.3
        x = torch.randn(n, 128, generator=g, device="cuda") * 1.3
        reps = 20 if k == VQ_K else 3
        ms = _time_graph(torch, lambda x=x, c=c: da.assign_top2_cuda(x, c), reps)
        plain_ms = _time_graph(torch, lambda x=x, c=c: ref.assign_top2(x, c), reps)
        library_ms = _time_graph(torch, lambda x=x, c=c: torch.topk(
            torch.cdist(x, c) ** 2, 2, dim=1, largest=False), reps)
        bound = analysis.assign_top2_bound(n, 128, k)
        print(f"[time] B1 vq x[{n},128] c[{k},128] f32: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (cdist + topk), bound "
              f"{bound.ms:.6f} ms ({bound.by}), phase 11a launches at this shape "
              f"{tally.counts.get(('B1', n, k), 0)}")
    # B1's width sweep at 4,096 rows × 256: one feature chunk (d <= 32), or
    # a row re-read from the staged tile per group of four candidates, whose
    # lanes share a bank when d is a multiple of 32
    for d in (32, 64, 127, 128, 129):
        c = torch.randn(VQ_K, d, generator=g, device="cuda")
        x = torch.randn(4096, d, generator=g, device="cuda")
        ms = _time_graph(torch, lambda x=x, c=c: da.assign_top2_cuda(x, c))
        plain_ms = _time_graph(torch, lambda x=x, c=c: ref.assign_top2(x, c))
        print(f"[time] B1 width sweep x[4096,{d}] c[{VQ_K},{d}] f32: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")


def _vq_checks(torch, ref, da, cu, msu, counts, d, kernels=("B1", "B4", "B5"), phase="11a"):
    """``kernels`` (of B1, B4 and B5) at every ``(kernel, rows, K)`` shape in
    ``counts`` (the shapes ``phase`` gave them), at ``d`` features in f32, against their
    plain versions within the f32 tolerance: B1's labels at the minimum
    distance and its d1/d2, with all candidates real and again with about
    half parked as k-means|| parks its weighting pass's unfilled slots;
    B4's sums and counts relative to Σ|terms|; B5's min-d² relative to
    ‖x‖² + ‖c‖² and its cost, on a first fold and on a later one. Returns
    the largest absolute error per kernel and the number of cases."""
    from repro_torch.core import kmeans_ll

    tol = TOL["float32"]
    errs = dict.fromkeys(kernels, 0.0)
    cases = 0
    for i, (b, n, k) in enumerate(sorted(key for key in counts if key[0] in errs)):
        tag = f"{b} vq x[{n},{d}] K={k}"
        if b == "B1":
            for far in (None, kmeans_ll._FAR):
                x, _, c = _data(torch, n, d, k, torch.float32, seed=500 + i, far=far)
                what = tag + (" half parked" if far else "")
                a, d1, d2 = da.assign_top2_cuda(x, c)
                _, rd1, rd2 = ref.assign_top2(x, c)
                _labels_ok(torch, ref, x, c, a, tol, what)
                errs[b] = max(errs[b], _close(torch, d1, rd1, tol, f"{what} d1")[0],
                              _close(torch, d2, rd2, tol, f"{what} d2")[0])
                cases += 1
        elif b == "B4":
            x, w, _ = _data(torch, n, d, 1, torch.float32, seed=500 + i)
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            ids = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
            sums, cnt = cu.cluster_sums_cuda(x, w, ids, k)
            rs, rc = ref.cluster_sums(x, w, ids, k)
            ss, sc = _abs_sums(torch, ref, x, w, ids, k)
            errs[b] = max(errs[b], _close(torch, sums, rs, tol, f"{tag} sums", ss)[0],
                          _close(torch, cnt, rc, tol, f"{tag} counts", sc)[0])
            cases += 1
        else:
            for first in (True, False):
                x, w, cand, cvalid, mind2 = _fold_case(torch, n, d, k, torch.float32, 500 + i,
                                                       first, True)
                what = f"{tag} first={first}"
                new, cost = msu.min_sqdist_update_cuda(x, w, cand, cvalid, mind2)
                r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
                scale = (x ** 2).sum(1) + (cand ** 2).sum(1).max()
                errs[b] = max(errs[b], _close(torch, new, r.mind2, tol, what, scale)[0])
                _close(torch, cost, r.cost, dict(rtol=1e-5, atol=0.0), f"{what} cost")
                check(bool((new <= mind2).all()), f"{what}: the fold raised a min-d²")
                cases += 1
    check(all(any(key[0] == b for key in counts) for b in errs),
          f"phase {phase} gave no shape of one of {sorted(errs)}: {sorted(counts)}")
    torch.cuda.synchronize()
    return errs, cases


def phase_vq(torch, rnd, ref, da, fau, cu, msu, counters, smi):
    """Phase 11: KV-cache quantisation on granite-8b at full width and depth
    (11a), router seeding at deepseek-moe-16b's widths (11b) and the ``lm``
    driver (11c). Returns 11a's launches and the largest absolute errors of
    B1, B4 and B5 at the shapes 11a gave them."""
    import numpy as np

    from repro_torch import configs, vq
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = configs.get_config(VQ_ARCH)
    check({f: getattr(cfg, f) for f in VQ_FULL} == VQ_FULL and cfg.dtype == torch.bfloat16
          and cfg.param_dtype == torch.float32, f"{VQ_ARCH} is not at its published widths")
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    sc = VQ_PROMPT + VQ_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, rnd.key(24))
    torch.cuda.synchronize()
    n_values = sum(t.numel() for t in _tree_leaves(params))
    print(f"[vq] 11a {VQ_ARCH} at full width and depth ({L} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, kv {kv}, hd {hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; bf16 "
          f"compute, f32 params): {n_values / 1e9:.3f} G values initialised on the card from "
          f"a seed in {time.perf_counter() - t0:.2f} s")
    prompts = TokenStream(cfg.vocab, VQ_PROMPT, VQ_BATCH, seed=0).batch(0)[0]
    fit_prompts = TokenStream(cfg.vocab, VQ_PROMPT, VQ_BATCH, seed=1).batch(0)[0].cpu().numpy()
    serve.generate(cfg, params, prompts[:, :16], 2)  # warm-up: cuBLAS handles, the allocator

    tally = _ShapeTally(da, fau, cu, msu)
    _zero(counters)
    with _plain_calls(ref) as plain, tally.active():
        # (a) prefill and 32 greedy decode steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = serve.generate(cfg, params, prompts, VQ_STEPS + 1)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        peak_a = torch.cuda.max_memory_allocated()
        # (b) lossless at full width: a codebook of the cache's own rows
        t0 = time.perf_counter()
        last, cache = tf.prefill(cfg, params, prompts, max_seq_len=sc)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        tps_a = VQ_BATCH * (VQ_STEPS + 1) / wall_a
        print(f"[vq] (a) generate: prefill [{VQ_BATCH}, {VQ_PROMPT}] then {VQ_STEPS} greedy decode "
              f"steps in {wall_a:.3f} s ({tps_a:.1f} tok/s; prefill alone {t_prefill:.3f} s, so "
              f"{(wall_a - t_prefill) / VQ_STEPS * 1e3:.1f} ms a decode step); peak device memory "
              f"{peak_a / 2**30:.2f} GiB ({smi})")
        check(torch.equal(torch.argmax(last, -1).to(torch.int32), gen[:, 0]),
              "prefill's token differs from generate's first")
        exact = vq.KVCodebook(cache["k"].float().cpu().numpy().reshape(L, -1, hd),
                              cache["v"].float().cpu().numpy().reshape(L, -1, hd))
        check(exact.k == VQ_BATCH * sc * kv and exact.code_dtype == torch.uint16,
              f"the exact codebook has k = {exact.k}, codes {exact.code_dtype}")
        t0 = time.perf_counter()
        qcache = vq.quantize_cache(exact, cache)
        torch.cuda.synchronize()
        t_q = time.perf_counter() - t0
        kcb = torch.from_numpy(exact.k_centroids).cuda()
        vcb = torch.from_numpy(exact.v_centroids).cuda()
        tok = gen[:, 0]
        raw, _ = tf.decode(cfg, params, cache, tok, VQ_PROMPT)
        quant, _ = vq.decode_quantized(cfg, params, kcb, vcb, qcache, tok, VQ_PROMPT)
        diff, scale = float((raw - quant).abs().max()), float(raw.abs().max())
        check(diff <= 1e-3 * scale, f"lossless quantised decode: max |Δlogit| {diff:.3g} > 1e-3 × "
              f"{scale:.3g}")
        print(f"[vq] (b) lossless: codebook = the prefill cache's own rows, k = {exact.k:,} a "
              f"layer (uint16 codes; quantize_cache {t_q:.2f} s, B1 at K = {exact.k:,}); one "
              f"decode_quantized step against decode: max |Δlogit| {diff:.3g} "
              f"({'bit-equal' if diff == 0 else 'not bit-equal'}; limit 1e-3 × max |logit| "
              f"{scale:.3g})")
        del exact, qcache, kcb, vcb, raw, quant
        torch.cuda.empty_cache()
        # (c) 24 streaming fits: K and V of every third layer
        t0 = time.perf_counter()
        cb = vq.fit_kv_codebook(cfg, params, fit_prompts, k=VQ_K, layers=VQ_FIT_LAYERS)
        fit_wall = time.perf_counter() - t0
        audit = cb.meta["layers"]
        n_rows = VQ_BATCH * VQ_PROMPT * kv
        fitted = list(VQ_FIT_LAYERS)
        check(len(audit) == 2 * len(fitted) and all(m["engine"] == "streaming" for m in audit)
              and all(m["n_points"] == n_rows for m in audit),
              f"codebook audit: {len(audit)} fits, engines {sorted({m['engine'] for m in audit})}, "
              f"rows {sorted({m['n_points'] for m in audit})}")
        check(cb.code_dtype == torch.uint8 and np.isfinite(cb.k_centroids).all()
              and np.isfinite(cb.v_centroids).all(), "the fitted codebook is not finite uint8")
        print(f"[vq] (c) fit_kv_codebook(k={VQ_K}, layers {fitted[0]}, {fitted[1]}, ..., "
              f"{fitted[-1]}) over {VQ_BATCH} fit prompts × {VQ_PROMPT}: "
              f"{len(audit)} streaming fits of {n_rows:,} rows each in {fit_wall:.1f} s "
              f"({fit_wall / len(audit):.2f} s a fit, its prefill included); distances "
              f"{cb.meta['distances_total']:.4e}; stop reasons "
              f"{sorted({m['stop_reason'] for m in audit})} ({smi})")
        # (d) round-trip MSE, BWKM beside random, and quantisation == assignment
        t0 = time.perf_counter()
        rand = vq.random_kv_codebook(cfg, params, fit_prompts, k=VQ_K, seed=7)
        t_rand = time.perf_counter() - t0
        _, fcache = tf.prefill(cfg, params, torch.as_tensor(fit_prompts, device="cuda"))
        mse = {"bwkm": [], "random": []}
        worst = 0.0
        lines = []
        for layer in fitted:
            parts = []
            for kind in ("k", "v"):
                rows = fcache[kind][layer].reshape(-1, hd).float()
                for name, book in (("bwkm", cb), ("random", rand)):
                    cents = torch.from_numpy(book.centroids(kind)[layer]).cuda()
                    recon = vq.dequantize_rows(vq.quantize_rows(rows, cents), cents)
                    m = float(((rows - recon) ** 2).sum(1).mean())
                    d1 = float(ops.assign_top2(rows, cents)[1].mean())
                    worst = max(worst, abs(m - d1) / d1)
                    mse[name].append(m)
                parts.append(f"{kind} {mse['bwkm'][-1]:.4f} / {mse['random'][-1]:.4f}")
            lines.append(f"{layer}: " + ", ".join(parts))
        for i in range(0, len(lines), 6):
            print("[vq] (d) round-trip MSE, BWKM / random, layer: " + "; ".join(lines[i:i + 6]))
        mb, mr = float(np.mean(mse["bwkm"])), float(np.mean(mse["random"]))
        check(mb < mr, f"mean round-trip MSE over the {2 * len(fitted)} sources: BWKM {mb:.5g} >= "
              f"random {mr:.5g}")
        check(worst <= 1e-5, f"round-trip MSE against B1's mean d1: {worst:.3g} > 1e-5 relative")
        print(f"[vq] (d) mean over the {2 * len(fitted)} sources: BWKM {mb:.5f}, random {mr:.5f} "
              f"({mr / mb:.3f}×); BWKM lower on {sum(b < r for b, r in zip(mse['bwkm'], mse['random']))}"
              f" of {2 * len(fitted)}; every MSE equals B1's mean d1 on its rows within "
              f"{worst:.2e} "
              f"relative (limit 1e-5); random codebook (all {2 * L} sources) {t_rand:.1f} s")
        del fcache
        # (e)-(f) serve from BWKM's layers, and from the random codebook's elsewhere
        stacks = {kind: rand.centroids(kind).copy() for kind in ("k", "v")}
        for kind in stacks:
            stacks[kind][fitted] = cb.centroids(kind)[fitted]
        cb = vq.KVCodebook(stacks["k"], stacks["v"], cb.meta)
        # (e) bytes
        raw_bytes = vq.kv_cache_nbytes(cache)
        qcache = vq.quantize_cache(cb, cache)
        vq_bytes = vq.kv_cache_nbytes(qcache)
        check(qcache["k_codes"].dtype == torch.uint8 and raw_bytes == 2 * hd * vq_bytes,
              f"cache bytes {raw_bytes} against {vq_bytes} codes")
        print(f"[vq] (e) kv_cache_nbytes: raw bf16 {raw_bytes:,} B, uint8 codes {vq_bytes:,} B "
              f"({raw_bytes // vq_bytes}× smaller, exactly 2·hd), codebook {cb.nbytes:,} B")
        del cache, qcache
        # (f) serving from codes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qgen = vq.generate_quantized(cfg, params, cb, prompts, VQ_STEPS + 1)
        torch.cuda.synchronize()
        wall_f = time.perf_counter() - t0
        tps_f = VQ_BATCH * (VQ_STEPS + 1) / wall_f
        check(qgen.shape == gen.shape and int(qgen.min()) >= 0 and int(qgen.max()) < cfg.vocab,
              "generate_quantized gave tokens out of range")
        same = float((qgen == gen).float().mean())
        eval_toks = torch.cat([prompts, gen], dim=1)
        nll = {}
        for name, book in (("fp", None), ("bwkm", cb), ("random", rand)):
            t0 = time.perf_counter()
            nll[name] = vq.teacher_forced_nll(cfg, params, eval_toks, prompt_len=VQ_PROMPT,
                                              codebook=book)
            nll[name + "_s"] = time.perf_counter() - t0
        check(all(np.isfinite(nll[n]) for n in ("fp", "bwkm", "random")), f"NLL {nll}")
        print(f"[vq] (f) generate_quantized: {VQ_STEPS} decode steps over codes in {wall_f:.3f} s "
              f"({tps_f:.1f} tok/s against {tps_a:.1f} raw; {same:.3f} of its tokens equal the "
              f"raw run's); teacher-forced NLL over {VQ_STEPS + 1} positions: fp "
              f"{nll['fp']:.4f}, BWKM (every third layer, random elsewhere) {nll['bwkm']:.4f}, "
              f"random {nll['random']:.4f} (random "
              f"weights: a readout, not a gate; {nll['fp_s']:.2f} / {nll['bwkm_s']:.2f} / "
              f"{nll['random_s']:.2f} s) ({smi})")
    launches = _read(counters)
    check(launches["B1"] > 0 and launches["B4"] > 0 and launches["B5"] > 0,
          f"phase 11a launches {launches}")
    check(sum(plain.values()) == 0, f"plain distance functions ran on the card: {plain}")
    print(f"[vq] (g) launches in 11a: {launches}; by (rows, K): "
          + "; ".join(f"{b} " + ", ".join(f"[{n}, {k}] {c}" for (b_, n, k), c in
                                           sorted(tally.counts.items()) if b_ == b)
                      for b in ("B1", "B4", "B5"))
          + "; plain distance functions called 0 times")
    errs, cases = _vq_checks(torch, ref, da, cu, msu, tally.counts, hd)
    print(f"[kernels] vq shapes: B1, B4 and B5 at each (rows, K) above, d = {hd}, f32, match "
          f"their plain versions in {cases} cases (tol 1e-5; B1 labels at the minimum, also with "
          f"half the candidates parked; B4 sums to Σ|terms|; B5 min-d² to ‖x‖² + ‖c‖², first and "
          f"later folds); max abs err: " + ", ".join(f"{b} {v:.3g}" for b, v in errs.items()))
    _vq_times(torch, ref, da, tally)
    del params
    torch.cuda.empty_cache()

    # 11b: router seeding at deepseek-moe-16b's widths, depth cut
    t0 = time.perf_counter()
    dcfg = configs.get_config(ROUTER_ARCH)
    full_layers = dcfg.n_layers
    dcfg = dcfg.replace(n_layers=ROUTER_LAYERS)
    dparams = tf.init_params(dcfg, rnd.key(16))
    toks = rnd.randint(rnd.key(17), ROUTER_TOKENS, 0, dcfg.vocab, device="cuda")
    h = dparams["embed"][toks.long()].reshape(-1, dcfg.d_model)
    t1 = time.perf_counter()
    w, session = vq.seed_router(h, dcfg.n_experts, seed=2)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t1
    check(_router_ok(torch, w), "the seeded router has a column neither unit nor zero")
    w_rand = rnd.normal(rnd.key(18), tuple(w.shape), device="cuda", std=0.02)
    cv_b = _expert_load_cv(torch, h, w, dcfg.top_k)
    cv_r = _expert_load_cv(torch, h, w_rand, dcfg.top_k)
    toks2 = rnd.randint(rnd.key(19), (16, ROUTER_TOKENS[1]), 0, dcfg.vocab, device="cuda")
    h2 = dparams["embed"][toks2.long()].reshape(-1, dcfg.d_model)
    t1 = time.perf_counter()
    w2, again = vq.seed_router(h2, dcfg.n_experts, session=session)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t1
    check(again is session and _router_ok(torch, w2) and not torch.equal(w, w2),
          "the session's second batch did not refresh the router")
    seeded = vq.install_router(dparams, w2)
    with torch.inference_mode():
        logits, _, _ = tf.forward(dcfg, seeded, toks[:2])
    check(bool(torch.isfinite(logits).all()), "forward with the seeded router is not finite")
    print(f"[vq] 11b {ROUTER_ARCH} at its widths (d {dcfg.d_model}, {dcfg.n_experts} experts "
          f"top-{dcfg.top_k}, {dcfg.n_shared_experts} shared), depth cut from {full_layers} to "
          f"{ROUTER_LAYERS} layers (the {full_layers}-layer f32 tree is about 68 GB): "
          f"seed_router on the embeddings of {ROUTER_TOKENS[0]} × {ROUTER_TOKENS[1]} tokens in "
          f"{seed_s:.2f} s, refreshed from the session on {h2.shape[0]:,} more in {refresh_s:.2f} "
          f"s; columns unit or zero, none NaN; expert-load CV BWKM {cv_b:.3f}, random "
          f"{cv_r:.3f}; forward with the installed router finite {tuple(logits.shape)}; 11b "
          f"{time.perf_counter() - t0:.1f} s ({smi})")
    del dparams, seeded, logits
    torch.cuda.empty_cache()

    # 11c: the lm driver as a user runs it
    argv = ["-m", "repro_torch.launch.serve", "--task", "lm", "--kv-quantize"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0 and r.stdout.count("[serve:vq]") == 3,
          f"python {' '.join(argv)} failed ({r.returncode}):\n{r.stdout[-3000:]}\n"
          f"{r.stderr[-3000:]}")
    for line in r.stdout.splitlines():
        print(f"[launch] {line}")
    print(f"[launch] python {' '.join(argv)}: exit 0 in {wall:.1f} s, process start included "
          f"({smi})")
    print(f"[vq] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---------------------------------------------------------------- phase 12
FAM_BATCH, FAM_PROMPT, FAM_STEPS = 8, 512, 32  # prompts, tokens each, greedy decode steps
TF_AT, TF_STEPS = 256, 4  # teacher-forced: prefill 256 tokens, then decode 4
TF_SHARE_BF16 = 3e-2  # of max |logit|: prefill + decode against forward, bf16
TF_SHARE_F32 = 1e-4  # the same in f32 (the vlm); other image embeddings must move 100× this
BF16_VS_F32_SHARE = 5e-2  # of max |logit|: forward in bf16 against f32 on the same weights
SSD_TOL = dict(rtol=2e-3, atol=2e-3)  # chunked against sequential (tests/test_layers.py)
MAMBA_FULL = dict(n_layers=24, d_model=768, ssm_state=128, ssm_headdim=64, ssm_chunk=256,
                  vocab=50280)
ZAMBA_FULL = dict(n_layers=38, d_model=2048, shared_attn_every=6, n_heads=32, n_kv_heads=32,
                  hd=64, d_ff=8192, ssm_state=64, vocab=32000)
VLM_FULL = dict(d_model=8192, n_heads=64, n_kv_heads=8, hd=128, d_ff=28672, vocab=128256,
                n_image_tokens=1601, cross_attn_every=5)
VLM_LAYERS = 10  # cut from 100: two groups of four self-attention layers and a cross layer


def _published(cfg, want, name):
    got = {f: getattr(cfg, f) for f in want}
    check(got == want, f"{name} is not at its published widths: {got}")


def _share(torch, got, want, vocab):
    """max |got − want| over the real vocabulary, as a share of max |want|."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max() / want.abs().max())


def _within(torch, a, b, rtol, atol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _generate(torch, serve, tf, cfg, params, prompts, what, smi):
    """``serve.generate`` with ``FAM_STEPS`` greedy steps, then ``prefill``
    alone: wall, prefill s, ms a step, tok/s and peak memory."""
    serve.generate(cfg, params, prompts[:, :cfg.ssm_chunk or 16], 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = serve.generate(cfg, params, prompts, FAM_STEPS + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    last, cache = tf.prefill(cfg, params, prompts, max_seq_len=FAM_PROMPT + FAM_STEPS)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    check(torch.equal(torch.argmax(last, -1).to(torch.int32), gen[:, 0]),
          f"{what}: prefill's token differs from generate's first")
    check(int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab, f"{what}: tokens out of range")
    print(f"[family] {what} generate: prefill [{FAM_BATCH}, {FAM_PROMPT}] then {FAM_STEPS} greedy "
          f"decode steps in {wall:.3f} s ({FAM_BATCH * (FAM_STEPS + 1) / wall:.1f} tok/s; prefill "
          f"alone {t_pre:.3f} s, so {(wall - t_pre) / FAM_STEPS * 1e3:.1f} ms a decode step); peak "
          f"device memory {peak / 2**30:.2f} GiB ({smi})")
    return cache


def _teacher_forced(torch, tf, cfg, params, prompts, images=None):
    """``prefill`` of ``TF_AT`` tokens and ``TF_STEPS`` decode steps against
    ``forward``'s logits at those positions; returns (the share of max
    |logit| they differ by, forward's logits)."""
    n = TF_AT + TF_STEPS
    full, _, _ = tf.forward(cfg, params, prompts[:, :n] if cfg.family == "vlm" else prompts,
                            images)
    last, cache = tf.prefill(cfg, params, prompts[:, :TF_AT], images, max_seq_len=n)
    worst = _share(torch, last, full[:, TF_AT - 1], cfg.vocab)
    for j in range(TF_STEPS):
        out, cache = tf.decode(cfg, params, cache, prompts[:, TF_AT + j], TF_AT + j)
        worst = max(worst, _share(torch, out, full[:, TF_AT + j], cfg.vocab))
    return worst, full[:, :n]


def _stressed_mamba(torch, cfg, blk, seed):
    """One Mamba block's f32 parameters with no skip term, seeded decay
    rates and step biases and wide in-projections and convs (the CPU
    tests' stress: pre-activations near N(0, 2.4²))."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(v, std):
        return torch.randn(v.shape, generator=g, device="cuda") * std

    def uniform(v, lo, hi):
        return torch.rand(v.shape, generator=g, device="cuda") * (hi - lo) + lo

    return dict(blk, in_proj=randn(blk["in_proj"], 0.3 * (64 / cfg.d_model) ** 0.5),
                conv_w=randn(blk["conv_w"], 0.4), conv_b=randn(blk["conv_b"], 0.1),
                a_log=uniform(blk["a_log"], -3.0, -1.0), dt_bias=uniform(blk["dt_bias"], -3.0, -1.0),
                d_skip=torch.zeros_like(blk["d_skip"]))


def _ssd_chunked_vs_sequential(torch, mamba2, cfg, p):
    """One layer's ``mamba_forward`` over ``FAM_PROMPT`` tokens against as
    many ``mamba_decode`` steps, in f32; the same with the carried state
    zeroed before every chunk (the control). Returns (ok, the control's ok,
    max |Δ|, the control's max |Δ|)."""
    cfg = cfg.replace(dtype=torch.float32)
    dims = mamba2.mamba_dims(cfg)
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(FAM_BATCH, FAM_PROMPT, cfg.d_model, generator=g, device="cuda")
    conv = torch.zeros(FAM_BATCH, cfg.ssm_conv - 1, dims["conv_dim"], device="cuda")
    ssm = torch.zeros(FAM_BATCH, dims["nheads"], cfg.ssm_headdim, dims["n"], device="cuda")
    seq = torch.empty_like(x)
    for t in range(FAM_PROMPT):
        seq[:, t], (conv, ssm) = mamba2.mamba_decode(cfg, p, x[:, t], conv, ssm)
    chunked = mamba2.mamba_forward(cfg, p, x)
    step = mamba2._chunk_step
    with _patched(mamba2, "_chunk_step", lambda st, *a: step(torch.zeros_like(st), *a)):
        control = mamba2.mamba_forward(cfg, p, x)
    return (_within(torch, chunked, seq, **SSD_TOL), _within(torch, control, seq, **SSD_TOL),
            float((chunked - seq).abs().max()), float((control - seq).abs().max()))


def _recurrent_family(torch, rnd, cfg, seed, prompts, what, smi):
    """12a/12b: init, generate, the teacher-forced check and bf16 against
    f32; returns (params, the prefill cache of ``generate``'s shapes)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    params = tf.init_params(cfg, rnd.key(seed))
    torch.cuda.synchronize()
    n_values = sum(t.numel() for t in _tree_leaves(params))
    print(f"[family] {what}: {n_values / 1e9:.3f} G values initialised on the card from a seed in "
          f"{time.perf_counter() - t0:.2f} s")
    cache = _generate(torch, serve, tf, cfg, params, prompts, what, smi)
    share, full = _teacher_forced(torch, tf, cfg, params, prompts)
    check(share <= TF_SHARE_BF16, f"{what} teacher-forced: {share:.3g} of max |logit| > "
          f"{TF_SHARE_BF16}")
    f32, _, _ = tf.forward(cfg.replace(dtype=torch.float32), params, prompts[:, :TF_AT])
    mixed = _share(torch, full[:, :TF_AT], f32, cfg.vocab)
    check(mixed <= BF16_VS_F32_SHARE, f"{what} bf16 against f32: {mixed:.3g} of max |logit| > "
          f"{BF16_VS_F32_SHARE}")
    print(f"[family] {what} teacher-forced (prefill {TF_AT} tokens, then {TF_STEPS} decode steps, "
          f"against forward at those positions, bf16): {share:.3g} of max |logit| (limit "
          f"{TF_SHARE_BF16}); forward in bf16 against f32 on the same weights over {TF_AT} "
          f"positions: {mixed:.3g} of max |logit| (limit {BF16_VS_F32_SHARE})")
    del full, f32
    return params, cache


def phase_families(torch, rnd, ref, da, fau, cu, msu, counters, smi):
    """Phase 12: mamba2-130m (12a) and zamba2-1.2b (12b) at full width and
    depth, llama-3.2-vision-90b at full width and 10 layers with its prefill
    cache quantised through B1 (12c), and the ``lm`` driver for the
    recurrent archs (12d). Returns the phase's launches and B1's largest
    absolute error at the shapes 12c gave it."""
    import numpy as np

    from repro_torch import configs, vq
    from repro_torch.data import TokenStream
    from repro_torch.models import mamba2
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _zero(counters)
    with _plain_calls(ref) as plain:
        # 12a mamba2-130m
        t0 = time.perf_counter()
        cfg = configs.get_config("mamba2-130m")
        _published(cfg, MAMBA_FULL, "mamba2-130m")
        prompts = TokenStream(cfg.vocab, FAM_PROMPT, FAM_BATCH, seed=2).batch(0)[0]
        params, _ = _recurrent_family(torch, rnd, cfg, 25, prompts, "12a mamba2-130m", smi)
        blk = _stressed_mamba(torch, cfg, tf.layer(params["layers"], 0)["mamba"], 13)
        ok, control_ok, err, control_err = _ssd_chunked_vs_sequential(torch, mamba2, cfg, blk)
        check(ok, f"12a chunked SSD against {FAM_PROMPT} recurrent steps: max |Δ| {err:.3g}")
        check(not control_ok, f"12a control: the state zeroed between chunks still passes "
              f"(max |Δ| {control_err:.3g})")
        print(f"[family] 12a one layer's chunked SSD ({FAM_PROMPT // cfg.ssm_chunk} chunks of "
              f"{cfg.ssm_chunk}) against {FAM_PROMPT} mamba_decode steps, f32, stressed weights: "
              f"max |Δ| {err:.3g}, within rtol/atol 2e-3; the control (state zeroed between "
              f"chunks) max |Δ| {control_err:.3g}, fails it; 12a {time.perf_counter() - t0:.1f} s")
        del params, blk
        # 12b zamba2-1.2b
        t0 = time.perf_counter()
        cfg = configs.get_config("zamba2-1.2b")
        _published(cfg, ZAMBA_FULL, "zamba2-1.2b")
        prompts = TokenStream(cfg.vocab, FAM_PROMPT, FAM_BATCH, seed=3).batch(0)[0]
        params, cache = _recurrent_family(torch, rnd, cfg, 26, prompts, "12b zamba2-1.2b", smi)
        g, per = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
        tail = cfg.n_layers - g * per
        shapes = {k: tuple(v.shape) for k, v in (("shared.k", cache["shared"]["k"]),
                                                 ("mamba.ssm", cache["mamba"]["ssm"]),
                                                 ("mamba.conv", cache["mamba"]["conv"]),
                                                 ("mamba_tail.ssm", cache["mamba_tail"]["ssm"]))}
        want = {"shared.k": (g, FAM_BATCH, FAM_PROMPT + FAM_STEPS, 32, 64),
                "mamba.ssm": (g * per, FAM_BATCH, 64, 64, 64),
                "mamba.conv": (g * per, FAM_BATCH, 3, 2 * 2048 + 2 * 64),
                "mamba_tail.ssm": (tail, FAM_BATCH, 64, 64, 64)}
        check(shapes == want and tail == 2 and cache["mamba"]["ssm"].dtype == torch.float32,
              f"12b cache shapes {shapes}")
        print(f"[family] 12b cache: {g} groups of {per} Mamba layers and a tail of {tail}; "
              + ", ".join(f"{k} {list(v)}" for k, v in shapes.items())
              + f"; 12b {time.perf_counter() - t0:.1f} s")
        del params, cache
        torch.cuda.empty_cache()
        # 12c llama-3.2-vision-90b, depth cut
        t0 = time.perf_counter()
        shapes, hd = _vision(torch, rnd, da, fau, cu, msu, configs, vq, tf, smi)
        print(f"[family] 12c {time.perf_counter() - t0:.1f} s")
    launches = _read(counters)
    check(sum(plain.values()) == 0, f"plain distance functions ran on the card: {plain}")
    check(launches["B1"] > 0, f"phase 12 launched B1 no time: {launches}")
    print(f"[family] phase 12 launches {launches}; plain distance functions called 0 times")
    errs, cases = _vq_checks(torch, ref, da, cu, msu, shapes, hd, kernels=("B1",), phase="12c")
    print(f"[kernels] vlm cache shapes: B1 at each (rows, K) of 12c, d = {hd}, f32, matches its "
          f"plain version in {cases} cases (tol 1e-5; labels at the minimum, also with half the "
          f"candidates parked); max abs err B1 {errs['B1']:.3g}")
    # 12d: the lm driver for the recurrent archs, three processes at once
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for args in (["--arch", "mamba2-130m"], ["--arch", "zamba2-1.2b"],
                 ["--arch", "mamba2-130m", "--kv-quantize"]):
        argv = ["-m", "repro_torch.launch.serve", "--task", "lm", *args]
        runs[" ".join(argv)] = subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True)
    outs = {argv: _finish(p, 300) for argv, p in runs.items()}
    for argv, (out, err, rc) in outs.items():
        refused = argv.endswith("--kv-quantize")
        good = (rc != 0 and "ValueError: family 'ssm' has no per-layer KV cache stack to dump"
                in err) if refused else (rc == 0 and "[serve]" in out)
        check(good, f"python {argv}: exit {rc}\n{out[-3000:]}\n{err[-3000:]}")
        for line in (err.strip().splitlines()[-1:] if refused else out.splitlines()):
            print(f"[launch] {line}")
        print(f"[launch] python {argv}: exit {rc}"
              + (" (the reference's ValueError)" if refused else ""))
    print(f"[launch] 12d's three processes in {time.perf_counter() - t0:.1f} s, process start "
          f"included; phase 12 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches, errs


def _finish(proc, timeout):
    """(stdout, stderr, exit code) of ``proc``, killed past ``timeout`` s."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return out, err, proc.returncode


def _vision(torch, rnd, da, fau, cu, msu, configs, vq, tf, smi):
    """12c: llama-3.2-vision-90b at full width and ``VLM_LAYERS`` layers.
    Returns B1's launches by ``(kernel, rows, K)`` and the head dim."""
    from repro_torch.data import TokenStream

    cfg = configs.get_config("llama-3.2-vision-90b")
    full_layers = cfg.n_layers
    _published(cfg, VLM_FULL, "llama-3.2-vision-90b")
    cfg = cfg.replace(n_layers=VLM_LAYERS)
    kv, hd, g = cfg.n_kv_heads, cfg.hd, VLM_LAYERS // cfg.cross_attn_every
    n_self = g * (cfg.cross_attn_every - 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, rnd.key(27))
    gate = torch.Generator(device="cuda").manual_seed(28)
    for name in ("gate_attn", "gate_mlp"):
        params["cross_layers"][name] = torch.rand(g, generator=gate, device="cuda") + 0.5
    prompts = TokenStream(cfg.vocab, FAM_PROMPT, FAM_BATCH, seed=4).batch(0)[0]
    shape = (FAM_BATCH, cfg.n_image_tokens, cfg.d_model)
    images = rnd.normal(rnd.key(29), shape, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    n_values = sum(t.numel() for t in _tree_leaves(params))
    print(f"[family] 12c llama-3.2-vision-90b at full width (d {cfg.d_model}, {cfg.n_heads} heads, "
          f"kv {kv}, hd {hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_image_tokens} image "
          f"tokens), depth cut from {full_layers} to {VLM_LAYERS} ({g} groups of "
          f"{cfg.cross_attn_every - 1} self layers and a cross layer; the f32 tree of "
          f"{full_layers} layers is about 350 GB): {n_values / 1e9:.3f} G values, gates "
          f"{[round(float(v), 3) for v in params['cross_layers']['gate_attn']]} / "
          f"{[round(float(v), 3) for v in params['cross_layers']['gate_mlp']]}, initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        # prefill and 32 greedy decode steps (the reference serves a vlm
        # through prefill and decode: its generate takes no images)
        sc = FAM_PROMPT + FAM_STEPS
        tf.decode(cfg, params, tf.prefill(cfg, params, prompts[:, :16], images, max_seq_len=17)[1],
                  prompts[:, 0], 16)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = tf.prefill(cfg, params, prompts, images, max_seq_len=sc)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        first = torch.argmax(last, -1).to(torch.int32)
        token, state = first, cache
        for i in range(FAM_STEPS):
            logits, state = tf.decode(cfg, params, state, token, FAM_PROMPT + i)
            token = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(logits[:, :cfg.vocab]).all()) and int(token.max()) < cfg.vocab,
              "12c decode gave non-finite logits or tokens out of range")
        print(f"[family] 12c prefill [{FAM_BATCH}, {FAM_PROMPT}] with images then {FAM_STEPS} "
              f"greedy decode steps in {wall:.3f} s ({FAM_BATCH * (FAM_STEPS + 1) / wall:.1f} "
              f"tok/s; prefill {t_pre:.3f} s, {(wall - t_pre) / FAM_STEPS * 1e3:.1f} ms a decode "
              f"step); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({smi})")
        del state, logits
        # the teacher-forced check in bf16 and f32; other images in f32
        share, _ = _teacher_forced(torch, tf, cfg, params, prompts, images)
        check(share <= TF_SHARE_BF16, f"12c teacher-forced bf16: {share:.3g} > {TF_SHARE_BF16}")
        cfg32 = cfg.replace(dtype=torch.float32)
        share32, full32 = _teacher_forced(torch, tf, cfg32, params, prompts, images.float())
        check(share32 <= TF_SHARE_F32, f"12c teacher-forced f32: {share32:.3g} > {TF_SHARE_F32}")
        other = rnd.normal(rnd.key(30), shape, device="cuda")
        moved, _, _ = tf.forward(cfg32, params, prompts[:, :TF_AT + TF_STEPS], other)
        move = _share(torch, moved, full32, cfg.vocab)
        check(move > 100 * TF_SHARE_F32, f"12c other image embeddings moved the f32 logits by "
              f"{move:.3g} of max |logit|, not more than 100 × {TF_SHARE_F32}")
        print(f"[family] 12c teacher-forced (prefill {TF_AT}, then {TF_STEPS} decode steps, "
              f"against forward): bf16 {share:.3g} of max |logit| (limit {TF_SHARE_BF16}), f32 "
              f"{share32:.3g} (limit {TF_SHARE_F32}); other image embeddings move the f32 logits "
              f"by {move:.3g} of max |logit| (must exceed {100 * TF_SHARE_F32:.3g})")
        del full32, moved, other
        # the prefill cache through B1: a codebook of 256 of its own rows
        pick = torch.Generator(device="cuda").manual_seed(31)
        rows = FAM_BATCH * FAM_PROMPT * kv  # the filled slots' rows of a layer
        books = {}
        for kind in ("k", "v"):
            filled = cache[kind][:, :, :FAM_PROMPT].float().reshape(n_self, rows, hd)
            idx = torch.randperm(rows, generator=pick, device="cuda")[:VQ_K]
            books[kind] = filled[:, idx].cpu().numpy()
        cb = vq.KVCodebook(books["k"], books["v"])
        tally = _ShapeTally(da, fau, cu, msu)
        with tally.active():
            t0 = time.perf_counter()
            qcache = vq.quantize_cache(cb, cache)
            torch.cuda.synchronize()
            t_q = time.perf_counter() - t0
        check(qcache["k_codes"].shape == (n_self, FAM_BATCH, sc, kv)
              and qcache["k_codes"].dtype == torch.uint8
              and all(torch.equal(qcache[k], cache[k]) for k in ("xk", "xv", "slot_pos")),
              "12c quantize_cache: codes or the image K/V passed through wrong")
        deq = vq.dequantize_cache(cb, qcache, dtype=cfg.dtype)
        raw, _ = tf.decode(cfg, params, cache, first, FAM_PROMPT)
        quant, _ = tf.decode(cfg, params, deq, first, FAM_PROMPT)
        check(bool(torch.isfinite(quant[:, :cfg.vocab]).all()),
              "12c decode over the dequantised cache is not finite")
        agree = float((raw.argmax(-1) == quant.argmax(-1)).float().mean())
        print(f"[family] 12c quantize_cache over the prefill cache ({n_self} self layers, K and V "
              f"[{FAM_BATCH}, {sc}, {kv}, {hd}] a layer: {FAM_BATCH * sc * kv:,} rows) against "
              f"{VQ_K} of its own rows per layer and kind in {t_q:.3f} s, uint8 codes; xk/xv "
              f"{list(cache['xk'].shape)} bit-equal through it; one decode step over "
              f"dequantize_cache: finite, max |Δlogit| against the raw cache "
              f"{float((raw - quant)[:, :cfg.vocab].abs().max()):.3g} (max |logit| "
              f"{float(raw[:, :cfg.vocab].abs().max()):.3g}), argmax agreement {agree:.3f} (a "
              f"readout: {VQ_K} codes for {rows:,} rows); B1 by (rows, K): "
              + ", ".join(f"[{n}, {k}] {c}" for (b, n, k), c in sorted(tally.counts.items())))
        del cache, qcache, deq, raw, quant, params, images
        torch.cuda.empty_cache()
    return tally.counts, hd


def _tree_leaves(tree):
    for v in tree.values():
        yield from _tree_leaves(v) if isinstance(v, dict) else (v,)


# ---------------------------------------------------------------- phase 13
TRAIN_BATCH, TRAIN_SEQ = 2, 4096  # two attention chunks of 2,048: the flash path at full width
QWEN_FULL = dict(d_model=2560, n_heads=32, n_kv_heads=8, hd=128, d_ff=9728, vocab=151936,
                 vocab_padded=152064)
QWEN_LAYERS, QWEN_STEPS = 4, 5  # depth cut from 36: about 1.18 G parameters, 19 GB of f32 state
MOE_LAYERS, FAMILY_STEPS = 2, 3  # deepseek-moe-16b cut from 28 as in 11b; 13b/13c steps
TRAIN_LR = dict(lr=1e-3, warmup_steps=0)  # the same batch every step: the loss must fall
FLASH_SHARE = {"float32": 1e-4, "bfloat16": 1e-2}  # of max |g|: _Flash against masked_full
ACCUM_RTOL = 5e-3  # the loss of a grad_accum=2 step against grad_accum=1's, bf16
RESUME_ATOL = 1e-4  # 13d: a resume to 14 against the same schedule's uninterrupted run (f32)
SCHEDULE_ATOL = 2e-2  # 13d: the 12-step run's resume against the 14-step run's (other schedule)


def _flash_vs_dense(torch, layers, dtype, smi):
    """``_Flash``'s gradients at q [1, 4,096, 32, 128], k/v [1, 4,096, 8,
    128] against plain autograd through ``masked_full``, with each one's
    peak memory above its inputs. Returns the worst share of max |g|."""
    g = torch.Generator(device="cuda").manual_seed(130)
    s, h, kv, hd = TRAIN_SEQ, 32, 8, 128

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v = randn(1, s, h, hd), randn(1, s, kv, hd), randn(1, s, kv, hd)
    co = torch.randn(1, s, h, hd, generator=g, device="cuda")
    grads, peaks, times = {}, {}, {}
    for impl in ("block_causal", "masked_full"):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = layers.attention(*leaves, impl=impl, chunk=TRAIN_SEQ // 2)
        grads[impl] = torch.autograd.grad((out.float() * co).sum(), leaves)
        torch.cuda.synchronize()
        times[impl] = time.perf_counter() - t0
        peaks[impl] = torch.cuda.max_memory_allocated() - base
        del out, leaves
    worst = 0.0
    for name, a, b in zip("qkv", grads["block_causal"], grads["masked_full"]):
        check(a.dtype == dtype and bool(torch.isfinite(a).all()), f"13a flash d{name} {a.dtype}")
        worst = max(worst, float((a.float() - b.float()).abs().max() / b.float().abs().max()))
    what = str(dtype).removeprefix("torch.")
    check(worst <= FLASH_SHARE[what], f"13a flash gradients ({what}) against masked_full: "
          f"{worst:.3g} of max |g| > {FLASH_SHARE[what]}")
    print(f"[train] 13a _Flash forward + backward at q [1, {s:,}, {h}, {hd}], k/v [1, {s:,}, {kv}, "
          f"{hd}] ({what}, chunk {TRAIN_SEQ // 2:,}) against autograd through masked_full: dq/dk/dv "
          f"within {worst:.3g} of max |g| (limit {FLASH_SHARE[what]}); peak memory above the "
          f"inputs {peaks['block_causal'] / 2**30:.2f} GiB against {peaks['masked_full'] / 2**30:.2f}"
          f" GiB; {times['block_causal']:.3f} s against {times['masked_full']:.3f} s (first calls) "
          f"({smi})")


def _train_state(torch, ts, opt, cfg, seed):
    """``init_train_state`` on the card: (params, state, parameters, s)."""
    from repro_torch import random as rnd

    t0 = time.perf_counter()
    params, state = ts.init_train_state(cfg, rnd.key(seed))
    torch.cuda.synchronize()
    return params, state, sum(t.numel() for t in opt.leaves(params)), time.perf_counter() - t0


def _train_run(torch, ts, opt, cfg, params, state, tokens, steps, what, smi, on_first=None):
    """``steps`` AdamW steps of ``make_train_step(cfg)`` on one batch: the
    losses (finite, falling), seconds a step after the first, tokens/s and
    peak memory; ``on_first(state)`` checks the state after step 1.
    Returns (params, state, losses, the step function)."""
    step = ts.make_train_step(cfg, opt.AdamWConfig(**TRAIN_LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, tokens, tokens)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
              f"{what}: a non-finite loss or gradient norm at step {i + 1}: {m}")
        if i == 0 and on_first is not None:
            on_first(state)
    peak = torch.cuda.max_memory_allocated()
    check(losses[-1] < losses[0], f"{what}: the loss did not fall over {steps} steps: {losses}")
    n_tok = tokens.numel()
    per = sum(walls[1:]) / (steps - 1)
    print(f"[train] {what}: {steps} AdamW steps on one batch [{tokens.shape[0]}, "
          f"{tokens.shape[1]:,}] (lr {TRAIN_LR['lr']}, remat {cfg.remat}): losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; first step {walls[0]:.3f} s, then {per:.3f} s a step ({n_tok / per:,.0f} tokens/s);"
          f" peak device memory {peak / 2**30:.2f} GiB ({smi})")
    return params, state, losses, step


def _moved(torch, tree, what):
    """Each leaf of a first moment after step 1 (``(1 − b1)`` times the
    clipped gradient) is finite and not all zero."""
    from repro_torch.train import optimizer as opt

    for i, m in enumerate(opt.leaves(tree)):
        check(bool(torch.isfinite(m).all()) and float(m.abs().max()) > 0,
              f"{what}: leaf {i} {tuple(m.shape)} got no gradient")


def _train_drivers(tmp):
    """13d: ``python -m repro_torch.launch.train`` on granite-8b reduced:
    12 steps with a checkpoint every 6 beside an uninterrupted 14-step run
    (two processes at once), then each directory resumed to 14 (two more).
    Returns the four runs' losses."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = ["-m", "repro_torch.launch.train", "--arch", "granite-8b", "--reduced", "--batch", "2",
            "--seq", "64", "--ckpt-every", "6"]

    def run_all(runs):
        procs = {name: subprocess.Popen([sys.executable, *base, *args], cwd=ROOT, env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for name, args in runs.items()}
        out = {}
        for name, p in procs.items():
            stdout, err, rc = _finish(p, 240)
            check(rc == 0, f"13d python {' '.join(base + runs[name])}: exit {rc}\n"
                  f"{stdout[-2000:]}\n{err[-2000:]}")
            out[name] = json.loads(stdout.strip().splitlines()[-1])["losses"]
            resumed = "[train] resumed from step 12" in stdout
            check(resumed == name.endswith("+2"), f"13d {name}: resumed {resumed}\n{stdout}")
            print(f"[launch] python {' '.join(base + runs[name])}: exit 0, {len(out[name])} steps"
                  + (", resumed from step 12" if resumed else ""))
        return out

    a, b = str(pathlib.Path(tmp) / "a"), str(pathlib.Path(tmp) / "b")
    out = run_all({"12": ["--steps", "12", "--ckpt-dir", a], "14": ["--steps", "14", "--ckpt-dir", b]})
    out.update(run_all({"12+2": ["--steps", "14", "--ckpt-dir", a],
                        "14+2": ["--steps", "14", "--ckpt-dir", b]}))
    return out


def phase_train(torch, smi):
    """Phase 13: training at full width. 13a qwen3-4b cut to 4 layers (the
    flash gradients against masked_full, five AdamW steps with remat, a
    grad_accum=2 step against grad_accum=1), 13b zamba2-1.2b as published,
    13c deepseek-moe-16b cut to 2 layers, 13d the driver and its resume."""
    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.models import layers
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # the process's first torch.utils.checkpoint call imports torch._dynamo
    # (checkpoint is wrapped to disable it): a one-time cost, timed apart
    from torch.utils.checkpoint import checkpoint

    t0 = time.perf_counter()
    checkpoint(torch.square, torch.ones(1, device="cuda", requires_grad=True), use_reentrant=False)
    print(f"[train] the process's first torch.utils.checkpoint call: "
          f"{time.perf_counter() - t0:.3f} s (one-time)")
    # 13a qwen3-4b
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        _flash_vs_dense(torch, layers, dtype, smi)
    torch.cuda.empty_cache()
    cfg = configs.get_config("qwen3-4b")
    _published(cfg, QWEN_FULL, "qwen3-4b")
    cfg = cfg.replace(n_layers=QWEN_LAYERS)
    check(cfg.remat and cfg.attn_impl == "block_causal", f"13a: {cfg}")
    tokens = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=13).batch(0)[0]
    params, state, n_params, t_init = _train_state(torch, ts, opt, cfg, 130)
    params, state, _, step = _train_run(torch, ts, opt, cfg, params, state, tokens, QWEN_STEPS,
                                        f"13a qwen3-4b ({n_params / 1e9:.3f} G parameters, "
                                        f"{QWEN_LAYERS} of 36 layers, state made in {t_init:.2f} s)",
                                        smi)
    # a grad_accum=2 step from the same parameters: the loss and norm before the update
    twin = opt.tree_map(torch.clone, params)
    _, _, m2 = ts.make_train_step(cfg.replace(grad_accum=2), opt.AdamWConfig(**TRAIN_LR))(
        twin, opt.adamw_init(twin), tokens, tokens)
    del twin
    _, _, m1 = step(params, state, tokens, tokens)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    n1, n2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    check(abs(l2 - l1) <= ACCUM_RTOL * abs(l1), f"13a grad_accum=2 loss {l2} against {l1}")
    print(f"[train] 13a step {QWEN_STEPS + 1} with grad_accum=2 (two micro-batches of 1) against "
          f"grad_accum=1 from the same parameters: loss {l2:.6f} against {l1:.6f} (relative "
          f"{abs(l2 - l1) / abs(l1):.3g}, limit {ACCUM_RTOL}, bf16), gradient norm {n2:.6f} against "
          f"{n1:.6f}; 13a {time.perf_counter() - t0:.1f} s")
    del params, state, step, m1, m2
    torch.cuda.empty_cache()
    # 13b zamba2-1.2b as published
    t0 = time.perf_counter()
    cfg = configs.get_config("zamba2-1.2b")
    _published(cfg, ZAMBA_FULL, "zamba2-1.2b")
    tokens = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=14).batch(0)[0]
    params, state, n_params, t_init = _train_state(torch, ts, opt, cfg, 131)

    def shared_moved(state):  # after step 1, m = (1 − b1)·clip(g)
        _moved(torch, {k: state["m"][k] for k in ("shared_block", "shared_in")}, "13b shared block")
        _moved(torch, state["m"]["mamba_groups"], "13b Mamba layers")

    params, state, _, step = _train_run(torch, ts, opt, cfg, params, state, tokens, FAMILY_STEPS,
                                        f"13b zamba2-1.2b ({n_params / 1e9:.3f} G parameters, 38 "
                                        f"layers, state made in {t_init:.2f} s)", smi,
                                        on_first=shared_moved)
    print(f"[train] 13b every leaf of the shared block and of the Mamba layers got a finite, "
          f"non-zero gradient at step 1; 13b {time.perf_counter() - t0:.1f} s")
    del params, state, step
    torch.cuda.empty_cache()
    # 13c deepseek-moe-16b, depth cut
    t0 = time.perf_counter()
    cfg = configs.get_config(ROUTER_ARCH).replace(n_layers=MOE_LAYERS)
    tokens = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=15).batch(0)[0]
    params, state, n_params, t_init = _train_state(torch, ts, opt, cfg, 132)
    router = {}

    def router_moved(state):
        moe = state["m"]["layers"]["moe"]
        _moved(torch, {"router": moe["router"], "w1": moe["w1"]}, "13c router")
        router["max"] = float(moe["router"].abs().max()) / 0.1  # m = (1 − b1)·clip(g)

    params, state, _, step = _train_run(torch, ts, opt, cfg, params, state, tokens, FAMILY_STEPS,
                                        f"13c deepseek-moe-16b ({n_params / 1e9:.3f} G parameters, "
                                        f"{MOE_LAYERS} of 28 layers, state made in {t_init:.2f} s)",
                                        smi, on_first=router_moved)
    print(f"[train] 13c the router's gradient at step 1 finite and non-zero (max |g| after "
          f"clipping {router['max']:.3g}), the aux loss in the loss; 13c "
          f"{time.perf_counter() - t0:.1f} s")
    del params, state, step
    torch.cuda.empty_cache()
    # 13d the driver
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as tmp:
        runs = _train_drivers(tmp)
    # not gated: TokenStream draws a new emission table every step, so over 12
    # steps the loss of the reduced model barely moves from ln(256) and falls
    # for some seeds only, the reference's as well; 13a-13c gate the fall on
    # one fixed batch
    fell = runs["12"][-1] < runs["12"][0]
    check(all(map(math.isfinite, sum(runs.values(), []))), f"13d: a non-finite loss: {runs}")
    check(len(runs["12"]) == 12 and len(runs["14"]) == 14, f"13d step counts: {runs}")
    check(len(runs["12+2"]) == len(runs["14+2"]) == 2, f"13d resumes: {runs}")
    same = max(abs(a - b) for a, b in zip(runs["14+2"], runs["14"][12:]))
    other = max(abs(a - b) for a, b in zip(runs["12+2"], runs["14"][12:]))
    check(same <= RESUME_ATOL, f"13d: resume to 14 against the uninterrupted run: {same}")
    check(other <= SCHEDULE_ATOL, f"13d: the 12-step run resumed against 14 steps: {other}")
    print(f"[train] 13d the 12-step run's loss {runs['12'][0]:.4f} -> {runs['12'][-1]:.4f} "
          f"({'fell' if fell else 'did not fall'}; reported, not gated); its "
          f"resume to 14 against the uninterrupted 14-step run: largest loss difference "
          f"{other:.3g} (limit {SCHEDULE_ATOL}: its cosine schedule ran over 12 steps); the "
          f"14-step run's own checkpoint resumed to 14: {same:.3g} (limit {RESUME_ATOL}; "
          f"{'bit-equal' if same == 0 else 'not bit-equal'}, which is not gated); 13d "
          f"{time.perf_counter() - t0:.1f} s, four processes, two at a time")
    print(f"[train] phase 13 took {time.perf_counter() - t_phase:.1f} s ({smi})")


# ---------------------------------------------------------------- phase 14
#: 14a: one cell for each (family × kind), the family's cheapest arch at full
#: width and depth. The whole grid (``--all``) took 70–95 s of the phase
#: with 7 processes (PERF.md §6), past its 90 s budget on a slow host; the
#: vlm's prefill_32k alone takes 51–62 s of one core (80 self-attention
#: layers of 136 flash tiles each), so it runs at 10 of its 100 layers, as
#: phase 12 runs the vlm, as a tagged record of its own.
DRYRUN_CELLS = [(arch, shape) for arch in ("codeqwen1.5-7b", "deepseek-moe-16b", "mamba2-130m",
                                           "musicgen-medium", "llama-3.2-vision-90b",
                                           "zamba2-1.2b")
                for shape in ("train_4k", "prefill_32k", "decode_32k")
                if (arch, shape) != ("llama-3.2-vision-90b", "prefill_32k")]
DRYRUN_VLM_LAYERS = 10
DRYRUN_JOBS = 6  # 14a's worker processes; the vlm cell and 14b run beside them
DRYRUN_SECONDS = 240  # 14a's dry run past this fails the phase
GROUND_LAYERS = 2  # 14b's depth cut, at full width
GROUND_FLOP_RTOL = 1e-9
GROUND_PEAK_RATIO = (0.67, 1.5)  # peak_bytes_est over the card's measured peak


def _ground_cell(torch, dryrun, cfg, shape, what, smi):
    """14b: the dry run's trace of one cell at one rank against the same
    step run on the card: its FLOPs against ``FlopCounterMode``'s count of
    the card's step, and ``peak_bytes_est`` against
    ``max_memory_allocated`` above the memory allocated before the cell's
    parameters, state and inputs were made (the estimate counts them as
    arguments)."""
    from torch.utils.flop_counter import FlopCounterMode

    with dryrun.fake_mesh(1):
        rec = dryrun.trace_cell(cfg, shape)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        step, args, _ = dryrun.cell_step(cfg, shape, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            out = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        del out, args, step
    torch.cuda.empty_cache()
    flops = fc.get_total_flops()
    rel = abs(rec["flops"] - flops) / flops
    ratio = rec["memory"]["peak_bytes_est"] / peak
    check(rel <= GROUND_FLOP_RTOL, f"14b {what}: traced FLOPs {rec['flops']:.6e} against the "
          f"card's {flops:.6e} (relative {rel:.3g})")
    lo, hi = GROUND_PEAK_RATIO
    check(lo <= ratio <= hi, f"14b {what}: peak_bytes_est {rec['memory']['peak_bytes_est']:,} "
          f"over the card's peak {peak:,} is {ratio:.4f}, outside [{lo}, {hi}]")
    print(f"[dryrun] 14b {what}: FLOPs traced {rec['flops']:.6e}, on the card {flops:.6e} "
          f"(relative {rel:.3g}); peak_bytes_est {rec['memory']['peak_bytes_est'] / 2**30:.3f} "
          f"GiB (argument {rec['memory']['argument_bytes'] / 2**30:.3f}, temp "
          f"{rec['memory']['temp_bytes'] / 2**30:.3f}) against the card's "
          f"{peak / 2**30:.3f} GiB: ratio {ratio:.4f} (limit [{lo}, {hi}]); trace "
          f"{rec['trace_s']:.2f} s, the step on the card {wall:.2f} s ({smi})")


def phase_dryrun(torch, smi):
    """Phase 14: the dry run. 14a: ``python -m repro_torch.launch.dryrun
    --cell ... --jobs 6`` over :data:`DRYRUN_CELLS` on the 256-rank
    ``16x16`` mesh with no card visible, beside it the vlm's prefill at
    :data:`DRYRUN_VLM_LAYERS` layers, then the report's tables over the
    records; 14b, beside them, holds the trace at one rank against the
    same steps run on the card (qwen3-4b and deepseek-moe-16b at full
    width, 2 layers)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_RESULTS=out_dir,
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        cmds = [
            base + [f"--cell={a}:{s}" for a, s in DRYRUN_CELLS] + ["--jobs", str(DRYRUN_JOBS)],
            base + ["--arch", "llama-3.2-vision-90b", "--shape", "prefill_32k", "--set",
                    f"n_layers={DRYRUN_VLM_LAYERS}", "--tag", f"cut{DRYRUN_VLM_LAYERS}"],
        ]
        procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for c in cmds]
        try:
            # 14b
            qwen = configs.get_config("qwen3-4b").replace(n_layers=GROUND_LAYERS)
            moe = configs.get_config("deepseek-moe-16b").replace(n_layers=GROUND_LAYERS)
            check(qwen.remat, "14b: qwen3-4b trains with remat")
            ground = [
                (qwen, configs.Shape("train_1x4k", 4096, 1, "train"), "qwen3-4b train [1, 4,096]"),
                (qwen, configs.Shape("prefill_1x32k", 32768, 1, "prefill"),
                 "qwen3-4b prefill [1, 32,768]"),
                (qwen, configs.Shape("decode_8x32k", 32768, 8, "decode"),
                 "qwen3-4b decode [8] over a 32,768 cache"),
                (moe, configs.Shape("train_1x4k", 4096, 1, "train"),
                 "deepseek-moe-16b train [1, 4,096]"),
            ]
            t0 = time.perf_counter()
            for cfg, shape, what in ground:
                _ground_cell(torch, dryrun, cfg, shape, f"{what}, {GROUND_LAYERS} layers", smi)
            t_ground = time.perf_counter() - t0
        finally:
            runs = [_finish(p, max(1.0, DRYRUN_SECONDS - (time.perf_counter() - t_phase)))
                    for p in procs]
        t_grid = time.perf_counter() - t_phase
        for cmd, (out, err, rc) in zip(cmds, runs):
            check(rc == 0, f"14a {' '.join(cmd[1:])}: exit {rc}\n{out[-3000:]}\n{err[-3000:]}")
            for line in out.splitlines():
                if line.startswith("[dryrun]"):
                    print(line)
        recs = sorted(pathlib.Path(out_dir).glob("*/*.json"))
        check(len(recs) == len(DRYRUN_CELLS) + 1, f"14a: {len(recs)} records")
        for f in recs:
            rec = json.loads(f.read_text())
            check(rec["flops"] > 0 and rec["memory"]["peak_bytes_est"] > 0
                  and rec["chips"] == 256 and rec["mesh"] == "16x16" == f.parent.name,
                  f"14a {f.name}: {rec}")
        dry, roof, _ = report.build_tables(pathlib.Path(out_dir))
    for line in (dry + "\n" + roof).splitlines():
        if "N/A" not in line and "…" not in line:  # cells not traced here
            print(f"[dryrun] {line}")
    cut = [f"{a} × {s}" for a, s in configs.runnable_cells() if (a, s) not in DRYRUN_CELLS]
    print(f"[dryrun] 14a {len(DRYRUN_CELLS)} cells (one for each family and kind, the family's "
          f"cheapest arch) and llama-3.2-vision-90b × prefill_32k at {DRYRUN_VLM_LAYERS} of 100 "
          f"layers on the 256-rank meshes in {t_grid:.1f} s, {DRYRUN_JOBS} + 1 processes with no card "
          f"visible; cut to fit the phase: " + ", ".join(cut))
    print(f"[dryrun] phase 14 took {time.perf_counter() - t_phase:.1f} s (14b "
          f"{t_ground:.1f} s beside 14a) ({smi})")


# ---------------------------------------------------------------- phase 15
FSDP_WORLD = 2  # gloo ranks on the one card: correctness, not scaling
FSDP_LAYERS, FSDP_STEPS = 2, 2  # qwen3-4b cut from 36, remat on, bf16
FSDP_MOE_LAYERS = 1  # every deepseek-moe-16b layer is a MoE layer
FSDP_PROMPT, FSDP_DECODE = 512, 4  # 15b: prefill [2, 512], then 4 teacher-forced steps
FSDP_RANK_SECONDS = 180  # the parent's deadline for phase 15's ranks: a hang fails the phase
#: The one-rank run takes the ranks' rows as its micro-batches (grad_accum =
#: W), so it runs each rank's bf16 GEMMs at the rank's shapes, and what is left
#: between the two is the FSDP path's own arithmetic: the f32 sums over the
#: ranks, the norm over the shards, the embedding's gradient added over the
#: ranks at once. So the CPU tests' f32 tolerances (tests/test_torch_fsdp.py)
#: hold: the loss and the grad-norm within a relative 1e-5, the first moment
#: (0.1 × the clipped gradient) within 1e-4 of each leaf's max |m| and of its
#: L2 norm, the parameters after step 1 within 1e-6 + 1e-5 relative where that
#: moment is above the 1e-4 (elsewhere AdamW's first step moves a parameter by
#: up to lr either way; after step 2 the step-2 losses and norms compare them).
FSDP_RTOL = 1e-5
FSDP_MOMENT_TOL = 1e-4
FSDP_PARAM_TOL = (1e-6, 1e-5)  # atol, rtol
FSDP_CONTROL = 100  # the unreduced control must miss the norm and the moment by this factor
FSDP_RESIDENT_SLACK = 64 << 20  # bytes over 1/W of one rank's parameters and state


def _moment_miss(torch, got, want):
    """(relative L2 over the tree, worst share of a leaf's max |want|) of
    two lists of tensors."""
    num = den = share = 0.0
    for g, w in zip(got, want, strict=True):
        d = g.float() - w.float()
        num += float((d * d).sum())
        den += float((w.float() * w.float()).sum())
        share = max(share, float(d.abs().max() / w.float().abs().max().clamp_min(1e-30)))
    return math.sqrt(num / den), share


def _params_miss(torch, got, want, moment):
    """(how far past 1e-5 relative the parameters lie where ``moment`` is
    above its tolerance, their largest difference anywhere)."""
    inside = anywhere = 0.0
    for p, w, m in zip(got, want, moment, strict=True):
        signed = m.abs() > FSDP_MOMENT_TOL * m.abs().max()
        d = (p - w).abs()
        excess = (d - FSDP_PARAM_TOL[1] * w.abs())[signed]
        inside = max(inside, float(excess.max()) if excess.numel() else 0.0)
        anywhere = max(anywhere, float(d.max()))
    return inside, anywhere


def _fsdp_wait(torch, path: pathlib.Path, deadline: float):
    """The one-rank run's file ``path`` once it is there (mapped, on the
    host)."""
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"15: {path.name} never came")
        time.sleep(0.05)
    return torch.load(path, map_location="cpu", weights_only=False, mmap=True)


def _fsdp_save(torch, obj, path: pathlib.Path) -> None:
    """``torch.save`` to a temporary name, then renamed: a reader never
    sees half a file."""
    tmp = path.with_suffix(".part")
    torch.save(obj, tmp)
    os.rename(tmp, path)


def _fsdp_cases():
    """(config, parameter seed, token seed) of 15a/15b and of 15c."""
    from repro_torch import configs

    return ((configs.get_config("qwen3-4b").replace(n_layers=FSDP_LAYERS), 150, 13),
            (configs.get_config(ROUTER_ARCH).replace(n_layers=FSDP_MOE_LAYERS), 152, 15))


def _fsdp_tokens(cfg, seed, seq=TRAIN_SEQ):
    from repro_torch.data import TokenStream

    return TokenStream(cfg.vocab, seq, TRAIN_BATCH, seed=seed).batch(0)[0]


def _host_tree(tree):
    from repro_torch.train import optimizer as opt

    return opt.tree_map(lambda t: t.detach().cpu(), tree)


def _fsdp_rank(rank: int, world: int, init: str, tmp: str) -> None:
    """One rank of phase 15: a gloo group on the one card running the FSDP
    steps on its shards and rows. It compares its slices with the one-rank
    runs' files and saves what it saw to ``tmp/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import random as rnd
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import analysis
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    deadline = time.monotonic() + FSDP_RANK_SECONDS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    tmp = pathlib.Path(tmp)
    ocfg = opt.AdamWConfig(**TRAIN_LR)

    def model(cfg, seed):
        """(shards, placements, AdamW state, this rank's rows), the whole
        tree drawn on the card and dropped."""
        whole = tf.init_params(cfg, rnd.key(seed))
        psh = layouts.param_shardings(cfg, whole)
        shards = fsdp.shard_tree(whole, psh)
        del whole
        torch.cuda.empty_cache()
        tokens = _fsdp_tokens(cfg, seed_tokens[cfg.name])
        rows = fsdp.shard_tree({"tokens": tokens},
                               layouts.input_shardings(cfg, {"tokens": tokens}))["tokens"]
        return shards, psh, opt.adamw_init(shards), rows

    def mine(tree, psh):
        """This rank's slices of a whole host tree, on the card, in leaf order."""
        return [t.cuda() for t in opt.leaves(fsdp.shard_tree(tree, psh))]

    (qwen, q_seed, q_tok), (moe, m_seed, m_tok) = _fsdp_cases()
    seed_tokens = {qwen.name: q_tok, moe.name: m_tok}
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    out: dict = {"rank": rank}
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=(sh.DATA,))
        # the one-rank run's file; its process has freed the card's memory by then
        one = _fsdp_wait(torch, tmp / "one_rank_a.pt", deadline)
        with sh.use_mesh(mesh):
            # the control: each rank's gradient left unreduced (its own slice of its own rows')
            params, psh, state, rows = model(qwen, q_seed)
            step = ts.make_train_step(qwen, ocfg, param_shardings=psh)
            m1 = mine(one["m1"], psh)
            own = fsdp._reduce_scatter_mean
            fsdp._reduce_scatter_mean = lambda g, d: g.narrow(
                d, sh._mesh_rank() * (g.shape[d] // world), g.shape[d] // world).clone()
            try:
                _, state, m = step(params, state, rows, rows)
            finally:
                fsdp._reduce_scatter_mean = own
            out["control_norm"] = float(m["grad_norm"])
            out["control_m1"] = _moment_miss(torch, list(opt.leaves(state["m"])), m1)
            del params, state
            torch.cuda.empty_cache()
            # 15a
            base = torch.cuda.memory_allocated()
            params, psh, state, rows = model(qwen, q_seed)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out["loss"], out["grad_norm"], out["step_s"] = [], [], []
            for i in range(FSDP_STEPS):
                analysis.collective_bytes(reset=True)
                t0 = time.perf_counter()
                params, state, m = step(params, state, rows, rows)
                torch.cuda.synchronize()
                out["step_s"].append(time.perf_counter() - t0)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
                if i == 0:
                    out["counts"] = analysis.collective_bytes(reset=True)
                    out["resident"] = torch.cuda.memory_allocated() - base
                    out["m1"] = _moment_miss(torch, list(opt.leaves(state["m"])), m1)
                    out["params"] = _params_miss(torch, opt.leaves(params), mine(one["p1"], psh),
                                                 m1)
                    del m1
            out["peak"] = torch.cuda.max_memory_allocated() - base
            del state
            # 15b: the same shards serve, teacher-forced on the one-rank run's greedy tokens
            greedy = one["greedy"].cuda()  # [FSDP_DECODE, 2]
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, cache = tf.prefill(qwen, params, rows[:, :FSDP_PROMPT],
                                           max_seq_len=FSDP_PROMPT + FSDP_DECODE,
                                           param_shardings=psh)
                out["logits"] = [logits.float().cpu()]
                for i in range(FSDP_DECODE):
                    logits, cache = tf.decode(qwen, params, cache, greedy[i, rank:rank + 1],
                                              FSDP_PROMPT + i, param_shardings=psh)
                    out["logits"].append(logits.float().cpu())
            torch.cuda.synchronize()
            out["serve_s"] = time.perf_counter() - t0
            del params, cache, one, logits
            torch.cuda.empty_cache()
            # 15c
            params, psh, state, rows = model(moe, m_seed)
            t0 = time.perf_counter()
            params, state, m = ts.make_train_step(moe, ocfg, param_shardings=psh)(
                params, state, rows, rows)
            torch.cuda.synchronize()
            out["moe_s"] = time.perf_counter() - t0
            out["moe_loss"], out["moe_norm"] = float(m["loss"]), float(m["grad_norm"])
            del params
            emu = _fsdp_wait(torch, tmp / "one_rank_c.pt", deadline)
            out["moe_m1"] = _moment_miss(torch, list(opt.leaves(state["m"])),
                                         mine(emu["m1"], psh))
        _fsdp_save(torch, out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _fsdp_join(torch, ctx, tmp: pathlib.Path, deadline: float) -> list[dict]:
    """Phase 15's ranks joined by ``deadline``: a hang or a rank's failure
    fails the phase, and every rank is stopped."""
    import torch.multiprocessing as mp

    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"15: the {FSDP_WORLD} ranks did not finish in {FSDP_RANK_SECONDS} s")
    except mp.ProcessRaisedException as e:
        raise SmokeFailure(f"15: a rank failed:\n{e}") from e
    except mp.ProcessExitedException as e:
        raise SmokeFailure(f"15: a rank exited: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(FSDP_WORLD)]


def _one_rank(torch, cfg, seed, token_seed, steps, path: pathlib.Path, serve=False,
              accum=FSDP_WORLD, seq=TRAIN_SEQ, session=FSDP_PROMPT + FSDP_DECODE) -> dict:
    """The W-rank step's semantics at one rank, no mesh: ``steps`` steps of
    ``make_train_step(cfg)`` with the ranks' rows as its ``accum``
    micro-batches (each row apart: its own MoE capacity and load-balance
    term; the losses and gradients averaged), then with ``serve`` a prefill
    and greedy decode in a cache sized for ``session`` positions. What the ranks compare with (the first moment and the
    parameters after step 1, the greedy tokens) goes to ``path`` once the
    card's memory is freed."""
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    tokens = _fsdp_tokens(cfg, token_seed, seq)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, state, n_params, _ = _train_state(torch, ts, opt, cfg, seed)
    step = ts.make_train_step(cfg.replace(grad_accum=accum), opt.AdamWConfig(**TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()
    out: dict = {"loss": [], "grad_norm": [], "step_s": [], "n_params": n_params}
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, tokens, tokens)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["resident"] = torch.cuda.memory_allocated() - base
            saved = {"m1": _host_tree(state["m"]), "p1": _host_tree(params)}
    out["peak"] = torch.cuda.max_memory_allocated() - base
    del state
    if serve:
        greedy, out["logits"] = [], []
        with torch.no_grad():
            last, cache = tf.prefill(cfg, params, tokens[:, :FSDP_PROMPT], max_seq_len=session)
            for i in range(FSDP_DECODE + 1):
                out["logits"].append(last.float().cpu())
                if i == FSDP_DECODE:
                    break
                greedy.append(torch.argmax(last[:, :cfg.vocab], -1).to(torch.int32))
                last, cache = tf.decode(cfg, params, cache, greedy[-1], FSDP_PROMPT + i)
        saved["greedy"] = torch.stack(greedy).cpu()
        del cache, last, greedy
    del params, step
    torch.cuda.empty_cache()  # before the file: the ranks start on it
    _fsdp_save(torch, saved, path)
    return out


def phase_fsdp(torch, smi):
    """Phase 15: the FSDP step on two gloo ranks on the one card. 15a
    qwen3-4b at full width (2 layers, bf16, remat) trained two steps
    against the same steps at one rank (loss, grad-norm, first moment,
    parameters; an unreduced control; the collectives against the dry
    run's rule; resident bytes), 15b the same shards serving, 15c
    deepseek-moe-16b (1 layer) against a one-rank emulation of the W-rank
    semantics."""
    import torch.multiprocessing as mp

    from repro_torch import configs
    from repro_torch import random as rnd
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    (qwen, q_seed, q_tok), (moe, m_seed, m_tok) = _fsdp_cases()
    _published(qwen, QWEN_FULL, "qwen3-4b")
    check(qwen.remat and qwen.dtype == torch.bfloat16, f"15a: {qwen}")
    with tempfile.TemporaryDirectory(prefix="fsdp_") as tmp:
        tmp = pathlib.Path(tmp)
        ctx = mp.start_processes(_fsdp_rank, args=(FSDP_WORLD, f"file://{tmp}/rendezvous",
                                                   str(tmp)),
                                 nprocs=FSDP_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + FSDP_RANK_SECONDS
        try:
            one = _one_rank(torch, qwen, q_seed, q_tok, FSDP_STEPS, tmp / "one_rank_a.pt",
                            serve=True)
            with dryrun.fake_mesh(FSDP_WORLD):  # the dry run's record of the same cell
                rec = dryrun.trace_cell(qwen, configs.Shape("train_2x4k", TRAIN_SEQ,
                                                            TRAIN_BATCH, "train"))
                whole = transformer.init_params(qwen, rnd.key(0), device="meta")
                psh = layouts.param_shardings(qwen, whole)
            emu = _one_rank(torch, moe, m_seed, m_tok, 1, tmp / "one_rank_c.pt")
        except BaseException:
            for p in ctx.processes:
                p.terminate()
            raise
        ranks = _fsdp_join(torch, ctx, tmp, deadline)
    replicated = sum(t.numel() * 4 * 3 for t, p in zip(opt.leaves(whole), opt.leaves(psh))
                     if fsdp.batch_dim(p) is None)  # parameters, m and v
    lr = TRAIN_LR["lr"]
    failures = []

    def gate(ok, what):
        if not ok:
            failures.append(what)

    def rel(a, b):
        return abs(a - b) / abs(b)

    # 15a
    for r in ranks:
        k = r["rank"]
        loss_rel = max(rel(a, b) for a, b in zip(r["loss"], one["loss"]))
        norm_rel = max(rel(a, b) for a, b in zip(r["grad_norm"], one["grad_norm"]))
        l2, share = r["m1"]
        c_l2, _ = r["control_m1"]
        c_norm = rel(r["control_norm"], one["grad_norm"][0])
        inside, anywhere = r["params"]
        limit = one["resident"] / FSDP_WORLD + replicated + FSDP_RESIDENT_SLACK
        est = rec["memory"]["peak_bytes_est"]
        print(f"[fsdp] 15a rank {k} of {FSDP_WORLD}: qwen3-4b ({FSDP_LAYERS} of 36 layers, bf16, "
              f"remat) {FSDP_STEPS} FSDP steps on its row of [{TRAIN_BATCH}, {TRAIN_SEQ:,}] "
              f"against one rank's on the same two rows as micro-batches: losses "
              + ", ".join(f"{x:.6f}" for x in r["loss"]) + " against "
              + ", ".join(f"{x:.6f}" for x in one["loss"])
              + f", grad-norms " + ", ".join(f"{x:.6f}" for x in r["grad_norm"]) + " against "
              + ", ".join(f"{x:.6f}" for x in one["grad_norm"])
              + f" (relative {loss_rel:.3g} and {norm_rel:.3g}, limit {FSDP_RTOL}); the first "
              f"moment within a relative L2 of {l2:.3g} and a leaf's share {share:.3g} (limit "
              f"{FSDP_MOMENT_TOL}); the parameters after step 1 past {FSDP_PARAM_TOL[1]} "
              f"relative by {inside:.3g} where the moment is signed (limit "
              f"{FSDP_PARAM_TOL[0]}), {anywhere:.3g} apart anywhere (limit {2 * lr}); seconds "
              f"a step "
              + ", ".join(f"{x:.3f}" for x in r["step_s"]) + " against one rank's "
              + ", ".join(f"{x:.3f}" for x in one["step_s"]) + f" ({smi})")
        print(f"[fsdp] 15a rank {k} control, its gradient left unreduced: grad-norm "
              f"{r['control_norm']:.6f} misses by {c_norm:.3g} ({c_norm / FSDP_RTOL:.0f}× the "
              f"limit), the first moment by a relative L2 of {c_l2:.3g} "
              f"({c_l2 / FSDP_MOMENT_TOL:.0f}× the limit; each must be ≥ {FSDP_CONTROL}×) "
              f"({smi})")
        print(f"[fsdp] 15a rank {k}: collectives of step 1 {r['counts']}, the dry run's rule "
              f"for the cell at W = {FSDP_WORLD} {rec['collectives']}; resident bytes after step "
              f"1 {r['resident']:,} against one rank's {one['resident']:,} (limit {limit:,.0f}: "
              f"1/{FSDP_WORLD} + the replicated leaves' {replicated:,} + "
              f"{FSDP_RESIDENT_SLACK:,}); peak {r['peak'] / 2**30:.3f} GiB against the dry "
              f"run's peak_bytes_est {est / 2**30:.3f} GiB: ratio {r['peak'] / est:.4f} (one "
              f"rank's peak {one['peak'] / 2**30:.3f} GiB) ({smi})")
        gate(loss_rel <= FSDP_RTOL and norm_rel <= FSDP_RTOL,
             f"15a rank {k} loss {r['loss']}, grad-norm {r['grad_norm']} against "
             f"{one['loss']}, {one['grad_norm']}")
        gate(l2 <= FSDP_MOMENT_TOL and share <= FSDP_MOMENT_TOL,
             f"15a rank {k} first moment {l2}, {share}")
        gate(inside <= FSDP_PARAM_TOL[0] and anywhere <= 2 * lr + FSDP_PARAM_TOL[0],
             f"15a rank {k} parameters {inside}, {anywhere}")
        gate(c_norm >= FSDP_CONTROL * FSDP_RTOL and c_l2 >= FSDP_CONTROL * FSDP_MOMENT_TOL,
             f"15a rank {k} control missed by {c_norm}, {c_l2} only")
        gate(r["counts"] == rec["collectives"], f"15a rank {k} collectives {r['counts']}")
        gate(r["resident"] <= limit, f"15a rank {k} resident {r['resident']:,} > {limit:,.0f}")
    # 15b
    worst = max(_share(torch, torch.cat([r["logits"][i] for r in ranks]), one["logits"][i],
                       qwen.vocab) for i in range(FSDP_DECODE + 1))
    print(f"[fsdp] 15b the same shards serve: prefill [{TRAIN_BATCH}, {FSDP_PROMPT}] (a row a "
          f"rank) and {FSDP_DECODE} decode steps teacher-forced on one rank's greedy tokens: "
          f"logits within {worst:.3g} of max |logit| of one rank's (limit {TF_SHARE_BF16}, bf16 "
          f"at other shapes); seconds " + ", ".join(f"{r['serve_s']:.3f}" for r in ranks)
          + f" ({smi})")
    gate(worst <= TF_SHARE_BF16, f"15b logits {worst}")
    # 15c
    for r in ranks:
        lrel, nrel = rel(r["moe_loss"], emu["loss"][0]), rel(r["moe_norm"], emu["grad_norm"][0])
        l2, share = r["moe_m1"]
        print(f"[fsdp] 15c rank {r['rank']}: deepseek-moe-16b ({FSDP_MOE_LAYERS} of 28 layers, "
              f"{moe.n_experts} experts, capacity from the rank's tokens) one FSDP step against "
              f"one rank running each rank's row apart: loss {r['moe_loss']:.6f} against "
              f"{emu['loss'][0]:.6f} (relative {lrel:.3g}), grad-norm {r['moe_norm']:.6f} "
              f"against {emu['grad_norm'][0]:.6f} (relative {nrel:.3g}; limit {FSDP_RTOL}), "
              f"the first moment within a relative L2 of {l2:.3g} and a leaf's share "
              f"{share:.3g} (limit {FSDP_MOMENT_TOL}); {r['moe_s']:.3f} s against "
              f"{emu['step_s'][0]:.3f} s ({smi})")
        gate(max(lrel, nrel) <= FSDP_RTOL and max(l2, share) <= FSDP_MOMENT_TOL,
             f"15c rank {r['rank']}: {lrel}, {nrel}, {l2}, {share}")
    print(f"[fsdp] phase 15 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    check(not failures, "; ".join(failures))


# ---------------------------------------------------------------- phase 16
TP_MESH = (1, 2)  # ("data", "model"): two gloo ranks on the one card, one data rank
TP_STEPS = 2  # qwen3-4b at FSDP_LAYERS of 36 layers, f32, remat, [2, 4,096] a step
TP_RANK_SECONDS = 300  # the parent's deadline for phase 16's ranks: a hang fails the phase
#: 16a holds the ranks' steps against one rank's on the same batch with
#: phase 15's tolerances (FSDP_RTOL, FSDP_MOMENT_TOL, FSDP_PARAM_TOL), in f32
#: activations: the model axis splits the GEMMs' columns and their reduction
#: dimension, so in bf16 each product rounds at other shapes and points than
#: one rank's (the first moment a relative L2 of 2.1e-3 apart in bf16, as
#: phase 15 found for GEMMs over other row counts); in f32 what is left is the
#: f32 order of the sums. The control leaves the row-parallel partials
#: unreduced and must miss by FSDP_CONTROL times. 16b holds deepseek-moe-16b's
#: ep island (bf16; 64 experts, 32 a rank) against the local MoE on each
#: rank's own tokens, within TF_SHARE_BF16 of max |y| (the shared experts' f32
#: sums and the experts' GEMMs over both ranks' tokens at once).


#: 16a's parameter gate holds where AdamW's first step is the gradient's sign:
#: lr·ĝ/(|ĝ| + eps) moves with |ĝ| only near eps, where a gradient of
#: cancelling terms (the head's columns no label names, about 1e-8) carries
#: f32 order errors of a few percent; from |ĝ| ≥ 100·eps such an error moves
#: the step by under 1e-6 of lr
TP_SIGN_FLOOR = 100 * 1e-8


def _params_miss_tp(torch, got, want, moment):
    """:func:`_params_miss` where the moment's ĝ = m / (1 − b1) is also past
    TP_SIGN_FLOOR, beside phase 15's reading: (inside, anywhere, inside by
    phase 15's mask, ĝ at its worst element)."""
    inside = anywhere = inside15 = 0.0
    g15 = 0.0
    for p, w, m in zip(got, want, moment, strict=True):
        g = m.abs() / 0.1  # AdamW's b1 = 0.9: m = 0.1 · ĝ after step 1
        signed = m.abs() > FSDP_MOMENT_TOL * m.abs().max()
        d = (p - w).abs()
        excess = d - FSDP_PARAM_TOL[1] * w.abs()
        if signed.any():
            e15 = excess.masked_fill(~signed, -1.0)
            i = int(e15.argmax())
            if float(e15.reshape(-1)[i]) > inside15:
                inside15, g15 = float(e15.reshape(-1)[i]), float(g.reshape(-1)[i])
        sure = signed & (g >= TP_SIGN_FLOOR)
        if sure.any():
            inside = max(inside, float(excess[sure].max()))
        anywhere = max(anywhere, float(d.max()))
    return inside, anywhere, inside15, g15


#: 16c-16e: the other families at full width, their depth cut, in f32 as 16a,
#: two steps on [TRAIN_BATCH, TP_FAMILY_SEQ] against one rank's with 16a's
#: checks, then serving: (part, arch, layers, parameter seed, token seed).
#: zamba2-1.2b's 6 layers are one group and the shared block.
TP_FAMILIES = (("16c", "mamba2-130m", 4, 160, 30), ("16d", "zamba2-1.2b", 6, 161, 31),
               ("16e", "musicgen-medium", 2, 162, 32))
TP_FAMILY_SEQ = 2048
#: the serving session of each part that trains: 16e's one slot longer than
#: the others', an odd count of slots that the two model ranks do not split,
#: so each rank holds that cache whole and decode attends over all of it
#: with no combine of partial softmaxes
TP_SESSION = {"16e": FSDP_PROMPT + FSDP_DECODE + 1}


def _tp_session(part: str) -> int:
    return TP_SESSION.get(part, FSDP_PROMPT + FSDP_DECODE)


def _tp_held(part: str) -> int:
    """The cache slots a model rank holds in ``part``'s session: its half,
    or all of them where the two ranks do not split them."""
    sc = _tp_session(part)
    return sc if sc % TP_MESH[1] else sc // TP_MESH[1]
#: 16f: llama-3.2-vision-90b at 5 of its 100 layers (4 self layers, 1 cross
#: layer), bf16, serving only, with bf16 image embeddings
TP_VLM = ("16f", "llama-3.2-vision-90b", 5, 163, 33)


def _tp_cases():
    """(part, config, parameter seed, token seed, sequence) of the parts
    that train: 16a (phase 15's qwen3-4b in f32 activations) and 16c-16e;
    and 16b's (phase 15's deepseek-moe-16b)."""
    import torch

    from repro_torch import configs

    (qwen, q_seed, q_tok), moe = _fsdp_cases()
    parts = [("16a", qwen.replace(dtype=torch.float32), q_seed, q_tok, TRAIN_SEQ)]
    for part, arch, layers, seed, tok in TP_FAMILIES:
        cfg = configs.get_config(arch).replace(n_layers=layers, dtype=torch.float32)
        parts.append((part, cfg, seed, tok, TP_FAMILY_SEQ))
    return parts, moe


def _tp_vlm():
    """16f's (config, parameter seed, token seed)."""
    from repro_torch import configs

    _, arch, layers, seed, tok = TP_VLM
    return configs.get_config(arch).replace(n_layers=layers), seed, tok


def _vlm_images(torch, cfg, seed):
    """16f's bf16 image embeddings [TRAIN_BATCH, T_img, D], drawn on the card."""
    from repro_torch import random as rnd

    return rnd.normal(rnd.key(seed), (TRAIN_BATCH, cfg.n_image_tokens, cfg.d_model),
                      device="cuda").to(torch.bfloat16)


def _one_rank_vlm(torch, path: pathlib.Path) -> float:
    """16f at one rank: prefill [TRAIN_BATCH, FSDP_PROMPT] with the image
    embeddings and FSDP_DECODE greedy steps. The logits and the greedy
    tokens go to ``path`` once the tree is freed; returns the seconds."""
    from repro_torch import random as rnd
    from repro_torch.models import transformer as tf

    cfg, seed, tok = _tp_vlm()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, rnd.key(seed))
    prompt = _fsdp_tokens(cfg, tok, FSDP_PROMPT)
    saved: dict = {"logits": [], "greedy": []}
    with torch.no_grad():
        last, cache = tf.prefill(cfg, params, prompt, _vlm_images(torch, cfg, tok + 1),
                                 max_seq_len=FSDP_PROMPT + FSDP_DECODE)
        for i in range(FSDP_DECODE + 1):
            saved["logits"].append(last.float().cpu())
            if i == FSDP_DECODE:
                break
            saved["greedy"].append(torch.argmax(last[:, :cfg.vocab], -1).to(torch.int32))
            last, cache = tf.decode(cfg, params, cache, saved["greedy"][-1], FSDP_PROMPT + i)
    saved["greedy"] = torch.stack(saved["greedy"]).cpu()
    del params, cache, last
    torch.cuda.empty_cache()
    _fsdp_save(torch, saved, path)
    return time.perf_counter() - t0


def _tp_rank(rank: int, world: int, init: str, tmp: str) -> None:
    """One rank of phase 16: a gloo group on the one card as a ``("data",
    "model")`` mesh of TP_MESH, running the model axis's steps on its
    shards and sequence part. It compares its slices with the one-rank
    runs' files and saves what it saw to ``tmp/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import random as rnd
    from repro_torch.distributed import fsdp, tp
    from repro_torch.distributed import params as layouts
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import analysis
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    deadline = time.monotonic() + TP_RANK_SECONDS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    tmp = pathlib.Path(tmp)
    ocfg = opt.AdamWConfig(**TRAIN_LR)
    parts, (moe, m_seed, m_tok) = _tp_cases()

    def model(cfg, seed, tok_seed, keep=None, seq=TRAIN_SEQ):
        """(shards, placements, AdamW state, the batch, ``keep`` of the whole
        tree): drawn on the card and dropped."""
        whole = tf.init_params(cfg, rnd.key(seed))
        psh = layouts.param_shardings(cfg, whole)
        shards = fsdp.shard_tree(whole, psh)
        kept = keep(whole) if keep else None
        del whole
        torch.cuda.empty_cache()
        return shards, psh, opt.adamw_init(shards), _fsdp_tokens(cfg, tok_seed, seq), kept

    def mine(tree, psh):
        return [t.cuda() for t in opt.leaves(fsdp.shard_tree(tree, psh))]

    def train_and_serve(part, cfg, seed, tok_seed, seq) -> dict:
        """A part's control step, its TP_STEPS steps against the one-rank
        run's file and the same shards serving."""
        t_part = time.perf_counter()
        one = _fsdp_wait(torch, tmp / f"one_rank_{part}.pt", deadline)
        got: dict = {}
        # the control: the row-parallel partials left unreduced over "model"
        params, psh, state, rows, _ = model(cfg, seed, tok_seed, seq=seq)
        step = ts.make_train_step(cfg, ocfg, param_shardings=psh)
        real = tf._to_residual
        tf._to_residual = lambda partial, par, dtype: (
            tp._part(partial, 1) if par.seq else partial).to(dtype)
        try:
            _, state, m = step(params, state, rows, rows)
        finally:
            tf._to_residual = real
        got["control"] = (float(m["loss"]), float(m["grad_norm"]))
        del params, state
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params, psh, state, rows, _ = model(cfg, seed, tok_seed, seq=seq)
        m1 = mine(one["m1"], psh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got["loss"], got["grad_norm"], got["step_s"] = [], [], []
        for i in range(TP_STEPS):
            analysis.collective_bytes(reset=True)
            t0 = time.perf_counter()
            params, state, m = step(params, state, rows, rows)
            torch.cuda.synchronize()
            got["step_s"].append(time.perf_counter() - t0)
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
            if i == 0:
                got["counts"] = analysis.collective_bytes(reset=True)
                got["resident"] = torch.cuda.memory_allocated() - base
                got["m1"] = _moment_miss(torch, list(opt.leaves(state["m"])), m1)
                got["params"] = _params_miss_tp(torch, opt.leaves(params),
                                                mine(one["p1"], psh), m1)
                del m1
        got["peak"] = torch.cuda.max_memory_allocated() - base
        del state
        # the same shards serve, teacher-forced on the one-rank run's greedy tokens
        greedy = one["greedy"].cuda()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = tf.prefill(cfg, params, rows[:, :FSDP_PROMPT],
                                       max_seq_len=_tp_session(part), param_shardings=psh)
            got["logits"] = [logits.float().cpu()]
            for i in range(FSDP_DECODE):
                logits, cache = tf.decode(cfg, params, cache, greedy[i], FSDP_PROMPT + i,
                                          param_shardings=psh, max_seq_len=_tp_session(part))
                got["logits"].append(logits.float().cpu())
        torch.cuda.synchronize()
        got["serve_s"] = time.perf_counter() - t0
        got["slots"] = int(cache["slot_pos"].shape[1]) if "slot_pos" in cache else None
        del params, cache, one, logits
        torch.cuda.empty_cache()
        got["s"] = time.perf_counter() - t_part
        return got

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    out: dict = {"rank": rank, "parts": {}}
    try:
        mesh = init_device_mesh("cuda", TP_MESH, mesh_dim_names=("data", "model"))
        with sh.use_mesh(mesh):
            part, cfg, seed, tok, seq = parts[0]
            out["parts"][part] = train_and_serve(part, cfg, seed, tok, seq)  # 16a
            # 16b: the ep island against the local MoE on the rank's own tokens
            t_part = time.perf_counter()
            params, psh, state, rows, first = model(
                moe, m_seed, m_tok, keep=lambda w: opt.tree_map(
                    lambda t: t.clone(), tf.layer(w["layers"], 0)["moe"]))
            seen = []
            real_moe = moe_mod.moe_ffn

            def spy(cfg, p, x, par=None):
                y, aux = real_moe(cfg, p, x, par)
                if par is not None and not seen:
                    seen.append((x.detach().clone(), y.detach().clone(), par))
                return y, aux

            moe_mod.moe_ffn = spy
            try:
                t0 = time.perf_counter()
                _, _, m = ts.make_train_step(moe, ocfg, param_shardings=psh)(params, state, rows,
                                                                              rows)
                torch.cuda.synchronize()
                out["moe_s"] = time.perf_counter() - t0
            finally:
                moe_mod.moe_ffn = real_moe
            del params, state
            x, y, par = seen[0]
            with torch.no_grad():
                want, _ = real_moe(moe, first, x)
            out["moe"] = {"loss": float(m["loss"]), "mode": moe_mod.moe_mode(moe.n_experts, par.m),
                          "tokens": int(x.shape[0] * x.shape[1]),
                          "share": float((y.float() - want.float()).abs().max()
                                         / want.float().abs().max()),
                          "s": time.perf_counter() - t_part}
            del x, y, first, want, seen
            torch.cuda.empty_cache()
            for part, cfg, seed, tok, seq in parts[1:]:  # 16c-16e
                out["parts"][part] = train_and_serve(part, cfg, seed, tok, seq)
            # 16f: the vlm serves; the ranks draw the whole tree one at a time
            t_part = time.perf_counter()
            one = _fsdp_wait(torch, tmp / "one_rank_16f.pt", deadline)
            vcfg, vseed, vtok = _tp_vlm()
            for r in range(world):
                if r == rank:
                    whole = tf.init_params(vcfg, rnd.key(vseed))
                    psh = layouts.param_shardings(vcfg, whole)
                    params = fsdp.shard_tree(whole, psh)
                    del whole
                    torch.cuda.empty_cache()
                dist.barrier()
            prompt = _fsdp_tokens(vcfg, vtok, FSDP_PROMPT)
            greedy = one["greedy"].cuda()
            logits_seen = []
            with torch.no_grad():
                logits, cache = tf.prefill(vcfg, params, prompt, _vlm_images(torch, vcfg, vtok + 1),
                                           max_seq_len=FSDP_PROMPT + FSDP_DECODE,
                                           param_shardings=psh)
                logits_seen.append(logits.float().cpu())
                for i in range(FSDP_DECODE):
                    logits, cache = tf.decode(vcfg, params, cache, greedy[i], FSDP_PROMPT + i,
                                              param_shardings=psh,
                                              max_seq_len=FSDP_PROMPT + FSDP_DECODE)
                    logits_seen.append(logits.float().cpu())
            out["vlm"] = {"logits": logits_seen, "slots": int(cache["slot_pos"].shape[1]),
                          "image_kv": tuple(cache["xk"].shape), "s": time.perf_counter() - t_part}
            del params, cache, logits
            torch.cuda.empty_cache()
        _fsdp_save(torch, out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_tp(torch, smi):
    """Phase 16: the model axis on two gloo ranks on the one card, a
    ``("data", "model")`` mesh of TP_MESH. 16a qwen3-4b at full width
    (2 layers, f32, remat) trained two steps against the same steps at one
    rank (loss, grad-norm, first moment, parameters; an unreduced control;
    the collectives against the dry run's rule; resident bytes and peak),
    the same shards serving; 16b deepseek-moe-16b (1 layer, bf16) in its ``ep``
    island against the local MoE on each rank's tokens; 16c-16e the same
    checks as 16a for mamba2-130m (4 layers), zamba2-1.2b (6 layers) and
    musicgen-medium (2 layers) on [2, 2,048]; 16f llama-3.2-vision-90b (5
    layers, bf16) serving with image embeddings."""
    import torch.multiprocessing as mp

    from repro_torch import configs
    from repro_torch import random as rnd
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    parts, (moe, _, _) = _tp_cases()
    qwen = parts[0][1]
    _published(qwen, QWEN_FULL, "qwen3-4b")
    check(qwen.remat and moe.dtype == torch.bfloat16, f"16: {qwen}, {moe}")
    world = TP_MESH[0] * TP_MESH[1]
    one, rec, replicated, one_s = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        tmp = pathlib.Path(tmp)
        ctx = mp.start_processes(_tp_rank, args=(world, f"file://{tmp}/rendezvous", str(tmp)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + TP_RANK_SECONDS
        try:
            for part, cfg, seed, tok, seq in parts:
                t0 = time.perf_counter()
                one[part] = _one_rank(torch, cfg, seed, tok, TP_STEPS, tmp / f"one_rank_{part}.pt",
                                      serve=True, accum=1, seq=seq, session=_tp_session(part))
                one_s[part] = time.perf_counter() - t0
            one_s["16f"] = _one_rank_vlm(torch, tmp / "one_rank_16f.pt")
            one["16f"] = torch.load(tmp / "one_rank_16f.pt", weights_only=False)
            for part, cfg, _, _, seq in parts:  # the dry run's record of each cell
                with dryrun.fake_mesh(world, TP_MESH):
                    rec[part] = dryrun.trace_cell(cfg, configs.Shape(f"train_2x{seq}", seq,
                                                                     TRAIN_BATCH, "train"))
                    whole = transformer.init_params(cfg, rnd.key(0), device="meta")
                    psh = layouts.param_shardings(cfg, whole)
                replicated[part] = sum(t.numel() * 4 * 3 for t, p in
                                       zip(opt.leaves(whole), opt.leaves(psh))
                                       if fsdp.model_dim(p) is None)  # parameters, m and v
        except BaseException:
            for p in ctx.processes:
                p.terminate()
            raise
        ranks = _fsdp_join(torch, ctx, tmp, deadline)
    lr = TRAIN_LR["lr"]
    failures = []

    def gate(ok, what):
        if not ok:
            failures.append(what)

    def rel(a, b):
        return abs(a - b) / abs(b)

    for part, cfg, _, _, seq in parts:
        o = one[part]
        what = (f"{cfg.name} ({cfg.n_layers} of {configs.get_config(cfg.name).n_layers} layers, "
                f"f32{', remat' if cfg.remat else ''})")
        for r in ranks:
            k, g = r["rank"], r["parts"][part]
            loss_rel = max(rel(a, b) for a, b in zip(g["loss"], o["loss"]))
            norm_rel = max(rel(a, b) for a, b in zip(g["grad_norm"], o["grad_norm"]))
            l2, share = g["m1"]
            inside, anywhere, inside15, g15 = g["params"]
            c_loss, c_norm = rel(g["control"][0], o["loss"][0]), rel(g["control"][1],
                                                                    o["grad_norm"][0])
            limit = o["resident"] / TP_MESH[1] + replicated[part] + FSDP_RESIDENT_SLACK
            est = rec[part]["memory"]["peak_bytes_est"]
            print(f"[tp] {part} rank {k} of {TP_MESH} (data, model): {what} {TP_STEPS} steps on "
                  f"[{TRAIN_BATCH}, {seq:,}] against one rank's: losses "
                  + ", ".join(f"{x:.6f}" for x in g["loss"]) + " against "
                  + ", ".join(f"{x:.6f}" for x in o["loss"])
                  + ", grad-norms " + ", ".join(f"{x:.6f}" for x in g["grad_norm"]) + " against "
                  + ", ".join(f"{x:.6f}" for x in o["grad_norm"])
                  + f" (relative {loss_rel:.3g} and {norm_rel:.3g}, limit {FSDP_RTOL}); the first "
                  f"moment within a relative L2 of {l2:.3g} and a leaf's share {share:.3g} (limit "
                  f"{FSDP_MOMENT_TOL}); the parameters after step 1 past {FSDP_PARAM_TOL[1]} "
                  f"relative by {inside:.3g} where the moment is signed and ĝ ≥ "
                  f"{TP_SIGN_FLOOR:g} "
                  f"(limit {FSDP_PARAM_TOL[0]}; by {inside15:.3g} with phase 15's mask alone, at "
                  f"an element of ĝ {g15:.3g}), {anywhere:.3g} apart anywhere (limit {2 * lr}); "
                  f"seconds a step " + ", ".join(f"{x:.3f}" for x in g["step_s"])
                  + " against one rank's " + ", ".join(f"{x:.3f}" for x in o["step_s"])
                  + f" ({smi})")
            print(f"[tp] {part} rank {k} control, the row-parallel partials unreduced: loss "
                  f"{g['control'][0]:.6f} misses by a relative {c_loss:.3g} "
                  f"({c_loss / FSDP_RTOL:.0f}× the limit), grad-norm {g['control'][1]:.6f} by "
                  f"{c_norm:.3g} ({c_norm / FSDP_RTOL:.0f}×; each must be ≥ {FSDP_CONTROL}×)")
            print(f"[tp] {part} rank {k}: collectives of step 1 {g['counts']}, the dry run's rule "
                  f"for the cell on {TP_MESH} {rec[part]['collectives']}; resident bytes after "
                  f"step 1 {g['resident']:,} against one rank's {o['resident']:,} (ratio "
                  f"{g['resident'] / o['resident']:.4f}; limit {limit:,.0f}: 1/{TP_MESH[1]} + the "
                  f"model-replicated leaves' {replicated[part]:,} + {FSDP_RESIDENT_SLACK:,}); peak "
                  f"{g['peak'] / 2**30:.3f} GiB against the dry run's peak_bytes_est "
                  f"{est / 2**30:.3f} GiB: ratio {g['peak'] / est:.4f} (one rank's peak "
                  f"{o['peak'] / 2**30:.3f} GiB); the part took {g['s']:.1f} s on the ranks, "
                  f"{one_s[part]:.1f} s at one rank ({smi})")
            gate(loss_rel <= FSDP_RTOL and norm_rel <= FSDP_RTOL,
                 f"{part} rank {k} loss {g['loss']}, grad-norm {g['grad_norm']} against "
                 f"{o['loss']}, {o['grad_norm']}")
            gate(l2 <= FSDP_MOMENT_TOL and share <= FSDP_MOMENT_TOL,
                 f"{part} rank {k} first moment {l2}, {share}")
            gate(inside <= FSDP_PARAM_TOL[0] and anywhere <= 2 * lr + FSDP_PARAM_TOL[0],
                 f"{part} rank {k} parameters {inside}, {anywhere}")
            gate(c_loss >= FSDP_CONTROL * FSDP_RTOL and c_norm >= FSDP_CONTROL * FSDP_RTOL,
                 f"{part} rank {k} control missed by {c_loss}, {c_norm} only")
            gate(g["counts"] == rec[part]["collectives"], f"{part} rank {k} collectives "
                 f"{g['counts']}")
            gate(g["resident"] <= limit, f"{part} rank {k} resident {g['resident']:,} > "
                 f"{limit:,.0f}")
            gate(g["slots"] in (None, _tp_held(part)), f"{part} rank {k} slots {g['slots']}")
        # the ranks' vocabulary columns put together (one data rank: each holds both rows)
        worst = max(_share(torch, torch.cat([r["parts"][part]["logits"][i] for r in ranks],
                                            dim=-1), o["logits"][i], cfg.vocab)
                    for i in range(FSDP_DECODE + 1))
        slots = ranks[0]["parts"][part]["slots"]
        sc = _tp_session(part)
        print(f"[tp] {part} the same shards serve: prefill [{TRAIN_BATCH}, {FSDP_PROMPT}]"
              + (f" over {slots} cache slots a rank of {sc}"
                 + (" (whole on each rank: decode over all of them, no combine)"
                    if slots == sc else "") if slots else " (the ssm state on the rank's heads)")
              + f" and {FSDP_DECODE} decode steps teacher-forced on one rank's greedy tokens: "
              f"logits within {worst:.3g} of max |logit| of one rank's (limit {TF_SHARE_BF16}); "
              f"seconds " + ", ".join(f"{r['parts'][part]['serve_s']:.3f}" for r in ranks)
              + f" ({smi})")
        gate(worst <= TF_SHARE_BF16, f"{part} logits {worst}")
    for r in ranks:
        mo = r["moe"]
        print(f"[tp] 16b rank {r['rank']}: deepseek-moe-16b ({FSDP_MOE_LAYERS} of 28 layers) one "
              f"step in the {mo['mode']} island ({moe.n_experts} experts, "
              f"{moe.n_experts // TP_MESH[1]} a rank, capacity from the rank's {mo['tokens']:,} "
              f"tokens): loss {mo['loss']:.6f}; the layer's output within {mo['share']:.3g} of max "
              f"|y| of the local MoE on the rank's tokens (limit {TF_SHARE_BF16}); "
              f"{r['moe_s']:.3f} s a step, the part {mo['s']:.1f} s ({smi})")
        gate(mo["mode"] == "ep" and mo["share"] <= TF_SHARE_BF16 and math.isfinite(mo["loss"]),
             f"16b rank {r['rank']}: {mo}")
    vcfg = _tp_vlm()[0]
    worst = max(_share(torch, torch.cat([r["vlm"]["logits"][i] for r in ranks], dim=-1),
                       one["16f"]["logits"][i], vcfg.vocab) for i in range(FSDP_DECODE + 1))
    v = ranks[0]["vlm"]
    print(f"[tp] 16f llama-3.2-vision-90b ({vcfg.n_layers} of 100 layers: 4 self, 1 cross; bf16) "
          f"serving on {TP_MESH}: prefill [{TRAIN_BATCH}, {FSDP_PROMPT}] with bf16 image "
          f"embeddings [{TRAIN_BATCH}, {vcfg.n_image_tokens:,}, {vcfg.d_model:,}] over "
          f"{v['slots']} "
          f"cache slots a rank, the image K/V whole {v['image_kv']}, and {FSDP_DECODE} decode "
          f"steps teacher-forced on one rank's greedy tokens: logits within {worst:.3g} of max "
          f"|logit| of one rank's (limit {TF_SHARE_BF16}); the part took "
          + ", ".join(f"{r['vlm']['s']:.1f}" for r in ranks) + f" s on the ranks, "
          f"{one_s['16f']:.1f} s at one rank ({smi})")
    gate(worst <= TF_SHARE_BF16, f"16f logits {worst}")
    gate(v["slots"] == (FSDP_PROMPT + FSDP_DECODE) // TP_MESH[1], f"16f slots {v['slots']}")
    print(f"[tp] phase 16 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    check(not failures, "; ".join(failures))


# ---------------------------------------------------------------- main
def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if "--walls" in argv:
        i = argv.index("--walls")
        return _walls_child(argv[i + 1], int(argv[i + 2]))
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    # the SUSY shards of phase 6 live until phase 9 has read them; the
    # autotune cache starts empty in a directory of its own
    with tempfile.TemporaryDirectory(prefix="bwkm_shards_") as shard_dir, \
            tempfile.TemporaryDirectory(prefix="bwkm_autotune_") as tune_dir:
        os.environ["REPRO_AUTOTUNE_CACHE"] = str(pathlib.Path(tune_dir) / "autotune.json")
        return _phases(torch, argv, shard_dir)


def _phases(torch, argv, shard_dir: str) -> int:
    import repro_torch
    from repro_torch import random as rnd
    from repro_torch.core import kmeans_ll, partition
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import cluster_update as cu
    from repro_torch.kernels import distance_assign as da
    from repro_torch.kernels import fused_assign_update as fau
    from repro_torch.kernels import min_sqdist_update as msu

    laps: list[tuple[str, float]] = []
    t_last = [time.perf_counter()]

    def lap(phase: str) -> None:
        """The seconds since the last lap, as ``phase``'s."""
        now = time.perf_counter()
        laps.append((phase, now - t_last[0]))
        t_last[0] = now

    # phase 1
    t0 = time.perf_counter()
    parent = (_Parent.start(_build, argv[argv.index("--parent") + 1])
              if "--parent" in argv else None)
    reports = _build.build_all()
    if parent is not None:
        parent.finish()
    print(f"[build] {time.perf_counter() - t0:.1f} s, compiled {sorted(reports)}"
          + (" and the parent's four" if parent is not None else ""))
    for name, log in reports.items():
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.strip()}")
    lap("1")
    # phase 2
    errs, rel, n_checks, ties = phase_kernels(torch, ref, da, fau, kmeans_ll._FAR)
    print(f"[kernels] B1-B3 match their plain versions in {n_checks} cases "
          "(f32 tol 1e-5, bf16 tol 1e-3); max abs err of d1/d2: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in errs.items())
          + "; max rel err of sums/counts/err: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in rel.items())
          + f"; at most {ties} rows in one case labelled otherwise than by the plain version "
          "(near-ties, each at the minimum within tolerance)")
    errs45, rel45, n_checks = phase_kernels_b45(torch, ref, cu, msu)
    errs.update(errs45)
    print(f"[kernels] B4-B5 match their plain versions in {n_checks} cases "
          "(f32 tol 1e-5, bf16 tol 1e-3; B5's min-d² relative to ‖x‖² + ‖c‖², sums to Σ|terms|); "
          "max abs err of B5 min-d² and B4 sums: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in errs45.items())
          + "; max rel err of B5 cost and B4 sums/counts: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in rel45.items()))
    wide = phase_kernels_wide(torch, ref, da, fau, cu, msu)
    print(f"[kernels] wide rows (d = {WIDE_D[0]:,} and {WIDE_D[1]:,}, 300 rows, K = 5; B2/B3 "
          f"at K = 1, d = {WIDE_D[0]:,}) match their plain versions (f32 tol 1e-5, sums to "
          "Σ|terms|); max abs err: " + ", ".join(f"{b} {v:.3g}" for b, v in wide.items()))
    counters = _kernel_counters()
    lap("2")
    # phase 6 first: the streaming engine over the data as shards, before the
    # data goes on the card; it leaves the data on the card for phases 3–5
    t0 = time.perf_counter()
    xs = paper_dataset("SUSY", seed=0)
    print(f"[data] SUSY profile {xs.shape} made in {time.perf_counter() - t0:.1f} s")
    stream_launches, x, stream_score = phase_stream(torch, repro_torch, rnd, ops, ref, fau,
                                                    partition, counters, xs, shard_dir)
    del xs
    lap("6")
    # phase 3
    phase_determinism(torch, ops, da, fau, cu, msu, partition, x, kmeans_ll._FAR)
    print("[determinism] pruned == dense bit for bit at 0/10/100 % active (fused at the "
          "representatives and over all rows at K = 561 and K = 800, two-pass at K·(d+1) = "
          "18,000); two B2 runs at each of those shapes, two full-n B1, B4 and B5 runs and two "
          "full-n block_stats runs bit-equal; full-n B5 over 400 slots == B5 over its valid ones")
    lap("3")
    # phase 4
    launches, incore_score, incore = phase_fit(torch, repro_torch, ref, da, fau, x, parent)
    print(f"[stream] the streamed fit's score against the in-core fit's: "
          f"{(stream_score - incore_score) / incore_score:+.3e} (reported, not gated)")
    ll_launches, ll_path, rep_folds = phase_kmeans_ll(torch, repro_torch, rnd, kmeans_ll, ops,
                                                      ref, counters, x)
    launches.update(B4=ll_launches["B4"], B5=ll_launches["B5"])
    for b in launches:
        launches[b] += stream_launches[b]
    lap("4")
    # phase 5
    times = phase_times(torch, ref, da, fau, cu, msu, x, ll_path, rep_folds, parent)
    lap("5")
    # phase 7
    service_launches = phase_service(torch, repro_torch, rnd, ops, counters, x)
    for b in launches:
        launches[b] += service_launches[b]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    lap("7")
    # phase 8
    tradeoff_launches = phase_tradeoff(torch, repro_torch, rnd, ref, da, fau, cu, counters, x, smi)
    for b in launches:
        launches[b] += tradeoff_launches[b]
    lap("8")
    # phase 9
    dist_launches = phase_distributed(torch, repro_torch, rnd, partition, counters, x, shard_dir,
                                      incore, smi)
    for b in launches:
        launches[b] += dist_launches[b]
    lap("9")
    # phase 10
    phase_autotune(torch, repro_torch, x, ll_path, smi)
    lap("10")
    # phase 11
    vq_launches, vq_errs = phase_vq(torch, rnd, ref, da, fau, cu, msu, counters, smi)
    for b in launches:
        launches[b] += vq_launches[b]
    for b, e in vq_errs.items():
        errs[b, "float32"] = max(errs[b, "float32"], e)
    lap("11")
    # phase 12
    family_launches, family_errs = phase_families(torch, rnd, ref, da, fau, cu, msu, counters,
                                                  smi)
    for b in launches:
        launches[b] += family_launches[b]
    for b, e in family_errs.items():
        errs[b, "float32"] = max(errs[b, "float32"], e)
    lap("12")
    # phase 13
    phase_train(torch, smi)
    lap("13")
    # phase 14
    phase_dryrun(torch, smi)
    lap("14")
    # phase 15
    phase_fsdp(torch, smi)
    lap("15")
    # phase 16
    phase_tp(torch, smi)
    lap("16")
    if parent is not None:
        phase_walls(argv[argv.index("--parent") + 1])
    if "--profile" in argv:
        phase_profile(torch, repro_torch, rnd, x, pathlib.Path(argv[argv.index("--profile") + 1]))
    print("[time] seconds a phase: " + ", ".join(f"{p} {t:.1f}" for p, t in laps)
          + f"; phases 1-16 {sum(t for _, t in laps):.1f} s")
    print(smi)
    sources = {
        "B1": ("assign_top2", "src/repro_torch/kernels/csrc/distance_assign.cu",
               "src/repro/kernels/distance_assign.py:82"),
        "B2": ("fused_assign_update", "src/repro_torch/kernels/csrc/fused_assign_update.cu",
               "src/repro/kernels/fused_assign_update.py:136"),
        "B3": ("fused_assign_update_pruned", "src/repro_torch/kernels/csrc/fused_assign_update.cu",
               "src/repro/kernels/fused_assign_update.py:307"),
        "B4": ("cluster_sums", "src/repro_torch/kernels/csrc/cluster_sums.cu",
               "src/repro/kernels/cluster_update.py:51"),
        "B5": ("min_sqdist_update", "src/repro_torch/kernels/csrc/min_sqdist_update.cu",
               "src/repro/kernels/min_sqdist_update.py:92"),
    }
    records = []
    for key, (name, source, replaces) in sources.items():
        t = times[key]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[key, "float32"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"].ms, "bound_by": t["bound"].by,
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
