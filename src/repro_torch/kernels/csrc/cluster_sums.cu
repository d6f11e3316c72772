// B4: weighted per-cluster sums and counts for a given assignment.
//
// Replaces repro/kernels/cluster_update.py:cluster_sums_pallas (its
// _kernel). The TPU kernel builds a [rows, K] one-hot tile and contracts it
// with the row block on the MXU into a [K, d] accumulator that stays in VMEM
// across a grid run in order. On Hopper the same work is a scatter of
// n·(d + 1) values, and a partial per row block would need scratch that
// grows with n (6.3 GB at n = 5,000,000, K = 2,001, d = 19). So it runs the
// fold of cluster_fold.cuh: a fixed grid of at most 128 CTAs along the rows,
// each streaming its contiguous rows through a ring of TMA-filled stages and
// adding them into a [K-tile, column-chunk] partial in shared memory, in
// row order by one thread per element, then a second kernel that sums the
// partials in CTA order. B2/B3 fold their statistics through the same code.
//
// Scratch is at most 128·K·(d + 1) floats whatever n is, and two runs are
// bit-equal. Rows with w == 0 add nothing. Any d >= 1: past d + 1 = 40,960
// the columns are tiled as well.
//
// What bounds it on an H100: the pass moves each row once (4·d + 8 bytes)
// for d + 1 adds, far under one FLOP per byte, so its bound is memory:
// about 0.125 ms for 420 MB at x [5,000,000, 19]. The ring keeps two or
// three tiles of rows in flight per SM (about 43 KB at K = 2,001, d = 19)
// while one is walked, and the scattered adds stay in shared memory. What
// sets its pace is the walk inside each SM, not the copies (PERF.md).
#include "cluster_fold.cuh"

using namespace bwkm;

// sums [K, d] and counts [K] of x [n, d] under assign [n] (ids outside
// [0, K) add nothing). `part` holds min(128, ceil(n/256))·K·(d + 1) floats
// of scratch. `kt`, `cw` and `stages` are the fold's plan
// (cluster_fold.cuh::FoldPlan; 0: the kernel's own choice; a finer [kt, cw]
// tiling leaves every bit as it is), and `phases` says what runs (1 the
// fold, 2 the reduction, 3 both: to test and time the fold). A plan that
// does not fit returns cudaErrorInvalidValue and launches nothing. dtype
// codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int bwkm_cluster_sums_ex(const void* x, int x_dtype, const float* w,
                                    const int* assign, long long n, int d, int K, float* sums,
                                    float* counts, float* part, int kt, int cw, int stages,
                                    int phases, void* stream) {
  if (K < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const fold::FoldPlan p{kt, cw, stages};
  if (x_dtype == 0)
    return fold::fold_and_reduce(static_cast<const float*>(x), w, assign, nullptr, nullptr, n,
                                 d, K, sums, counts, nullptr, part, s, p, phases);
  return fold::fold_and_reduce(static_cast<const __nv_bfloat16*>(x), w, assign, nullptr,
                               nullptr, n, d, K, sums, counts, nullptr, part, s, p, phases);
}

// The fold and its reduction at the kernel's own plan.
extern "C" int bwkm_cluster_sums(const void* x, int x_dtype, const float* w, const int* assign,
                                 long long n, int d, int K, float* sums, float* counts,
                                 float* part, void* stream) {
  return bwkm_cluster_sums_ex(x, x_dtype, w, assign, n, d, K, sums, counts, part, 0, 0, 0, 3,
                              stream);
}

// What the statistics fold (B2/B3's and B4's) launches with for plan (kt,
// cw, stages) over n rows of d features of `xsize` bytes into K clusters,
// with the error (err != 0) and an active mask (act != 0), written to
// out[0..8]: kt, cw, stages, x staged (0/1), bytes of a stage, bytes of the
// partial, dynamic shared bytes, CTAs along the rows, row tiles. Needs no
// device; the host's plan (repro_torch.roofline.analysis) is held against
// it. Returns a cudaError_t: cudaErrorInvalidValue for a plan the kernels
// refuse.
extern "C" int bwkm_fold_plan(long long n, int d, int K, int xsize, int err, int act, int kt,
                              int cw, int stages, long long* out) {
  fold::Shape s;
  const int rc = fold::fold_plan(n, d, K, xsize, err != 0, act != 0,
                                 fold::FoldPlan{kt, cw, stages}, &s);
  if (rc != 0) return rc;
  out[0] = s.kt;
  out[1] = s.cw;
  out[2] = s.stages;
  out[3] = s.xstaged;
  out[4] = s.sbytes;
  out[5] = s.pbytes;
  out[6] = s.smem;
  out[7] = fold::row_ctas(n);
  out[8] = s.tiles;
  return (int)cudaSuccess;
}
