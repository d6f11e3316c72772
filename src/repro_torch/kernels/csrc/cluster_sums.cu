// B4: weighted per-cluster sums and counts for a given assignment.
//
// Replaces repro/kernels/cluster_update.py:cluster_sums_pallas (its
// _kernel). The TPU kernel builds a [rows, K] one-hot tile and contracts it
// with the row block on the MXU into a [K, d] accumulator that stays in VMEM
// across a grid run in order. On Hopper the same work is a scatter of
// n·(d + 1) values, and a partial per row block would need scratch that
// grows with n (6.3 GB at n = 5,000,000, K = 2,001, d = 19). So it runs the
// fold of cluster_fold.cuh: a fixed grid of at most 128 CTAs along the rows,
// each keeping a [K-tile, d + 1] partial in shared memory summed in row
// order by one thread per element, then a second kernel that sums the
// partials in CTA order. B2/B3 fold their statistics through the same code.
//
// Scratch is at most 128·K·(d + 1) floats whatever n is, and two runs are
// bit-equal. Rows with w == 0 add nothing.
//
// What bounds it on an H100: the pass moves each row once (4·d + 8 bytes)
// for d + 1 adds, far under one FLOP per byte, so it is bound by memory:
// about 0.125 ms for 420 MB at x [5,000,000, 19]. Staging the tile keeps
// the scattered adds in shared memory and the global reads coalesced.
#include "cluster_fold.cuh"

using namespace bwkm;

// sums [K, d] and counts [K] of x [n, d] under assign [n] (ids outside
// [0, K) add nothing). `part` holds min(128, ceil(n/256))·K·(d + 1) floats
// of scratch; d + 1 must be at most 40,960. dtype codes: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t.
extern "C" int bwkm_cluster_sums(const void* x, int x_dtype, const float* w, const int* assign,
                                 long long n, int d, int K, float* sums, float* counts,
                                 float* part, void* stream) {
  if (K < 1 || d < 1 || d + 1 > fold::PART_FLOATS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return fold::fold_and_reduce(static_cast<const float*>(x), w, assign, nullptr, nullptr, n,
                                 d, K, sums, counts, nullptr, part, s);
  return fold::fold_and_reduce(static_cast<const __nv_bfloat16*>(x), w, assign, nullptr,
                               nullptr, n, d, K, sums, counts, nullptr, part, s);
}
