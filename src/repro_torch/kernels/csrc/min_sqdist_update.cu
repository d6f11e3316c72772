// B5: the k-means|| fold — running per-row min squared distance to a masked
// candidate batch, and the weighted cost φ = Σ w·min-d² of the new state.
//
// Replaces repro/kernels/min_sqdist_update.py:min_sqdist_update_pallas (its
// _kernel) and its Pallas-on-Triton twin repro/kernels/gpu.py:
// min_sqdist_update_gpu. The TPU kernel walks a (row block, candidate tile)
// grid in order, keeps the row block's running min in VMEM across candidate
// tiles and adds the block's cost into one scalar accumulator across the
// whole grid. CTAs on Hopper run in no order, so:
//
//   pass 1 (min_sqdist_kernel): the persistent scan of top2.cuh (the one
//     B1–B3 run) with each row's running min of p = ‖c‖² − 2·x·c in a
//     register as its reducer. Each CTA loads only the valid candidates
//     (cvalid != 0), compacted in id order, and keeps them in shared memory
//     for the launch, so invalid slots cost nothing; x is read once per
//     fold. A row's new min-d² is min(mind2, max(‖x‖² + min p, 0)): fminf
//     is exact and max(‖x‖² + p, 0) is monotone in p, so it is bit for bit
//     the min over the candidates' distances, whichever candidates were
//     folded alongside invalid ones; with no valid candidate mind2 passes
//     through. Each row tile writes one cost partial: a thread's rows in
//     order, a fixed warp-shuffle tree, then the warps in order (zero-weight
//     and padded rows add nothing).
//   pass 2 (sum_partials): one CTA sums the partials in a fixed order.
//
// Rows too wide for four resident candidates (d > 14,432) take the scan's
// wide-row form (top2.cuh::wide_rows_kernel) with the same reducer.
//
// No float atomics, so two runs are bit-equal.
//
// What bounds it on an H100: at the k-means|| path's shapes (n = 5,000,000,
// d = 19, L = 112 candidates per round) it does 2·d + 3 FLOP per (row,
// valid candidate), 41·112 ≈ 4.6 kFLOP per row against 4·d + 12 bytes per
// row of traffic: bound by f32 operations (about 0.34 ms at 67 TFLOP/s
// against 0.13 ms for the bytes). Four rows per thread against four
// candidates per shared load, and one fminf per (row, candidate) as the
// epilogue, keep the issue slots on FFMA.
#include "top2.cuh"

using namespace bwkm;

namespace {

constexpr int SUM_THREADS = 1024;

struct RunMin {
  float best;

  __device__ static RunMin fresh() { return RunMin{inf_f()}; }
  __device__ __forceinline__ void operator()(int, float p) { best = fminf(best, p); }
};

struct Fold {
  using Red = RunMin;
  const float* w;
  const float* mind2;
  float* out;
  float* costpart;

  __device__ bool any_active(long long, long long) const { return true; }

  template <int R>
  __device__ void finish(long long tile, long long row0, long long n, const RunMin (&red)[R],
                         const float (&xn)[R], bool) const {
    __shared__ float warp_cost[SCAN_WARPS];
    const int t = threadIdx.x;
    float c = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + t + r * SCAN_THREADS;
      if (row >= n) continue;
      const float m = fminf(mind2[row], fmaxf(xn[r] + red[r].best, 0.f));
      out[row] = m;
      const float wr = w[row];
      if (wr != 0.f) c += wr * m;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if ((t & 31) == 0) warp_cost[t >> 5] = c;
    __syncthreads();
    if (t == 0) {
      float acc = 0.f;
      for (int i = 0; i < SCAN_WARPS; ++i) acc += warp_cost[i];
      costpart[tile] = acc;
    }
    // warp_cost is written again only after the next tile's first barrier
  }
};

template <int DX, int R, typename TX, typename TC>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
min_sqdist_kernel(const TX* __restrict__ x, const TC* __restrict__ cand,
                  const float* __restrict__ cvalid, ScanShape s, Fold o) {
  scan_rows<DX, R>(x, cand, cvalid, s, o);
}

// One CTA: thread i sums a contiguous run of partials in order, then a
// fixed tree over the threads. The order depends on nothing but nb.
__global__ void __launch_bounds__(SUM_THREADS)
sum_partials(const float* __restrict__ part, long long nb, float* __restrict__ cost) {
  __shared__ float s[SUM_THREADS];
  const int t = threadIdx.x;
  const long long per = (nb + SUM_THREADS - 1) / SUM_THREADS;
  const long long b0 = t * per, b1 = min(nb, b0 + per);
  float acc = 0.f;
  for (long long b = b0; b < b1; ++b) acc += part[b];
  s[t] = acc;
  __syncthreads();
  for (int h = SUM_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) s[t] += s[t + h];
    __syncthreads();
  }
  if (t == 0) *cost = s[0];
}

template <typename TX, typename TC>
int launch(const void* x, const float* w, const void* cand, const float* cvalid,
           const float* mind2, long long n, int d, int L, float* out, float* cost,
           float* costpart, cudaStream_t st, const ScanPlan& p) {
  ScanShape s;
  size_t smem = 0;
  bool wide = false;
  int rc = scan_plan(n, d, L, (int)sizeof(TX), p, &s, &smem, &wide);
  if (rc != 0) return rc;
  const TX* xt = static_cast<const TX*>(x);
  const TC* ct = static_cast<const TC*>(cand);
  const Fold o{w, mind2, out, costpart};
  if (wide)  // rows too wide for four resident candidates
    rc = launch_scan(wide_rows_kernel<TX, TC, Fold>, s, WIDE_SMEM, p.ctas, st, xt, ct, cvalid, s,
                     o);
  else if (scan_dx(d) == 32)
    rc = launch_scan(min_sqdist_kernel<32, 1, TX, TC>, s, smem, p.ctas, st, xt, ct, cvalid, s, o);
  else if (s.rows == 4 * SCAN_THREADS)
    rc = launch_scan(min_sqdist_kernel<19, 4, TX, TC>, s, smem, p.ctas, st, xt, ct, cvalid, s, o);
  else
    rc = launch_scan(min_sqdist_kernel<19, 1, TX, TC>, s, smem, p.ctas, st, xt, ct, cvalid, s, o);
  if (rc != 0) return rc;
  sum_partials<<<1, SUM_THREADS, 0, st>>>(costpart, s.tiles, cost);
  return (int)cudaGetLastError();
}

}  // namespace

// One fold. `costpart` holds ceil(n/128) floats of scratch (one per row
// tile, at least 128 rows each); `cost` is one float. dtype codes:
// 0 = float32, 1 = bfloat16. `rpt`, `kc` and `ctas` are the scan's plan
// (top2.cuh::ScanPlan; 0: the kernel's own choice). Each row tile writes one
// cost partial, so the rows a thread set the order φ is summed in: a plan
// that keeps φ's bits passes rpt = 0. A plan that does not fit returns
// cudaErrorInvalidValue and launches nothing. Returns a cudaError_t.
extern "C" int bwkm_min_sqdist_update_ex(const void* x, int x_dtype, const float* w,
                                         const void* cand, int c_dtype, const float* cvalid,
                                         const float* mind2, long long n, int d, int L,
                                         float* out, float* cost, float* costpart, int rpt,
                                         int kc, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScanPlan p{rpt, kc, ctas};
  if (x_dtype == 0 && c_dtype == 0)
    return launch<float, float>(x, w, cand, cvalid, mind2, n, d, L, out, cost, costpart, s, p);
  if (x_dtype == 0)
    return launch<float, __nv_bfloat16>(x, w, cand, cvalid, mind2, n, d, L, out, cost, costpart,
                                        s, p);
  if (c_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, cand, cvalid, mind2, n, d, L, out, cost, costpart,
                                        s, p);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, cand, cvalid, mind2, n, d, L, out, cost,
                                              costpart, s, p);
}

// The fold at the kernel's own plan.
extern "C" int bwkm_min_sqdist_update(const void* x, int x_dtype, const float* w,
                                      const void* cand, int c_dtype, const float* cvalid,
                                      const float* mind2, long long n, int d, int L,
                                      float* out, float* cost, float* costpart,
                                      void* stream) {
  return bwkm_min_sqdist_update_ex(x, x_dtype, w, cand, c_dtype, cvalid, mind2, n, d, L, out,
                                   cost, costpart, 0, 0, 0, stream);
}
