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
//   pass 1 (min_sqdist_kernel): each CTA owns 128 rows, one per thread, and
//     runs the tile scan of top2.cuh (the one B1–B3 use) with the row's
//     running min in a register as its reducer; x is read once per fold.
//     Invalid candidates (cvalid == 0) never win. The CTA then writes its
//     rows' new min and one cost partial, a fixed warp-shuffle tree over its
//     rows (zero-weight and padded rows add nothing).
//   pass 2 (sum_partials): one CTA sums the partials in a fixed order.
//
// No float atomics, so two runs are bit-equal.
//
// What bounds it on an H100: at the k-means|| path's shapes (n = 5,000,000,
// d = 19, L = 112 candidates per round) it does 2·d + 3 FLOP per (row,
// candidate), 41·112 ≈ 4.6 kFLOP per row against 4·d + 12 bytes per row of
// traffic: bound by f32 operations (about 0.34 ms at 67 TFLOP/s against
// 0.13 ms for the bytes).
#include "top2.cuh"

using namespace bwkm;

namespace {

constexpr int SUM_THREADS = 1024;

struct RunMin {
  float best;

  __device__ __forceinline__ void operator()(int, float dist) { best = fminf(best, dist); }
};

template <typename TX, typename TC>
__global__ void __launch_bounds__(ROWS)
min_sqdist_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                  const TC* __restrict__ cand, const float* __restrict__ cvalid,
                  const float* __restrict__ mind2, long long n, int d, int L,
                  float* __restrict__ out, float* __restrict__ costpart) {
  __shared__ float warp_cost[ROWS / 32];
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const long long row = row0 + t;
  RunMin rm{BIG};
  scan_rows(x, cand, cvalid, n, d, L, row0, rm);  // invalid candidates come as +inf
  float c = 0.f;
  if (row < n) {
    const float m = fminf(mind2[row], rm.best);
    out[row] = m;
    const float wr = w[row];
    if (wr != 0.f) c = wr * m;
  }
  // the CTA's cost partial: a fixed shuffle tree per warp, then warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((t & 31) == 0) warp_cost[t >> 5] = c;
  __syncthreads();
  if (t == 0) {
    float acc = 0.f;
    for (int i = 0; i < ROWS / 32; ++i) acc += warp_cost[i];
    costpart[blockIdx.x] = acc;
  }
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
void launch(const void* x, const float* w, const void* cand, const float* cvalid,
            const float* mind2, long long n, int d, int L, float* out, float* costpart,
            cudaStream_t s) {
  const long long nb = (n + ROWS - 1) / ROWS;
  min_sqdist_kernel<TX, TC><<<(unsigned)nb, ROWS, 0, s>>>(
      static_cast<const TX*>(x), w, static_cast<const TC*>(cand), cvalid, mind2, n, d, L, out,
      costpart);
}

}  // namespace

// One fold. `costpart` holds ceil(n/128) floats of scratch; `cost` is one
// float. dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int bwkm_min_sqdist_update(const void* x, int x_dtype, const float* w,
                                      const void* cand, int c_dtype, const float* cvalid,
                                      const float* mind2, long long n, int d, int L,
                                      float* out, float* cost, float* costpart,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + ROWS - 1) / ROWS;
  if (nb > 0) {
    if (x_dtype == 0 && c_dtype == 0)
      launch<float, float>(x, w, cand, cvalid, mind2, n, d, L, out, costpart, s);
    else if (x_dtype == 0)
      launch<float, __nv_bfloat16>(x, w, cand, cvalid, mind2, n, d, L, out, costpart, s);
    else if (c_dtype == 0)
      launch<__nv_bfloat16, float>(x, w, cand, cvalid, mind2, n, d, L, out, costpart, s);
    else
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, cand, cvalid, mind2, n, d, L, out, costpart,
                                           s);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  sum_partials<<<1, SUM_THREADS, 0, s>>>(costpart, nb, cost);
  return (int)cudaGetLastError();
}
