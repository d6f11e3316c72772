// Shared device code of the statistics kernels: the deterministic per-CTA
// fold of weighted cluster sums and counts, and the CTA-order reduction of
// its partials. B4 (cluster_sums.cu) and the statistics of B2/B3
// (fused_assign_update.cu) both run it, so the code exists once.
//
//   fold_kernel: a FIXED grid of at most MAX_CTAS CTAs along the rows (never
//     derived from the device), each owning a contiguous run of TILE-row
//     tiles, times ceil(K / kt) CTAs along the clusters. A CTA keeps its
//     [kt, d + 1] partial in dynamic shared memory (at most PART_FLOATS
//     floats). Per tile it stages the ids, weights and a 32-feature chunk of
//     x in shared memory; warp q owns the clusters whose local id is q mod
//     32 and walks the tile's rows in order (a ballot per 32 rows), its
//     lanes adding one feature each. Every partial element is therefore
//     summed by one thread in row order, with no atomics. Given `d1`, the
//     CTAs of the first cluster tile also fold the error Σ w·d1 over the
//     active rows (every row when `active` is null): the tile's products
//     are staged beside the weights and one thread adds them in row order,
//     as if they were a (d + 2)-th column.
//   reduce_partials: one thread per output sums the partials in CTA order.
//
// CTA b's partial starts at part + b·stride: K·(d + 1) floats (cluster k's
// sums, then its count, at k·(d + 1)), then the error at K·(d + 1) when it
// is folded. Rows with w == 0 and ids outside [0, K) add nothing. Scratch is
// at most MAX_CTAS·stride floats whatever n is, and two runs are bit-equal:
// the result depends only on x, w, the ids (and d1, active) and the fixed
// row-to-CTA mapping.
#pragma once

#include <algorithm>

#include "top2.cuh"

namespace bwkm {
namespace fold {

constexpr int THREADS = 1024;       // 32 warps
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 256;           // rows staged per step
constexpr int FC = 32;              // features per staged chunk (one per lane)
constexpr int XSC = FC + 1;         // staged row stride
constexpr int MAX_CTAS = 128;       // CTAs along the rows, at most
constexpr int PART_FLOATS = 40960;  // the shared partial, at most (160 KB)
constexpr int ERR_THREAD = THREADS - 32;  // lane 0 of the last warp

inline size_t smem_bytes(int kt, int d1) {
  return sizeof(float) * ((size_t)kt * d1 + 3 * TILE + (size_t)TILE * XSC);
}

template <typename TX>
__global__ void __launch_bounds__(THREADS, 1)  // the grid needs one CTA per SM, at most
fold_kernel(const TX* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ assign, const float* __restrict__ d1,
            const unsigned char* __restrict__ active, long long n, int d, int K, int kt,
            long long tiles, long long stride, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int D1 = d + 1;
  const int k0 = blockIdx.y * kt;
  const int kn = min(kt, K - k0);
  const bool with_err = d1 != nullptr && blockIdx.y == 0;
  float* acc = smem;                                    // [kn][D1]
  float* ws = smem + (size_t)kt * D1;                   // [TILE]
  float* es = ws + TILE;                                // [TILE], w·d1 of active rows, else 0
  int* as = reinterpret_cast<int*>(es + TILE);          // [TILE], local id or -1
  float* xs = ws + 3 * TILE;                            // [TILE][XSC]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int o = t; o < kn * D1; o += THREADS) acc[o] = 0.f;
  float err = 0.f;  // thread ERR_THREAD's running error

  const long long g = gridDim.x;
  const long long tb = tiles * blockIdx.x / g, te = tiles * (blockIdx.x + 1) / g;
  for (long long tile = tb; tile < te; ++tile) {
    const long long r0 = tile * TILE;
    __syncthreads();  // the previous tile is consumed
    for (int e = t; e < TILE; e += THREADS) {
      const long long r = r0 + e;
      const int a = r < n ? assign[r] : -1;
      const float wr = r < n ? w[r] : 0.f;
      as[e] = (wr != 0.f && a >= k0 && a < k0 + kn) ? a - k0 : -1;
      ws[e] = wr;
      if (with_err) {
        const bool act = r < n && wr != 0.f && (active == nullptr || active[r] != 0);
        es[e] = act ? wr * d1[r] : 0.f;
      }
    }
    for (int j0 = 0; j0 < D1; j0 += FC) {
      __syncthreads();  // the previous chunk is consumed, the ids are staged
      for (int e = t; e < TILE * FC; e += THREADS) {
        const int rr = e / FC, jj = e % FC;
        const long long gr = r0 + rr;
        const int gj = j0 + jj;
        xs[rr * XSC + jj] = (gr < n && gj < d) ? to_f(x[gr * d + gj]) : 0.f;
      }
      __syncthreads();
      if (with_err && j0 == 0 && t == ERR_THREAD) {
        // the products are staged, so the walk is one dependent add a row
#pragma unroll 8
        for (int rr = 0; rr < TILE; ++rr) err += es[rr];
      }
      const int j = j0 + lane;
      for (int b = 0; b < TILE; b += 32) {
        const int mine = as[b + lane];
        unsigned m = __ballot_sync(0xffffffffu, mine >= 0 && mine % NWARPS == warp);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          if (j < D1) {
            const int rr = b + src;
            float* p = acc + as[rr] * D1 + j;
            *p = j < d ? fmaf(ws[rr], xs[rr * XSC + lane], *p) : *p + ws[rr];
          }
        }
      }
    }
  }
  __syncthreads();
  float* out = part + (long long)blockIdx.x * stride + (long long)k0 * D1;
  for (int o = t; o < kn * D1; o += THREADS) out[o] = acc[o];
  if (with_err && t == ERR_THREAD) part[(long long)blockIdx.x * stride + (long long)K * D1] = err;
}

// Sums the g partials of stride `stride` in CTA order into sums [K, d],
// counts [K] and, when `err` is given, the error at offset K·(d + 1).
__global__ void reduce_partials(const float* __restrict__ part, int g, long long stride, int K,
                                int d, float* __restrict__ sums, float* __restrict__ counts,
                                float* __restrict__ err) {
  const int D1 = d + 1;
  const long long KD = (long long)K * D1;
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o > KD || (o == KD && err == nullptr)) return;
  float acc = 0.f;
  for (int b = 0; b < g; ++b) acc += part[b * stride + o];
  if (o == KD) {
    *err = acc;
    return;
  }
  const long long k = o / D1;
  const int j = (int)(o - k * D1);
  if (j < d) sums[k * d + j] = acc;
  else counts[k] = acc;
}

// CTAs along the rows for n rows: min(MAX_CTAS, ceil(n / TILE)).
inline int row_ctas(long long n) {
  return (int)std::min<long long>(MAX_CTAS, (n + TILE - 1) / TILE);
}

// Folds and reduces: sums, counts and, given d1 (then err too), err of x
// [n, d] weighted by w under assign. `part` holds row_ctas(n)·(K·(d + 1) +
// (d1 ? 1 : 0)) floats. Needs K >= 1 and d + 1 <= PART_FLOATS. Returns a
// cudaError_t.
template <typename TX>
int fold_and_reduce(const TX* x, const float* w, const int* assign, const float* d1,
                    const unsigned char* active, long long n, int d, int K, float* sums,
                    float* counts, float* err, float* part, cudaStream_t s) {
  const int D1 = d + 1;
  const long long KD = (long long)K * D1;
  const long long stride = KD + (d1 != nullptr ? 1 : 0);
  const int kt = std::min(K, PART_FLOATS / D1);
  const long long tiles = (n + TILE - 1) / TILE;
  const int g = row_ctas(n);
  if (g > 0) {
    const size_t bytes = smem_bytes(kt, D1);
    int rc = (int)cudaFuncSetAttribute(fold_kernel<TX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)g, (unsigned)((K + kt - 1) / kt));
    fold_kernel<TX><<<grid, THREADS, bytes, s>>>(x, w, assign, d1, active, n, d, K, kt, tiles,
                                                  stride, part);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  reduce_partials<<<(unsigned)((stride + 255) / 256), 256, 0, s>>>(part, g, stride, K, d, sums,
                                                                   counts, err);
  return (int)cudaGetLastError();
}

}  // namespace fold
}  // namespace bwkm
