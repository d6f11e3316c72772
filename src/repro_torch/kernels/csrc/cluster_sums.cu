// B4: weighted per-cluster sums and counts for a given assignment.
//
// Replaces repro/kernels/cluster_update.py:cluster_sums_pallas (its
// _kernel). The TPU kernel builds a [rows, K] one-hot tile and contracts it
// with the row block on the MXU into a [K, d] accumulator that stays in VMEM
// across a grid run in order. On Hopper the same work is a scatter of
// n·(d + 1) values, and the per-CTA-partial form of B2 (one [K, d + 1]
// partial per 128 rows) does not scale to it: at n = 5,000,000, K = 2,001,
// d = 19 that scratch would be 6.3 GB. So:
//
//   pass 1 (cluster_sums_kernel): a FIXED grid of at most 128 CTAs along the
//     rows (never derived from the device), each owning a contiguous run of
//     256-row tiles, times ceil(K / kt) CTAs along the clusters. A CTA keeps
//     its [kt, d + 1] partial in shared memory (at most 160 KB). Per tile it
//     stages the ids, weights and a 32-feature chunk of x in shared memory;
//     warp q owns the clusters whose local id is q mod 32 and walks the
//     tile's rows in order (a ballot per 32 rows), its lanes adding one
//     feature each. Every partial element is therefore summed by one thread
//     in row order, with no atomics.
//   pass 2 (reduce_partials): one thread per output sums the partials in CTA
//     order.
//
// Scratch is at most 128·K·(d + 1) floats whatever n is, and two runs are
// bit-equal. Rows with w == 0 add nothing.
//
// What bounds it on an H100: the pass moves each row once (4·d + 8 bytes)
// for d + 1 adds, far under one FLOP per byte, so it is bound by memory:
// about 0.125 ms for 420 MB at x [5,000,000, 19]. Staging the tile keeps
// the scattered adds in shared memory and the global reads coalesced.
#include <algorithm>

#include "top2.cuh"

using namespace bwkm;

namespace {

constexpr int THREADS = 1024;              // 32 warps
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 256;                  // rows staged per step
constexpr int FC = 32;                     // features per staged chunk (one per lane)
constexpr int XSC = FC + 1;                // staged row stride
constexpr int MAX_CTAS = 128;              // CTAs along the rows, at most
constexpr int PART_FLOATS = 40960;         // the shared partial, at most (160 KB)

size_t smem_bytes(int kt, int d1) {
  return sizeof(float) * ((size_t)kt * d1 + 2 * TILE + (size_t)TILE * XSC);
}

template <typename TX>
__global__ void __launch_bounds__(THREADS)
cluster_sums_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ assign, long long n, int d, int K, int kt,
                    long long tiles, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int D1 = d + 1;
  const int k0 = blockIdx.y * kt;
  const int kn = min(kt, K - k0);
  float* acc = smem;                                    // [kn][D1]
  float* ws = smem + (size_t)kt * D1;                   // [TILE]
  int* as = reinterpret_cast<int*>(ws + TILE);          // [TILE], local id or -1
  float* xs = ws + 2 * TILE;                            // [TILE][XSC]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int o = t; o < kn * D1; o += THREADS) acc[o] = 0.f;

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
  float* out = part + ((long long)blockIdx.x * K + k0) * D1;
  for (int o = t; o < kn * D1; o += THREADS) out[o] = acc[o];
}

__global__ void reduce_partials(const float* __restrict__ part, int g, int K, int d,
                                float* __restrict__ sums, float* __restrict__ counts) {
  const int D1 = d + 1;
  const long long KD = (long long)K * D1;
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= KD) return;
  float acc = 0.f;
  for (int b = 0; b < g; ++b) acc += part[b * KD + o];
  const long long k = o / D1;
  const int j = (int)(o - k * D1);
  if (j < d) sums[k * d + j] = acc;
  else counts[k] = acc;
}

template <typename TX>
int launch(const void* x, const float* w, const int* assign, long long n, int d, int K,
           float* sums, float* counts, float* part, cudaStream_t s) {
  const int D1 = d + 1;
  const int kt = std::min(K, PART_FLOATS / D1);
  const long long tiles = (n + TILE - 1) / TILE;
  const int g = (int)std::min<long long>(MAX_CTAS, tiles);
  if (g > 0) {
    const size_t bytes = smem_bytes(kt, D1);
    int rc = (int)cudaFuncSetAttribute(cluster_sums_kernel<TX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)g, (unsigned)((K + kt - 1) / kt));
    cluster_sums_kernel<TX><<<grid, THREADS, bytes, s>>>(static_cast<const TX*>(x), w, assign,
                                                          n, d, K, kt, tiles, part);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const long long KD = (long long)K * D1;
  reduce_partials<<<(unsigned)((KD + 255) / 256), 256, 0, s>>>(part, g, K, d, sums, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// sums [K, d] and counts [K] of x [n, d] under assign [n] (ids outside
// [0, K) add nothing). `part` holds min(128, ceil(n/256))·K·(d + 1) floats
// of scratch; d + 1 must be at most 40,960. dtype codes: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t.
extern "C" int bwkm_cluster_sums(const void* x, int x_dtype, const float* w, const int* assign,
                                 long long n, int d, int K, float* sums, float* counts,
                                 float* part, void* stream) {
  if (K < 1 || d < 1 || d + 1 > PART_FLOATS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float>(x, w, assign, n, d, K, sums, counts, part, s);
  return launch<__nv_bfloat16>(x, w, assign, n, d, K, sums, counts, part, s);
}
