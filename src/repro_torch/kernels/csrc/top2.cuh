// Shared device code of the assignment kernels: the per-row top-2 scan.
//
// One CTA owns ROWS consecutive rows, one row per thread. Centroids are
// scanned in tiles of KT in increasing id; inside a tile the feature axis is
// walked in chunks of DC, staging the x chunk [ROWS, DC] and the centroid
// chunk [KT, DC] in shared memory (row stride DC + 1, odd, so a warp reading
// one column of the x chunk hits 32 different banks; centroid reads are
// broadcasts). Each thread keeps the KT partial dot products of its row in
// registers, so shared memory stays fixed whatever d is.
//
// Distance: ‖x‖² − 2·x·c + ‖c‖² in f32 with FMA, clamped at 0, as the plain
// version in repro_torch/kernels/ref.py computes it. The top-2 rule: when
// dist < d1 the old d1 shifts into d2; else when dist < d2 it becomes d2.
// Ties therefore go to the smallest id and a duplicate centroid gives
// d2 == d1. d2 stays at BIG when K == 1; callers store it as +inf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bwkm {

constexpr int ROWS = 128;   // rows per CTA = threads per CTA
constexpr int KT = 32;      // centroids per tile (register dot products)
constexpr int DC = 32;      // features per staged chunk
constexpr int XS = DC + 1;  // shared-memory row stride
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Top2 {
  int a;
  float d1;
  float d2;
};

// Every thread of the CTA must call this (it synchronises). Rows past n
// compute on zeros and are discarded by the caller.
template <typename TX, typename TC>
__device__ Top2 row_top2(const TX* __restrict__ x, const TC* __restrict__ c,
                         long long n, int d, int K, long long row0) {
  __shared__ float xs[ROWS * XS];
  __shared__ float cs[KT * XS];
  __shared__ float cns[KT];
  const int t = threadIdx.x;
  float xn = 0.f;
  Top2 r{0, BIG, BIG};
  for (int k0 = 0; k0 < K; k0 += KT) {
    float dots[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) dots[kk] = 0.f;
    float cn = 0.f;
    for (int j0 = 0; j0 < d; j0 += DC) {
      __syncthreads();  // previous chunk fully consumed
      for (int e = t; e < ROWS * DC; e += ROWS) {
        const int rr = e / DC, jj = e % DC;
        const long long gr = row0 + rr;
        const int gj = j0 + jj;
        xs[rr * XS + jj] = (gr < n && gj < d) ? to_f(x[gr * d + gj]) : 0.f;
      }
      for (int e = t; e < KT * DC; e += ROWS) {
        const int kk = e / DC, jj = e % DC;
        const int gk = k0 + kk, gj = j0 + jj;
        cs[kk * XS + jj] = (gk < K && gj < d) ? to_f(c[(long long)gk * d + gj]) : 0.f;
      }
      __syncthreads();
      const int jn = min(DC, d - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float xv = xs[t * XS + jj];
        if (k0 == 0) xn = fmaf(xv, xv, xn);
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) dots[kk] = fmaf(xv, cs[kk * XS + jj], dots[kk]);
      }
      if (t < KT) {
        for (int jj = 0; jj < jn; ++jj) cn = fmaf(cs[t * XS + jj], cs[t * XS + jj], cn);
      }
    }
    if (t < KT) cns[t] = cn;
    __syncthreads();
    const int kn = min(KT, K - k0);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk < kn) {
        const float dist = fmaxf(xn - 2.f * dots[kk] + cns[kk], 0.f);
        if (dist < r.d1) {
          r.d2 = r.d1;
          r.d1 = dist;
          r.a = k0 + kk;
        } else if (dist < r.d2) {
          r.d2 = dist;
        }
      }
    }
  }
  return r;
}

}  // namespace bwkm
