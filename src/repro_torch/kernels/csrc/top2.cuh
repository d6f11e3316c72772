// Shared device code of the distance kernels: the per-row tile scan, and
// the top-2 reducer of the assignment kernels.
//
// One CTA owns ROWS consecutive rows, one row per thread. Centroids are
// scanned in tiles of KT in increasing id; inside a tile the feature axis is
// walked in chunks of DC, staging the x chunk [ROWS, DC] in shared memory
// (row stride DC + 1, odd, so a warp reading one column of the x chunk hits
// 32 different banks; staged once when d fits one chunk) and the centroid
// chunk transposed, [DC][KT], so the inner loop reads four centroids per
// 16-byte broadcast load for every four FMAs. Each thread keeps the KT
// partial dot products of its row in registers, so shared memory stays
// fixed whatever d is.
//
// Distance: ‖x‖² − 2·x·c + ‖c‖² in f32 with FMA, clamped at 0, as the plain
// version in repro_torch/kernels/ref.py computes it. Each tile's distances
// go, in increasing id, to the caller's per-row reducer: Top2 below for
// B1–B3, a running min for B5. A centroid whose `cmask` entry is 0 (B5's
// invalid candidates) gets ‖c‖² = +inf, so its distance is +inf and never
// wins.
//
// The top-2 rule: when dist < d1 the old d1 shifts into d2; else when
// dist < d2 it becomes d2. Ties therefore go to the smallest id and a
// duplicate centroid gives d2 == d1. d2 stays at BIG when K == 1; callers
// store it as +inf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bwkm {

constexpr int ROWS = 128;   // rows per CTA = threads per CTA
constexpr int KT = 32;      // centroids per tile (register dot products)
constexpr int DC = 32;      // features per staged chunk
constexpr int XS = DC + 1;  // shared-memory row stride of the x chunk
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Top2 {
  int a;
  float d1;
  float d2;

  __device__ __forceinline__ void operator()(int k, float dist) {
    if (dist < d1) {
      d2 = d1;
      d1 = dist;
      a = k;
    } else if (dist < d2) {
      d2 = dist;
    }
  }
};

// Feeds `visit(k, dist)` the row's distance to every centroid k < K, in
// increasing k. Every thread of the CTA must call this (it synchronises).
// Rows past n compute on zeros and are discarded by the caller. `cmask`
// may be null (no centroid masked).
template <typename TX, typename TC, typename Visit>
__device__ __forceinline__ void scan_rows(const TX* __restrict__ x, const TC* __restrict__ c,
                                          const float* __restrict__ cmask, long long n, int d,
                                          int K, long long row0, Visit& visit) {
  __shared__ float xs[ROWS * XS];
  __shared__ __align__(16) float cs[DC * KT];  // cs[jj * KT + kk]
  __shared__ float cns[KT];
  const int t = threadIdx.x;
  float xn = 0.f;
  for (int k0 = 0; k0 < K; k0 += KT) {
    float dots[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) dots[kk] = 0.f;
    float cn = 0.f;
    for (int j0 = 0; j0 < d; j0 += DC) {
      __syncthreads();  // previous chunk fully consumed
      if (k0 == 0 || d > DC) {
        for (int e = t; e < ROWS * DC; e += ROWS) {
          const int rr = e / DC, jj = e % DC;
          const long long gr = row0 + rr;
          const int gj = j0 + jj;
          xs[rr * XS + jj] = (gr < n && gj < d) ? to_f(x[gr * d + gj]) : 0.f;
        }
      }
      // consecutive threads store consecutive words: no bank conflicts
      for (int e = t; e < KT * DC; e += ROWS) {
        const int kk = e % KT, jj = e / KT;
        const int gk = k0 + kk, gj = j0 + jj;
        cs[e] = (gk < K && gj < d) ? to_f(c[(long long)gk * d + gj]) : 0.f;
      }
      __syncthreads();
      const int jn = min(DC, d - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float xv = xs[t * XS + jj];
        if (k0 == 0) xn = fmaf(xv, xv, xn);
        const float4* cr = reinterpret_cast<const float4*>(cs + jj * KT);
#pragma unroll
        for (int q = 0; q < KT / 4; ++q) {
          const float4 cv = cr[q];
          dots[4 * q + 0] = fmaf(xv, cv.x, dots[4 * q + 0]);
          dots[4 * q + 1] = fmaf(xv, cv.y, dots[4 * q + 1]);
          dots[4 * q + 2] = fmaf(xv, cv.z, dots[4 * q + 2]);
          dots[4 * q + 3] = fmaf(xv, cv.w, dots[4 * q + 3]);
        }
      }
      if (t < KT) {
        for (int jj = 0; jj < jn; ++jj) cn = fmaf(cs[jj * KT + t], cs[jj * KT + t], cn);
      }
    }
    if (t < KT) {
      const bool masked = cmask != nullptr && k0 + t < K && cmask[k0 + t] == 0.f;
      cns[t] = masked ? __int_as_float(0x7f800000) : cn;
    }
    __syncthreads();
    const int kn = min(KT, K - k0);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk < kn) visit(k0 + kk, fmaxf(xn - 2.f * dots[kk] + cns[kk], 0.f));
    }
  }
}

template <typename TX, typename TC>
__device__ __forceinline__ Top2 row_top2(const TX* __restrict__ x, const TC* __restrict__ c,
                                         long long n, int d, int K, long long row0) {
  Top2 r{0, BIG, BIG};
  scan_rows(x, c, nullptr, n, d, K, row0, r);
  return r;
}

}  // namespace bwkm
