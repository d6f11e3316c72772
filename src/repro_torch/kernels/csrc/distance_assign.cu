// B1: per-row argmin, closest and second-closest squared distance.
//
// Replaces repro/kernels/distance_assign.py:assign_top2_pallas (its _kernel).
// The TPU kernel walks a (row block, centroid tile) grid in order and keeps
// the running top-2 in VMEM across centroid tiles; here the centroid loop is
// inside one CTA (row_top2 in top2.cuh) and CTAs share nothing, so no
// cross-CTA state exists.
//
// What bounds it on an H100: at the main path's shapes (d = 19, K = 27) it
// does 2·K·d ≈ 1 kFLOP per row against 4·d + 12 bytes of traffic, about 11
// FLOP/byte, so it is bound by memory and by launch latency at the small row
// counts of the partition (≤ 14,528 rows). The design reads x once, keeps
// the n×K distance matrix in registers, and writes 12 bytes per row.
#include "top2.cuh"

using namespace bwkm;

template <typename TX, typename TC>
__global__ void __launch_bounds__(ROWS)
assign_top2_kernel(const TX* __restrict__ x, const TC* __restrict__ c, long long n, int d,
                   int K, int* __restrict__ assign, float* __restrict__ d1,
                   float* __restrict__ d2) {
  const long long row0 = (long long)blockIdx.x * ROWS;
  const Top2 r = row_top2(x, c, n, d, K, row0);
  const long long row = row0 + threadIdx.x;
  if (row < n) {
    assign[row] = r.a;
    d1[row] = r.d1;
    d2[row] = r.d2 >= BIG ? __int_as_float(0x7f800000) : r.d2;
  }
}

template <typename TX, typename TC>
static void launch(const void* x, const void* c, long long n, int d, int K, int* assign,
                   float* d1, float* d2, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + ROWS - 1) / ROWS);
  assign_top2_kernel<TX, TC><<<blocks, ROWS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TC*>(c), n, d, K, assign, d1, d2);
}

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int bwkm_assign_top2(const void* x, int x_dtype, const void* c, int c_dtype,
                                long long n, int d, int K, int* assign, float* d1,
                                float* d2, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && c_dtype == 0) launch<float, float>(x, c, n, d, K, assign, d1, d2, s);
  else if (x_dtype == 0) launch<float, __nv_bfloat16>(x, c, n, d, K, assign, d1, d2, s);
  else if (c_dtype == 0) launch<__nv_bfloat16, float>(x, c, n, d, K, assign, d1, d2, s);
  else launch<__nv_bfloat16, __nv_bfloat16>(x, c, n, d, K, assign, d1, d2, s);
  return (int)cudaGetLastError();
}
