// B1: per-row argmin, closest and second-closest squared distance.
//
// Replaces repro/kernels/distance_assign.py:assign_top2_pallas (its _kernel).
// The TPU kernel walks a (row block, centroid tile) grid in order and keeps
// the running top-2 in VMEM across centroid tiles. Here one persistent
// launch of the scan in top2.cuh does the whole pass: each CTA holds the
// centroids in shared memory for the launch, walks row tiles with a grid
// stride, and keeps each row's top-2 in registers while it sees every
// centroid; CTAs share nothing.
//
// What bounds it on an H100: it does 2·K·d FLOP per row against 4·d + 12
// bytes. At the predict chunk (65,536 rows, d = 19, K = 27, about 11 FLOP
// per byte) that is memory and launch latency: one row per thread there,
// so the chunk still spreads over the card. At the k-means|| weighting pass
// (5,000,000 rows, K = 2,001) it is f32 operations: four rows per thread
// against four centroids per shared load, about 16 FFMA per load, plus
// the top-2 compares of each (row, centroid). The design reads x once and
// never writes the n×K distance matrix. Rows too wide for four resident
// centroids (d > 14,432) take the scan's wide-row form, correct and slow.
#include "top2.cuh"

using namespace bwkm;

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int bwkm_assign_top2(const void* x, int x_dtype, const void* c, int c_dtype,
                                long long n, int d, int K, int* assign, float* d1,
                                float* d2, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Assign o{assign, d1, d2, nullptr, nullptr};
  if (x_dtype == 0 && c_dtype == 0) return launch_top2<float, float>(x, c, n, d, K, o, s);
  if (x_dtype == 0) return launch_top2<float, __nv_bfloat16>(x, c, n, d, K, o, s);
  if (c_dtype == 0) return launch_top2<__nv_bfloat16, float>(x, c, n, d, K, o, s);
  return launch_top2<__nv_bfloat16, __nv_bfloat16>(x, c, n, d, K, o, s);
}
