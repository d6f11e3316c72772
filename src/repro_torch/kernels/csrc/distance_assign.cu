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

// dtype codes: 0 = float32, 1 = bfloat16. `rpt`, `kc` and `ctas` are the
// scan's plan (top2.cuh::ScanPlan; 0: the kernel's own choice); a plan that
// does not fit returns cudaErrorInvalidValue and launches nothing. Returns a
// cudaError_t.
extern "C" int bwkm_assign_top2_ex(const void* x, int x_dtype, const void* c, int c_dtype,
                                   long long n, int d, int K, int* assign, float* d1,
                                   float* d2, int rpt, int kc, int ctas, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Assign o{assign, d1, d2, nullptr, nullptr};
  const ScanPlan p{rpt, kc, ctas};
  if (x_dtype == 0 && c_dtype == 0) return launch_top2<float, float>(x, c, n, d, K, o, s, p);
  if (x_dtype == 0) return launch_top2<float, __nv_bfloat16>(x, c, n, d, K, o, s, p);
  if (c_dtype == 0) return launch_top2<__nv_bfloat16, float>(x, c, n, d, K, o, s, p);
  return launch_top2<__nv_bfloat16, __nv_bfloat16>(x, c, n, d, K, o, s, p);
}

// The scan at the kernel's own plan.
extern "C" int bwkm_assign_top2(const void* x, int x_dtype, const void* c, int c_dtype,
                                long long n, int d, int K, int* assign, float* d1,
                                float* d2, void* stream) {
  return bwkm_assign_top2_ex(x, x_dtype, c, c_dtype, n, d, K, assign, d1, d2, 0, 0, 0, stream);
}

// What the scan of every kernel (B1–B3, B5) launches with for plan (rpt,
// kc) over n rows of d features of `xsize` bytes against K slots, written to
// out[0..7]: wide-row form (0/1), rows a thread, rows a tile, kc, the staged
// x tile's bytes, dynamic shared bytes, features per register chunk, row
// tiles. Needs no device; the host's plan (repro_torch.roofline.analysis)
// is held against it. Returns a cudaError_t: cudaErrorInvalidValue for a
// plan the kernels refuse.
extern "C" int bwkm_scan_plan(long long n, int d, int K, int xsize, int rpt, int kc,
                              long long* out) {
  ScanShape s;
  size_t smem = 0;
  bool wide = false;
  const int rc = scan_plan(n, d, K, xsize, ScanPlan{rpt, kc, 0}, &s, &smem, &wide);
  if (rc != 0) return rc;
  out[0] = wide ? 1 : 0;
  out[1] = s.rows / SCAN_THREADS;
  out[2] = s.rows;
  out[3] = s.kc;
  out[4] = s.xbytes;
  out[5] = (long long)smem;
  out[6] = scan_dx(d);
  out[7] = s.tiles;
  return (int)cudaSuccess;
}
