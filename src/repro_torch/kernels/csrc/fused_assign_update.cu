// B2 and B3: one weighted Lloyd pass, dense or drift-bound pruned.
//
// Replaces repro/kernels/fused_assign_update.py:fused_assign_update_pallas
// (its _kernel, B2) and fused_assign_update_pruned_pallas (its
// _pruned_kernel, B3). The TPU kernels keep the [K, d] statistics in VMEM
// across a sequential grid; CTAs on Hopper run in no order and share no
// memory, so the pass is three launches:
//
//   1. scan: the persistent top-2 scan of top2.cuh, the one B1 runs
//      (candidates resident in shared memory, rows blocked in registers),
//      writing assign, d1 and d2, nothing else.
//   2. fold (cluster_fold.cuh, the code B4 runs): a fixed grid of at most
//      128 CTAs along the rows, each streaming its contiguous run of 256-row
//      tiles through a ring of TMA-filled stages and adding them in row order
//      into a [K, d + 1] partial in shared memory, and the error Σ w·d1 over
//      the active rows, one thread adding the products in row order.
//   3. reduce: one thread per output adds the ≤ 128 partials in CTA order.
//
// Scratch is min(128, ceil(n/256))·(K·(d + 1) + 1) floats whatever n is
// (5.7 MB at the k-means|| weighting pass, K = 561, d = 19). No float
// atomics anywhere, so two runs are bit-equal.
//
// The pruned form is the same three launches given a cached assignment and
// an active mask: a scan row tile whose rows are all inactive (its
// any-active flag, __syncthreads_or) skips the distance scan and writes the
// cached ids; the scan writes the composed assignment either way. The fold
// then reads that composed assignment through the same instructions and the
// same row-to-CTA mapping for dense and pruned, so pruned sums and counts
// are bit for bit the dense ones whenever the assignments agree. The error
// covers active rows only.
//
// What bounds it on an H100: the scan does 2·K·d FLOP per row against
// 4·d + 16 bytes, so at the weighting pass (x [5,000,000, 19], K = 561) it
// is bound by operations (1.7 ms at the f32 peak), and at the partition's
// shapes (≤ 14,528 rows, K = 27) by launch latency. The fold is bound by
// memory. Scan and fold stay apart rather than one persistent kernel: the
// fold's 1,024-thread CTAs and their shared partial would take the shared
// memory the scan keeps its candidates in, while reading x a second time
// costs about 0.13 ms of HBM at 5,000,000 × 19 f32.
#include "cluster_fold.cuh"

using namespace bwkm;

template <typename TX, typename TC>
static int launch(const void* x, const float* w, const void* c, const int* cached,
                  const unsigned char* active, long long n, int d, int K, int* assign,
                  float* d1, float* d2, float* sums, float* counts, float* err, float* part,
                  cudaStream_t s, const ScanPlan& sp, const fold::FoldPlan& fp) {
  // check both plans before anything launches
  ScanShape shape;
  size_t smem = 0;
  bool wide = false;
  int rc = scan_plan(n, d, K, (int)sizeof(TX), sp, &shape, &smem, &wide);
  fold::Shape fs;
  if (rc == 0)
    rc = fold::fold_plan(n, d, K, (int)sizeof(TX), true, active != nullptr, fp, &fs);
  if (rc != 0) return rc;
  if (n > 0) {
    rc = launch_top2<TX, TC>(x, c, n, d, K, Assign{assign, d1, d2, cached, active}, s, sp);
    if (rc != 0) return rc;
  }
  return fold::fold_and_reduce(static_cast<const TX*>(x), w, assign, d1, active, n, d, K, sums,
                               counts, err, part, s, fp);
}

// One dense (cached == active == nullptr) or pruned pass. `part` holds
// min(128, ceil(n/256))·(K·(d + 1) + 1) floats of scratch. dtype codes:
// 0 = float32, 1 = bfloat16. `rpt`, `kc`, `ctas` are the scan's plan
// (top2.cuh::ScanPlan), `kt`, `cw`, `stages` the fold's
// (cluster_fold.cuh::FoldPlan); 0 is the kernel's own choice, and a plan
// that does not fit returns cudaErrorInvalidValue before anything launches.
// Returns a cudaError_t.
extern "C" int bwkm_assign_update_ex(const void* x, int x_dtype, const float* w, const void* c,
                                     int c_dtype, const int* cached,
                                     const unsigned char* active, long long n, int d, int K,
                                     int* assign, float* d1, float* d2, float* sums,
                                     float* counts, float* err, float* part, int rpt, int kc,
                                     int ctas, int kt, int cw, int stages, void* stream) {
  if (K < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScanPlan sp{rpt, kc, ctas};
  const fold::FoldPlan fp{kt, cw, stages};
  if (x_dtype == 0 && c_dtype == 0)
    return launch<float, float>(x, w, c, cached, active, n, d, K, assign, d1, d2, sums, counts,
                                err, part, s, sp, fp);
  if (x_dtype == 0)
    return launch<float, __nv_bfloat16>(x, w, c, cached, active, n, d, K, assign, d1, d2, sums,
                                        counts, err, part, s, sp, fp);
  if (c_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, c, cached, active, n, d, K, assign, d1, d2, sums,
                                        counts, err, part, s, sp, fp);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, c, cached, active, n, d, K, assign, d1, d2,
                                              sums, counts, err, part, s, sp, fp);
}

// The pass at the kernels' own plans.
extern "C" int bwkm_assign_update(const void* x, int x_dtype, const float* w, const void* c,
                                  int c_dtype, const int* cached,
                                  const unsigned char* active, long long n, int d, int K,
                                  int* assign, float* d1, float* d2, float* sums,
                                  float* counts, float* err, float* part, void* stream) {
  return bwkm_assign_update_ex(x, x_dtype, w, c, c_dtype, cached, active, n, d, K, assign, d1,
                               d2, sums, counts, err, part, 0, 0, 0, 0, 0, 0, stream);
}
