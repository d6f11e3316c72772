// B2 and B3: one weighted Lloyd pass, dense or drift-bound pruned.
//
// Replaces repro/kernels/fused_assign_update.py:fused_assign_update_pallas
// (its _kernel, B2) and fused_assign_update_pruned_pallas (its
// _pruned_kernel, B3). The TPU kernels keep the [K, d] statistics in VMEM
// across a sequential grid; CTAs on Hopper run in no order and share no
// memory, so the statistics take the deterministic split-K form instead:
//
//   pass 1 (assign_update_kernel): each CTA owns 128 rows, runs the top-2
//     scan of top2.cuh, then writes a partial [K, d + 1] (sums and the
//     count column) and a partial error, summing its rows in row order.
//   pass 2 (reduce_partials): one thread per output sums the partials over
//     CTAs in CTA order.
//
// No float atomics anywhere, so two runs are bit-equal. The pruned form is
// the same kernel with a cached assignment and an active mask: a CTA whose
// rows are all inactive (its any-active flag, __syncthreads_or) skips the
// distance scan and keeps the cached ids; every CTA then folds statistics
// under the composed assignment through the same instructions and the same
// row-to-CTA mapping, so pruned statistics are bit-identical to dense ones
// whenever the assignments agree. The error covers active rows only.
//
// What bounds it on an H100: at the partition's shapes (≤ 14,528 rows,
// d = 19, K = 27) x is about 1 MB, so the pass is bound by launch latency
// and by the serial per-CTA loops, not by HBM or FLOPs; 2·K·d FLOP per row
// for the distances plus K·(d + 1) compares per row for the statistics.
#include "top2.cuh"

using namespace bwkm;

template <typename TX, typename TC>
__global__ void __launch_bounds__(ROWS)
assign_update_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                     const TC* __restrict__ c, const int* __restrict__ cached,
                     const unsigned char* __restrict__ active, long long n, int d, int K,
                     int* __restrict__ assign, float* __restrict__ d1o,
                     float* __restrict__ d2o, float* __restrict__ part,
                     float* __restrict__ errpart) {
  __shared__ int as[ROWS];
  __shared__ float ws[ROWS];
  __shared__ float es[ROWS];
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const long long row = row0 + t;
  const bool valid = row < n;
  const bool pruned = cached != nullptr;
  const bool act = valid && (!pruned || active[row] != 0);
  const int any_active = pruned ? __syncthreads_or(act) : 1;

  Top2 r{0, BIG, BIG};
  if (any_active) r = row_top2(x, c, n, d, K, row0);  // uniform over the CTA
  int a = r.a;
  if (pruned && !act) a = valid ? cached[row] : 0;
  if (valid) {
    assign[row] = a;
    d1o[row] = r.d1;
    d2o[row] = r.d2 >= BIG ? __int_as_float(0x7f800000) : r.d2;
  }
  as[t] = valid ? a : -1;
  ws[t] = valid ? w[row] : 0.f;
  es[t] = act ? r.d1 : 0.f;
  __syncthreads();

  // Per-CTA statistics, each output summed over the CTA's rows in row order.
  const int D1 = d + 1;
  const int KD = K * D1;
  float* __restrict__ p = part + (long long)blockIdx.x * KD;
  for (int o = t; o < KD; o += ROWS) {
    const int k = o / D1, j = o - k * D1;
    float acc = 0.f;
    for (int rr = 0; rr < ROWS; ++rr) {
      const float wr = ws[rr];
      if (as[rr] == k && wr != 0.f) {
        acc = j < d ? fmaf(wr, to_f(x[(row0 + rr) * d + j]), acc) : acc + wr;
      }
    }
    p[o] = acc;
  }
  if (t == 0) {
    float acc = 0.f;
    for (int rr = 0; rr < ROWS; ++rr) {
      if (ws[rr] != 0.f) acc = fmaf(ws[rr], es[rr], acc);
    }
    errpart[blockIdx.x] = acc;
  }
}

__global__ void reduce_partials(const float* __restrict__ part,
                                const float* __restrict__ errpart, long long nb, int K,
                                int d, float* __restrict__ sums, float* __restrict__ counts,
                                float* __restrict__ err) {
  const int D1 = d + 1;
  const int KD = K * D1;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o < KD) {
    float acc = 0.f;
    for (long long b = 0; b < nb; ++b) acc += part[b * KD + o];
    const int k = o / D1, j = o - k * D1;
    if (j < d) sums[k * d + j] = acc;
    else counts[k] = acc;
  } else if (o == KD) {
    float acc = 0.f;
    for (long long b = 0; b < nb; ++b) acc += errpart[b];
    *err = acc;
  }
}

template <typename TX, typename TC>
static void launch(const void* x, const float* w, const void* c, const int* cached,
                   const unsigned char* active, long long n, int d, int K, int* assign,
                   float* d1, float* d2, float* part, float* errpart, cudaStream_t s) {
  const long long nb = (n + ROWS - 1) / ROWS;
  if (nb > 0) {
    assign_update_kernel<TX, TC><<<(unsigned)nb, ROWS, 0, s>>>(
        static_cast<const TX*>(x), w, static_cast<const TC*>(c), cached, active, n, d, K,
        assign, d1, d2, part, errpart);
  }
}

// One dense (cached == active == nullptr) or pruned pass. `part` holds
// ceil(n/128)·K·(d+1) floats and `errpart` ceil(n/128) floats of scratch.
// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int bwkm_assign_update(const void* x, int x_dtype, const float* w, const void* c,
                                  int c_dtype, const int* cached,
                                  const unsigned char* active, long long n, int d, int K,
                                  int* assign, float* d1, float* d2, float* sums,
                                  float* counts, float* err, float* part, float* errpart,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && c_dtype == 0)
    launch<float, float>(x, w, c, cached, active, n, d, K, assign, d1, d2, part, errpart, s);
  else if (x_dtype == 0)
    launch<float, __nv_bfloat16>(x, w, c, cached, active, n, d, K, assign, d1, d2, part,
                                 errpart, s);
  else if (c_dtype == 0)
    launch<__nv_bfloat16, float>(x, w, c, cached, active, n, d, K, assign, d1, d2, part,
                                 errpart, s);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, c, cached, active, n, d, K, assign, d1, d2,
                                         part, errpart, s);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long nb = (n + ROWS - 1) / ROWS;
  const int outs = K * (d + 1) + 1;
  reduce_partials<<<(outs + 255) / 256, 256, 0, s>>>(part, errpart, nb, K, d, sums, counts,
                                                     err);
  return (int)cudaGetLastError();
}
