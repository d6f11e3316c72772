// Shared device code of the statistics kernels: the deterministic per-CTA
// fold of weighted cluster sums and counts, and the CTA-order reduction of
// its partials. B4 (cluster_sums.cu) and the statistics of B2/B3
// (fused_assign_update.cu) both run it, so the code exists once.
//
//   fold_kernel: a FIXED grid of at most MAX_CTAS CTAs along the rows (never
//     derived from the device), each owning a contiguous run of TILE-row
//     tiles, times ceil(K / kt) CTAs along the clusters, times ceil((d + 1)
//     / cw) along the columns (the d features, then the count). A CTA keeps
//     its [kt, cw] partial in dynamic shared memory (at most PART_FLOATS
//     floats): every shape whose d + 1 fits takes one column chunk, and the
//     last chunk carries the count column.
//
//     Its rows are one contiguous byte range of x, w and assign (and d1 and
//     active when the error is folded), streamed through a ring of 2 to
//     MAX_STAGES stages of one tile each in the shared memory the partial
//     leaves. One thread (PRODUCER) issues each tile as one TMA bulk copy
//     per array (the bytes outside whole 16-byte chunks one by one),
//     completing on that stage's transaction barrier, stages − 1 tiles
//     ahead of the walk, so no warp spends issue slots or load queue on the
//     copies. x stays in its natural [rows, d] layout; rows too wide for two
//     stages are read from global memory by the walk instead.
//
//     Per tile, two CTA barriers. After the first, eight warps route the
//     tile once: each row's local cluster id and owner warp (id mod 31),
//     then, through a per-batch mask of each owner's rows (atomicOr, so the
//     set does not depend on the order), the rows sorted by owner, in row
//     order within an owner. After the second, warp q < 31 walks its own
//     rows in order, a lane per column: a column's running sum stays in a
//     register while consecutive rows of the warp hit the same cluster (at
//     K <= 31 that is every row) and goes through the shared partial when
//     the cluster changes. Every partial element is therefore summed by one
//     thread in row order, with no atomics on floats. Meanwhile PRODUCER
//     issues the next copy and, given `d1` (the CTAs of the first cluster
//     tile and column chunk), adds the error Σ w·d1 over the active rows
//     (every row when `active` is null): the routing warps round the
//     products, it adds them in row order (+0 for the tile's other rows).
//   reduce_partials: one thread per output sums the partials in CTA order,
//     16 loads in flight before their adds.
//
// CTA b's partial starts at part + b·stride: K·(d + 1) floats (cluster k's
// sums, then its count, at k·(d + 1)), then the error at K·(d + 1) when it
// is folded. Rows with w == 0 and ids outside [0, K) add nothing. Scratch is
// at most MAX_CTAS·stride floats whatever n is, and two runs are bit-equal:
// each element is summed in an order that depends only on x, w, the ids
// (and d1, active) and the fixed row-to-CTA mapping, not on the stages, the
// routing or the cluster and column tiling (fmaf(w, x, acc) for a sum,
// acc + w for a count, the error's rounded products added from +0), so
// the fold may be rebuilt without moving a bit, as `chip_smoke.py
// --parent` checks.
#pragma once

#include <algorithm>

#include "top2.cuh"

namespace bwkm {
namespace fold {

constexpr int THREADS = 1024;       // 32 warps
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 256;           // rows of a tile: the unit of the row mapping and of a stage
constexpr int MAX_CTAS = 128;       // CTAs along the rows, at most
constexpr int PART_FLOATS = 40960;  // the shared partial, at most (160 KB)
constexpr int SMEM = 232448;        // dynamic shared bytes of a CTA, at most
constexpr int MAX_STAGES = 4;
constexpr int OWNERS = NWARPS - 1;      // warps that walk rows
constexpr int PRODUCER = THREADS - 32;  // lane 0 of the last warp: the copies and the error
constexpr int BATCHES = TILE / 32;      // 32-row batches of a tile, one routing warp each
// the kernel's static shared arrays: the routing, and a barrier per stage
constexpr int STATIC_SMEM = 8 * TILE + 4 * TILE + 8 * 32 * BATCHES + 8 * 32 + 8 * MAX_STAGES;

// Shared bytes a span of `bytes` bytes takes, staged at its offset from
// 16-byte alignment.
inline long long span_bytes(long long bytes) { return (bytes + 15 + 15) / 16 * 16; }

// What one launch of the fold covers, fixed on the host by fold_shape.
struct Shape {
  long long n;       // rows
  long long tiles;   // TILE-row tiles
  long long stride;  // floats of a CTA's partial: K·(d + 1), and the error
  int d, K;
  int kt;            // clusters per cluster tile
  int cw;            // columns per column chunk
  int stages;        // tiles in the ring
  int xstaged;       // x is staged; else the walk reads it from global memory
  int sbytes;        // bytes of one stage
  int io, wo, eo, ao;  // offsets in a stage of the ids, w, d1 and active (x at 0)
  int pbytes;        // bytes of the partial, before the ring
  int smem;          // dynamic shared bytes
};

// A fold's plan as the host passes it: clusters and columns of a CTA's
// shared partial (kt, cw: both 0, or both given with kt·cw <= PART_FLOATS)
// and tiles in the ring (2 to MAX_STAGES). 0 is the kernel's own choice.
// None of them changes a bit: every partial element is summed in row order
// by one thread whatever the tiling and the ring. The row grid, row_ctas(n)
// CTAs summed in CTA order, is not a knob.
struct FoldPlan {
  int kt;
  int cw;
  int stages;
};

// The fold of n rows of d features of `xsize` bytes into K clusters, with
// the error (`err`) and an active mask (`act`), in [kt, cw] partials.
inline Shape fold_shape_at(long long n, int d, int K, int xsize, bool err, bool act, int kt,
                           int cw) {
  Shape s;
  s.n = n;
  s.d = d;
  s.K = K;
  s.tiles = (n + TILE - 1) / TILE;
  s.stride = (long long)K * (d + 1) + (err ? 1 : 0);
  s.cw = cw;
  s.kt = kt;
  s.pbytes = (4 * s.kt * s.cw + 15) / 16 * 16;
  const long long xb = span_bytes((long long)TILE * d * xsize);
  const int fb = (int)span_bytes(4 * TILE);
  const int rest = 2 * fb + (err ? fb : 0) + (act ? (int)span_bytes(TILE) : 0);
  const int budget = SMEM - STATIC_SMEM - s.pbytes;
  s.xstaged = 2 * (xb + rest) <= budget;
  const int x0 = s.xstaged ? (int)xb : 0;
  s.io = x0;
  s.wo = x0 + fb;
  s.eo = x0 + 2 * fb;
  s.ao = s.eo + (err ? fb : 0);
  s.sbytes = x0 + rest;
  // no more stages than a CTA's tiles need: a smaller ring keeps the
  // launch cheap where each CTA has one tile (the partition's 14,528 rows)
  const long long g = std::min<long long>(MAX_CTAS, s.tiles);
  const long long per_cta = g > 0 ? (s.tiles + g - 1) / g : 1;
  s.stages = (int)std::min<long long>(std::min(MAX_STAGES, budget / s.sbytes), per_cta + 1);
  s.smem = s.pbytes + s.stages * s.sbytes;
  return s;
}

// The same with the partial capped at `part_floats` floats (0, or anything
// above PART_FLOATS: PART_FLOATS): one column chunk where d + 1 fits, as
// many clusters as fit beside it. A smaller cap only tiles the clusters and
// columns more finely, which leaves every bit as it is.
inline Shape fold_shape(long long n, int d, int K, int xsize, bool err, bool act,
                        int part_floats) {
  const int cap = part_floats > 0 ? std::min(part_floats, PART_FLOATS) : PART_FLOATS;
  const int cw = std::min(d + 1, cap);
  return fold_shape_at(n, d, K, xsize, err, act, std::max(1, std::min(K, cap / cw)), cw);
}

// Fills `s` for plan `p`, or returns cudaErrorInvalidValue for a plan that
// does not fit: a partial outside [1, K] × [1, d + 1] or past PART_FLOATS,
// stages outside [2, MAX_STAGES] or past the shared memory the partial
// leaves, a negative knob. It never adjusts a plan.
inline int fold_plan(long long n, int d, int K, int xsize, bool err, bool act, const FoldPlan& p,
                     Shape* s) {
  const int bad = (int)cudaErrorInvalidValue;
  if (K < 1 || d < 1 || n < 0 || p.kt < 0 || p.cw < 0 || p.stages < 0) return bad;
  if ((p.kt == 0) != (p.cw == 0)) return bad;
  if (p.kt == 0) {
    *s = fold_shape(n, d, K, xsize, err, act, 0);
  } else {
    if (p.kt > K || p.cw > d + 1 || (long long)p.kt * p.cw > PART_FLOATS) return bad;
    *s = fold_shape_at(n, d, K, xsize, err, act, p.kt, p.cw);
  }
  if (p.stages != 0) {
    if (p.stages < 2 || p.stages > MAX_STAGES ||
        (long long)p.stages * s->sbytes > SMEM - STATIC_SMEM - s->pbytes)
      return bad;
    s->stages = p.stages;
    s->smem = s->pbytes + s->stages * s->sbytes;
  }
  return (int)cudaSuccess;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A stage's barrier: armed once per tile by the thread that issues the
// tile's copies, with the bytes they will bring.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase `parity` has completed. A copy that never
// lands would hang the card, so after about 8 s the kernel traps instead.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// A contiguous byte range [b0, b0 + bytes) of global memory, staged at its
// offset from 16-byte alignment: its whole 16-byte chunks [h, e) go by one
// TMA bulk copy, the bytes before and after them one by one, so nothing
// outside the range is read.
struct Span {
  uintptr_t b0, b1, h, e;

  __device__ __forceinline__ Span(const void* src, long long bytes) {
    b0 = reinterpret_cast<uintptr_t>(src);
    b1 = b0 + (uintptr_t)bytes;
    h = min((b0 + 15) & ~uintptr_t(15), b1);  // the head ends here
    e = max(b1 & ~uintptr_t(15), h);          // the tail starts here
  }
  __device__ __forceinline__ unsigned bulk() const { return (unsigned)(e - h); }
  // Copies into `buf`, completing the bulk part on the barrier `bar`.
  __device__ __forceinline__ void copy(unsigned char* buf, unsigned bar) const {
    unsigned char* dst = buf - (b0 & ~uintptr_t(15));
    if (e > h)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(dst + h)),
          "l"(h), "r"(bulk()), "r"(bar)
          : "memory");
#pragma unroll 1
    for (uintptr_t p = b0; p < h; ++p) dst[p] = *reinterpret_cast<const unsigned char*>(p);
#pragma unroll 1
    for (uintptr_t p = e; p < b1; ++p) dst[p] = *reinterpret_cast<const unsigned char*>(p);
  }
};

// Where a staged span's first element lies in its stage buffer.
template <typename T>
__device__ __forceinline__ const T* staged(const unsigned char* buf, const T* src) {
  return reinterpret_cast<const T*>(buf + (reinterpret_cast<uintptr_t>(src) & 15));
}

template <typename TX>
__global__ void __launch_bounds__(THREADS, 1)  // the grid needs one CTA per SM, at most
fold_kernel(const TX* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ assign, const float* __restrict__ d1,
            const unsigned char* __restrict__ active, Shape s, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  // the tile's routing: its rows as (row | local id << 8, weight) sorted by
  // owner warp, in row order within an owner; w·d1 per row for the error;
  // per batch and owner the rows it owns and where they go; per owner its
  // first row and count
  __shared__ int2 sorted[TILE];
  __shared__ float prod[TILE];
  __shared__ unsigned rows_of[BATCHES][32];
  __shared__ int place[BATCHES][32];
  __shared__ int first[32], many[32];
  __shared__ __align__(8) unsigned long long full[MAX_STAGES];  // a barrier per stage
  const int d = s.d, D1 = d + 1;
  const int k0 = blockIdx.y * s.kt, kn = min(s.kt, s.K - k0);
  const int c0 = blockIdx.z * s.cw, c1 = min(D1, c0 + s.cw), cn = c1 - c0;
  const bool with_err = d1 != nullptr && blockIdx.y == 0 && blockIdx.z == 0;
  const bool act = with_err && active != nullptr;
  float* acc = reinterpret_cast<float*>(fold_smem);  // [kn][cn]
  unsigned char* ring = fold_smem + s.pbytes;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int o = t; o < kn * cn; o += THREADS) acc[o] = 0.f;
  const long long g = gridDim.x;
  const long long tb = s.tiles * blockIdx.x / g;
  const int nt = (int)(s.tiles * (blockIdx.x + 1) / g - tb);
  // the producer stages the CTA's tile i in stage `slot`: the ids, the
  // weights, x, and d1 and active for the error, completing on its barrier
  auto issue = [&](int i, int slot) {
    if (i >= nt) return;
    const long long r0 = (tb + i) * TILE, cnt = min((long long)TILE, s.n - r0);
    unsigned char* b = ring + (size_t)slot * s.sbytes;
    const unsigned bar = smem_addr(&full[slot]);
    const Span si(assign + r0, 4 * cnt), sw(w + r0, 4 * cnt);
    const Span sx(x + r0 * d, s.xstaged ? cnt * d * (long long)sizeof(TX) : 0);
    const Span se(d1 + r0, with_err ? 4 * cnt : 0), sa(active + r0, act ? cnt : 0);
    const unsigned tx = si.bulk() + sw.bulk() + sx.bulk() + se.bulk() + sa.bulk();
    // the stage was last read through generic loads, before the CTA barrier
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(tx)
                 : "memory");
    si.copy(b + s.io, bar);
    sw.copy(b + s.wo, bar);
    sx.copy(b, bar);
    se.copy(b + s.eo, bar);
    sa.copy(b + s.ao, bar);
  };
  if (t == PRODUCER) {
    for (int q = 0; q < s.stages; ++q) mbar_init(smem_addr(&full[q]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set up
  if (t == PRODUCER)
    for (int i = 0; i < s.stages - 1; ++i) issue(i, i);

  // one lane per column where x is staged and at most 32 columns are left
  const bool fast = s.xstaged && cn <= 32;
  const bool sum_col = lane < cn && c0 + lane < d;  // else the count column, or none
  float err = 0.f;                                  // the producer's running error
  int cur_l = -1;  // the cluster whose column sum `cur` holds, in the fast walk
  float cur = 0.f;
  unsigned parity = 0;  // of the current stage's barrier: flips each time the ring wraps
  for (int i = 0, slot = 0; i < nt; ++i) {
    mbar_wait(smem_addr(&full[slot]), parity);
    __syncthreads();  // tile i is staged; tile i − 1 is walked and its error added
    const unsigned char* b = ring + (size_t)slot * s.sbytes;
    const long long r0 = (tb + i) * TILE;
    const int cnt = (int)min((long long)TILE, s.n - r0);
    const float* ws = staged(b + s.wo, w + r0);
    // route: one warp per 32 rows finds each row's local id and owner warp
    // (id mod OWNERS), then the rows are placed in `sorted` by owner, in row
    // order within an owner, so a warp walks only its own rows
    if (warp < BATCHES) {
      const int rr = warp * 32 + lane;
      int mine = -1;
      float wr = 0.f, v = 0.f;
      if (rr < cnt) {
        wr = ws[rr];
        const int a = staged(b + s.io, assign + r0)[rr];
        if (wr != 0.f && a >= k0 && a < k0 + kn) mine = a - k0;
        if (with_err && wr != 0.f && (!act || staged(b + s.ao, active + r0)[rr] != 0))
          v = __fmul_rn(wr, staged(b + s.eo, d1 + r0)[rr]);
      }
      prod[rr] = v;
      const int own = mine < 0 ? OWNERS : mine % OWNERS;  // OWNERS: nobody
      rows_of[warp][lane] = 0u;
      __syncwarp();
      if (own < OWNERS) atomicOr(&rows_of[warp][own], 1u << lane);
      asm volatile("bar.sync 1, %0;\n" ::"r"(32 * BATCHES) : "memory");
      if (warp == 0) {
        // lane o: owner o's rows before each batch, and where they start
        int c[BATCHES], total = 0;
#pragma unroll
        for (int q = 0; q < BATCHES; ++q) {
          c[q] = lane < OWNERS ? __popc(rows_of[q][lane]) : 0;
          total += c[q];
        }
        int upto = total;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, upto, off);
          if (lane >= off) upto += u;
        }
        int p = upto - total;
        first[lane] = p;
        many[lane] = total;
#pragma unroll
        for (int q = 0; q < BATCHES; ++q) {
          place[q][lane] = p;
          p += c[q];
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(32 * BATCHES) : "memory");
      if (own < OWNERS) {
        const int rank = __popc(rows_of[warp][own] & ((1u << lane) - 1u));
        sorted[place[warp][own] + rank] = make_int2(rr | mine << 8, __float_as_int(wr));
      }
    }
    __syncthreads();  // the tile is routed
    if (warp == OWNERS) {
      if (t == PRODUCER) {
        issue(i + s.stages - 1, slot == 0 ? s.stages - 1 : slot - 1);  // tile i − 1's stage
        if (with_err) {
          // rows past n add +0, as the tile's other inactive rows do
#pragma unroll 8
          for (int rr = 0; rr < TILE; ++rr) err = __fadd_rn(err, prod[rr]);
        }
      }
    } else if (fast) {
      // the warp's rows in order, two at a time: a column's running sum
      // stays in a register while the rows hit the same cluster (every row
      // of a warp does at K <= 31), across tiles too; else both rows' sums
      // are loaded together, after the held one is handed back
      const TX* xl = staged(b, x + r0 * d) + c0 + lane;
      const int q0 = first[warp], q1 = q0 + many[warp];
      auto add = [&](float v, float wv, float xv) { return sum_col ? fmaf(wv, xv, v) : v + wv; };
      for (int q = q0; q < q1; q += 2) {
        const bool two = q + 1 < q1;
        const int2 ea = sorted[q], eb = two ? sorted[q + 1] : make_int2(ea.x, 0);
        const int la = ea.x >> 8, lb = eb.x >> 8;
        const float xa = sum_col ? to_f(xl[(ea.x & 255) * d]) : 0.f;
        const float xb = sum_col && two ? to_f(xl[(eb.x & 255) * d]) : 0.f;
        const float wa = __int_as_float(ea.y), wb = __int_as_float(eb.y);
        if (la == cur_l && lb == cur_l) {  // both rows in the held cluster
          cur = add(cur, wa, xa);
          if (two) cur = add(cur, wb, xb);
          continue;
        }
        // hand the held sum back, then load both rows' sums at once
        if (cur_l >= 0 && lane < cn) acc[cur_l * cn + lane] = cur;
        const float va = lane < cn ? acc[la * cn + lane] : 0.f;
        const float vb = lane < cn && lb != la ? acc[lb * cn + lane] : 0.f;
        const float sa = add(va, wa, xa);
        if (!two) {
          cur = sa;
          cur_l = la;
        } else if (lb == la) {
          cur = add(sa, wb, xb);
          cur_l = la;
        } else {
          if (lane < cn) acc[la * cn + lane] = sa;
          cur = add(vb, wb, xb);
          cur_l = lb;
        }
      }
    } else {
      const TX* xsh = staged(b, x + r0 * d);  // read only when x is staged
      const TX* xg = x + r0 * d;
      const int q0 = first[warp], q1 = q0 + many[warp];
      for (int q = q0; q < q1; ++q) {
        const int2 e = sorted[q];
        const int rr = e.x & 255;
        const float wv = __int_as_float(e.y);
        float* pa = acc + (e.x >> 8) * cn;
        const long long xo = (long long)rr * d;
        for (int j = c0 + lane; j < c1; j += 32) {
          if (j < d) {
            const float xv = s.xstaged ? to_f(xsh[xo + j]) : to_f(xg[xo + j]);
            pa[j - c0] = fmaf(wv, xv, pa[j - c0]);
          } else {
            pa[j - c0] = pa[j - c0] + wv;
          }
        }
      }
    }
    if (++slot == s.stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
  if (cur_l >= 0 && lane < cn) acc[cur_l * cn + lane] = cur;
  __syncthreads();
  float* out = part + (long long)blockIdx.x * s.stride;
  for (int o = t; o < kn * cn; o += THREADS) {
    const int kl = o / cn;
    out[(long long)(k0 + kl) * D1 + c0 + (o - kl * cn)] = acc[o];
  }
  if (with_err && t == PRODUCER) out[(long long)s.K * D1] = err;
}

constexpr int REDUCE_AHEAD = 16;  // partials loaded before their adds

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
  int b = 0;
  for (; b + REDUCE_AHEAD <= g; b += REDUCE_AHEAD) {
    float v[REDUCE_AHEAD];
#pragma unroll
    for (int u = 0; u < REDUCE_AHEAD; ++u) v[u] = part[(long long)(b + u) * stride + o];
#pragma unroll
    for (int u = 0; u < REDUCE_AHEAD; ++u) acc += v[u];
  }
  for (; b < g; ++b) acc += part[(long long)b * stride + o];
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
// (d1 ? 1 : 0)) floats. `p` is the fold's plan (FoldPlan; zeros: the
// kernel's own); `phases` says what runs: 1 the fold, 2 the reduction (to
// time each alone), 3 both. Returns a cudaError_t, cudaErrorInvalidValue
// for a plan that does not fit.
template <typename TX>
int fold_and_reduce(const TX* x, const float* w, const int* assign, const float* d1,
                    const unsigned char* active, long long n, int d, int K, float* sums,
                    float* counts, float* err, float* part, cudaStream_t st,
                    const FoldPlan& p = FoldPlan{0, 0, 0}, int phases = 3) {
  Shape s;
  int rc = fold_plan(n, d, K, (int)sizeof(TX), d1 != nullptr,
                     d1 != nullptr && active != nullptr, p, &s);
  if (rc != 0) return rc;
  const int g = row_ctas(n);
  if ((phases & 1) && g > 0) {
    rc = (int)cudaFuncSetAttribute(fold_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   s.smem);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)g, (unsigned)((K + s.kt - 1) / s.kt),
                    (unsigned)((d + 1 + s.cw - 1) / s.cw));
    fold_kernel<TX><<<grid, THREADS, s.smem, st>>>(x, w, assign, d1, active, s, part);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (phases & 2)
    reduce_partials<<<(unsigned)((s.stride + 255) / 256), 256, 0, st>>>(part, g, s.stride, K, d,
                                                                       sums, counts, err);
  return (int)cudaGetLastError();
}

}  // namespace fold
}  // namespace bwkm
