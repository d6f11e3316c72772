// Shared device code of the distance kernels B1–B3 and B5: one persistent
// scan of the rows against a candidate set held in shared memory, feeding a
// per-row reducer, and the top-2 reducer of the assignment kernels.
//
// The scan (scan_rows), designed for the H100:
//
//   * Persistent CTAs of 128 threads: about as many as fit on the card at
//     once (occupancy × SMs), each walking row tiles with a grid stride, so
//     the set-up below is paid once per CTA, not once per row tile.
//   * The candidates stay resident in shared memory for the whole launch.
//     Each CTA loads them once (coalesced 16-byte loads when the [K, d]
//     array is aligned f32), transposes them to groups of four,
//     [K/4][1 + dxp][4] (the four norms, then feature j at 1 + j, features
//     zero-padded to dxp: 19 at d = 19), and computes ‖c‖² there once.
//     K = 2,001 at d = 19 takes 160 KB. Beyond the budget the candidates
//     are walked in resident chunks of kc, in increasing id, with the
//     reducers' state in registers across chunks (then each row tile
//     restages each chunk). Rows too wide for even four resident candidates
//     (d > 14,432) take the wide-row form below (wide_rows_kernel) instead.
//   * Given `cvalid` (B5), only the candidates whose entry is nonzero are
//     loaded: a stable in-CTA compaction, a prefix count in id order. The
//     invalid ones cost nothing.
//   * x tiles arrive asynchronously: a tile of `rows` rows is rows·d
//     contiguous elements, copied with 16-byte cp.async over the enclosing
//     16-byte-aligned span (so a view whose base is not aligned, such as
//     x[1:] at d = 19, works: the tile starts `xoff` bytes into the
//     buffer); the bytes before its first whole 16-byte chunk and after its
//     last are copied element by element, so nothing outside the tile is
//     read. Each thread moves its rows into registers, then the
//     next tile's copy is issued into the same buffer while this one
//     computes.
//   * Rows blocked in registers: each thread owns R rows (R = 4 from
//     131,072 rows on, 1 below so that a predict chunk or the partition's
//     representatives still spread over the card) with −2·x in registers.
//     Each warp-broadcast LDS.128 brings one feature of four centroids for
//     4·R FFMA. Up to d = 19 the feature count is a compile-time constant
//     (19, features past d zero), so a group of four centroids is one basic
//     block, unrolled by two.
//   * A cheaper epilogue: each accumulator starts at ‖c‖² and accumulates
//     −2·x·c, so the reducer compares p = ‖c‖² − 2·x·c. A row adds ‖x‖² and
//     clamps at 0 once, at the end: ‖x‖² is constant in a row, so the order
//     is that of the distances, and rounding moves by a few ulps of
//     ‖x‖² + ‖c‖² against the plain ‖x‖² − 2·x·c + ‖c‖².
//
// Why f32 stays on the CUDA cores: TF32 keeps about three digits, and
// ‖x‖² − 2·x·c + ‖c‖² cancels, so near-ties and small distances would be
// wrong; 3xTF32 costs three products per term at d = 19 padded to 24, and
// the top-2 epilogue stays on the CUDA cores anyway. bf16 inputs are
// converted to f32 when they are moved into registers or staged.
//
// The contract, whatever the layout: the reducer sees every candidate id
// in increasing order (B5's compacted candidates in increasing original
// id); rows past n are discarded. The top-2 rule: when p < d1 the id
// changes; d2 becomes min(d2, max(d1, p)) and d1 min(d1, p). Ties therefore
// go to the smallest id, and a duplicate centroid gives d2 == d1. d2 stays
// at BIG when K == 1; callers store it as +inf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>
#include <vector>

namespace bwkm {

constexpr int SCAN_THREADS = 128;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_SMEM = 232448 - 1024;    // dynamic shared bytes of a CTA, at most
constexpr int SCAN_XBUF_MAX = 131072 + 32;  // the largest staged x tile
constexpr long long SCAN_WIDE_N = 131072;   // rows from which a thread owns four rows
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Top2 {
  int a;
  float d1;
  float d2;

  __device__ static Top2 fresh() { return Top2{0, BIG, BIG}; }
  __device__ __forceinline__ void operator()(int k, float p) {
    a = p < d1 ? k : a;
    d2 = fminf(d2, fmaxf(d1, p));
    d1 = fminf(d1, p);
  }
};

// What one launch of the scan covers, fixed on the host by scan_shape.
struct ScanShape {
  long long n;      // rows
  long long tiles;  // row tiles of `rows` rows
  int d;            // features
  int K;            // candidate slots (valid or not)
  int rows;         // rows per tile: SCAN_THREADS · rows per thread
  int xbytes;       // shared bytes of the staged x tile; 0: x read from global memory
  int kc;           // candidates per resident chunk, a multiple of 4
};

// The wide-row form (wide_rows_kernel below): 128-row tiles, one row a
// thread, candidate features staged WIDE_FC at a time.
constexpr int WIDE_FC = 1024;
constexpr int WIDE_SMEM = 16 * WIDE_FC;  // dynamic shared bytes

inline ScanShape wide_rows_shape(long long n, int d, int K) {
  return ScanShape{n, (n + SCAN_THREADS - 1) / SCAN_THREADS, d, K, SCAN_THREADS, 0, 4};
}

// Features per register chunk, padded with zeros: 19 up to d = 19, one
// chunk; else 32, as many chunks as d needs.
inline int scan_dx(int d) { return d <= 19 ? 19 : 32; }

// Fills `s` and the dynamic shared bytes for n rows of d features of
// `xsize` bytes against K candidate slots, `r` rows a thread (0: four from
// SCAN_WIDE_N rows on at d <= 19, else one). False when K < 1, d < 1, or not
// even four candidates fit beside the x tile: past d = 14,432, where four
// candidates alone fill SCAN_SMEM (the launches then take the wide-row
// form, wide_rows_kernel).
inline bool scan_shape(long long n, int d, int K, int xsize, ScanShape* s, size_t* smem,
                       int r = 0) {
  const int dx = scan_dx(d);
  if (r == 0) r = (dx < 32 && n >= SCAN_WIDE_N) ? 4 : 1;
  s->n = n;
  s->d = d;
  s->K = K;
  s->rows = SCAN_THREADS * r;
  s->tiles = (n + s->rows - 1) / s->rows;
  const long long xb = ((long long)s->rows * d * xsize + 32 + 15) / 16 * 16;
  s->xbytes = xb <= SCAN_XBUF_MAX ? (int)xb : 0;
  const long long per = 4LL * ((d + dx - 1) / dx * dx + 1);  // bytes of one candidate
  const long long kc = std::min((SCAN_SMEM - s->xbytes) / per / 4 * 4, (K + 3LL) / 4 * 4);
  if (K < 1 || d < 1 || kc < 4) return false;
  s->kc = (int)kc;
  *smem = (size_t)s->xbytes + (size_t)(per * kc);
  return true;
}

// A scan's plan as the host passes it: rows a thread (1 or 4), candidates
// per resident chunk (a multiple of 4) and a cap on the persistent grid.
// 0 is the kernel's own choice for each: scan_shape's, and as many CTAs as
// are resident at once. None of them changes a bit of any output: each row
// sees every candidate in increasing id whatever the tile, the chunk or the
// CTA that walks it.
struct ScanPlan {
  int rpt;
  int kc;
  int ctas;
};

// Fills `s`, the dynamic shared bytes and `wide` (the wide-row form) for
// plan `p`, or returns cudaErrorInvalidValue for a plan that does not fit:
// an R with no instantiation, kc not a multiple of 4 in [4, K rounded up to
// 4], shared bytes past SCAN_SMEM, a negative knob. It never adjusts a
// plan.
inline int scan_plan(long long n, int d, int K, int xsize, const ScanPlan& p, ScanShape* s,
                     size_t* smem, bool* wide) {
  const int bad = (int)cudaErrorInvalidValue;
  if (K < 1 || d < 1 || n < 0 || p.rpt < 0 || p.kc < 0 || p.ctas < 0) return bad;
  *wide = !scan_shape(n, d, K, xsize, s, smem);
  if (*wide) {
    if ((p.rpt != 0 && p.rpt != 1) || (p.kc != 0 && p.kc != 4)) return bad;
    *s = wide_rows_shape(n, d, K);
    *smem = WIDE_SMEM;
    return (int)cudaSuccess;
  }
  const int dx = scan_dx(d);
  if (p.rpt != 0) {
    if (p.rpt != 1 && !(p.rpt == 4 && dx < 32)) return bad;
    if (!scan_shape(n, d, K, xsize, s, smem, p.rpt)) return bad;
  }
  if (p.kc != 0) {
    const long long per = 4LL * ((d + dx - 1) / dx * dx + 1);
    if (p.kc % 4 != 0 || p.kc < 4 || p.kc > (K + 3) / 4 * 4 ||
        s->xbytes + per * p.kc > SCAN_SMEM)
      return bad;
    s->kc = p.kc;
    *smem = (size_t)s->xbytes + (size_t)(per * p.kc);
  }
  return (int)cudaSuccess;
}

// CTAs of `fn` resident on the current device at once with `smem` dynamic
// shared bytes: the opt-in to SCAN_SMEM and the occupancy query are host
// calls, made once per (kernel, smem, device) and kept. Returns a
// cudaError_t.
inline int scan_ctas(const void* fn, size_t smem, long long* ctas) {
  struct Seen {
    const void* fn;
    size_t smem;
    int dev;
    long long ctas;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& e : seen) {
    if (e.fn == fn && e.smem == smem && e.dev == dev) {
      *ctas = e.ctas;
      return (int)cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, SCAN_THREADS, smem);
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  seen.push_back(Seen{fn, smem, dev, (long long)sms * per_sm});
  *ctas = seen.back().ctas;
  return (int)cudaSuccess;
}

// Launches `kernel` over min(tiles, the CTAs resident at once) CTAs, or
// min(tiles, cap) given a cap. Returns a cudaError_t.
template <typename... P, typename... A>
inline int launch_scan(void (*kernel)(P...), const ScanShape& s, size_t smem, int cap,
                       cudaStream_t stream, A... args) {
  if (s.tiles == 0) return (int)cudaSuccess;
  long long ctas = 0;
  const int rc = scan_ctas(reinterpret_cast<const void*>(kernel), smem, &ctas);
  if (rc != 0) return rc;
  if (cap > 0) ctas = cap;
  kernel<<<(unsigned)std::min(s.tiles, ctas), SCAN_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issues the copy of row tile `tile` into `xbuf` (every thread calls it)
// and returns the byte offset of the tile's first element there, its
// offset from 16-byte alignment. The 16-byte chunks inside the tile go by
// cp.async; the bytes before the first and after the last (a view whose
// base is not aligned, a tile that does not end on 16 bytes) are copied
// element by element by threads 0 and 1, so no byte outside the tile is
// read.
template <typename TX>
__device__ __forceinline__ int load_x_tile(const TX* x, const ScanShape& s, long long tile,
                                           unsigned char* xbuf) {
  const long long r0 = tile * s.rows, r1 = min(s.n, r0 + s.rows);
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(x + r0 * s.d);
  const uintptr_t b1 = reinterpret_cast<uintptr_t>(x + r1 * s.d);
  const uintptr_t a0 = b0 & ~uintptr_t(15);
  const uintptr_t up = (b0 + 15) & ~uintptr_t(15), down = b1 & ~uintptr_t(15);
  const uintptr_t h = up < b1 ? up : b1;        // the head ends here
  const uintptr_t e = down > h ? down : h;      // the tail starts here
  unsigned char* dst = xbuf + (h - a0);
  const int chunks = (int)((e - h) >> 4);
  for (int i = threadIdx.x; i < chunks; i += SCAN_THREADS)
    cp_async16(dst + 16 * i, reinterpret_cast<const void*>(h + 16 * (uintptr_t)i));
  if (threadIdx.x < 2) {
    const uintptr_t p0 = threadIdx.x == 0 ? b0 : e, p1 = threadIdx.x == 0 ? h : b1;
    for (uintptr_t q = p0; q < p1; q += sizeof(TX))
      *reinterpret_cast<TX*>(xbuf + (q - a0)) = *reinterpret_cast<const TX*>(q);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return (int)(b0 - a0);
}

// Stages the candidates of (compacted) positions [s0, s0 + kc) into cs,
// laid out [kc/4][1 + dxp][4], and returns how many are real. Without
// `cvalid` position k is candidate k; with it, the candidates whose entry is
// nonzero in increasing id, and *nvalid gets their number. Pads (features
// d..dxp-1, slots past the real ones) are 0 with norm +inf, so a pad slot
// never wins. Every thread calls it; it ends with __syncthreads.
template <typename TC>
__device__ int stage_candidates(const TC* __restrict__ c, const float* __restrict__ cvalid,
                                int K, int d, int dxp, int kc, int s0, float* cs, int* wsum,
                                int* nvalid) {
  const int t = threadIdx.x, gs = 4 * (1 + dxp);  // floats per group of four
  auto put = [&](int k, int j, float v) { cs[(k >> 2) * gs + 4 * (1 + j) + (k & 3)] = v; };
  int kn;
  if (cvalid == nullptr) {
    kn = min(kc, K - s0);
    const TC* src = c + (long long)s0 * d;
    const int total = kn * d;
    int e0 = 0;
    if constexpr (std::is_same<TC, float>::value) {
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        for (int i = t; i < total / 4; i += SCAN_THREADS) {
          const float4 v = s4[i];
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * i + u, k = e / d;
            put(k, e - k * d, vs[u]);
          }
        }
        e0 = total / 4 * 4;
      }
    }
    for (int e = e0 + t; e < total; e += SCAN_THREADS) {
      const int k = e / d;
      put(k, e - k * d, to_f(src[e]));
    }
  } else {
    // prefix count of the valid ids, THREADS ids at a time
    const int lane = t & 31, warp = t >> 5;
    int base = 0;
    for (int i0 = 0; i0 < K; i0 += SCAN_THREADS) {
      const int i = i0 + t;
      const bool v = i < K && cvalid[i] != 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, v);
      if (lane == 0) wsum[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int q = 0; q < SCAN_WARPS; ++q) {
        before += q < warp ? wsum[q] : 0;
        total += wsum[q];
      }
      const int pos = base + before + __popc(m & ((1u << lane) - 1u));
      if (v && pos >= s0 && pos < s0 + kc)
        for (int j = 0; j < d; ++j) put(pos - s0, j, to_f(c[(long long)i * d + j]));
      base += total;
      __syncthreads();  // wsum is rewritten next
    }
    *nvalid = base;
    kn = max(0, min(kc, base - s0));
  }
  for (int e = t; e < (kc >> 2) * gs; e += SCAN_THREADS) {
    const int g = e / gs, rem = e - g * gs, j = (rem >> 2) - 1;
    if (j >= d || (j >= 0 && 4 * g + (rem & 3) >= kn)) cs[e] = 0.f;
  }
  __syncthreads();
  for (int k = t; k < kc; k += SCAN_THREADS) {
    float* p = cs + (k >> 2) * gs + (k & 3);
    float nrm = 0.f;
    for (int j = 0; j < d; ++j) nrm = fmaf(p[4 * (1 + j)], p[4 * (1 + j)], nrm);
    p[0] = k < kn ? nrm : inf_f();
  }
  __syncthreads();
  return kn;
}

// Feeds each row's reducer (Op::Red) p = ‖c‖² − 2·x·c for every candidate,
// in increasing id, then calls op.finish with the reducers and the rows'
// ‖x‖². Op also says per row tile whether it needs the scan at all
// (op.any_active over the tile's rows [row0, row1), block-uniform). Every
// thread of the CTA calls this.
template <int DX, int R, typename TX, typename TC, typename Op>
__device__ __forceinline__ void scan_rows(const TX* __restrict__ x, const TC* __restrict__ c,
                                          const float* __restrict__ cvalid, const ScanShape& s,
                                          const Op& op) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  __shared__ int wsum[SCAN_WARPS];
  using Red = typename Op::Red;
  const int t = threadIdx.x, d = s.d;
  // DX < 32 takes d <= DX only, so its one feature chunk is known at compile
  // time and a centroid group's loads, FFMAs and compares are one basic block
  const int nfc = DX < 32 ? 1 : (d + DX - 1) / DX, dxp = nfc * DX, gs4 = 1 + dxp;
  const bool staged = s.xbytes > 0;
  unsigned char* xbuf = scan_smem;
  float* cs = reinterpret_cast<float*>(scan_smem + s.xbytes);
  const float4* cs4 = reinterpret_cast<const float4*>(cs);

  long long tile = blockIdx.x;  // < tiles: the grid is at most the tiles
  int xoff = staged ? load_x_tile(x, s, tile, xbuf) : 0;
  int nvalid = s.K;
  const int kn0 = stage_candidates(c, cvalid, s.K, d, dxp, s.kc, 0, cs, wsum, &nvalid);
  const bool resident = nvalid <= s.kc;

  for (; tile < s.tiles; tile += gridDim.x) {
    const long long row0 = tile * s.rows;
    if (staged) cp_async_wait_all();
    __syncthreads();
    const TX* xt = staged ? reinterpret_cast<const TX*>(xbuf + xoff) : x + row0 * d;
    const bool any = op.any_active(row0, min(s.n, row0 + s.rows));
    float xn[R], xr[R][DX];
    Red red[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int lr = t + r * SCAN_THREADS;
      const bool valid = row0 + lr < s.n;
      xn[r] = 0.f;
      red[r] = Red::fresh();
      if (nfc == 1) {
#pragma unroll
        for (int j = 0; j < DX; ++j) {
          const float v = (valid && j < d) ? to_f(xt[lr * d + j]) : 0.f;
          xn[r] = fmaf(v, v, xn[r]);
          xr[r][j] = -2.f * v;
        }
      } else {
        for (int j = 0; j < d; ++j) {
          const float v = valid ? to_f(xt[lr * d + j]) : 0.f;
          xn[r] = fmaf(v, v, xn[r]);
        }
      }
    }
    if (staged && nfc == 1) {
      __syncthreads();  // every row is in registers: the buffer takes the next tile
      if (tile + gridDim.x < s.tiles) xoff = load_x_tile(x, s, tile + gridDim.x, xbuf);
    }
    if (any) {
      for (int s0 = 0; s0 < nvalid; s0 += s.kc) {
        int kn = kn0;
        if (!resident) {
          __syncthreads();  // the previous chunk is consumed
          kn = stage_candidates(c, cvalid, s.K, d, dxp, s.kc, s0, cs, wsum, &nvalid);
        }
        const int groups = (kn + 3) >> 2;
#pragma unroll 2
        for (int g = 0; g < groups; ++g) {
          const float4* cg = cs4 + g * gs4;
          const float4 nv = cg[0];
          float acc[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][0] = nv.x;
            acc[r][1] = nv.y;
            acc[r][2] = nv.z;
            acc[r][3] = nv.w;
          }
          for (int f = 0; f < nfc; ++f) {
            if (nfc > 1) {
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const int lr = t + r * SCAN_THREADS;
                const bool valid = row0 + lr < s.n;
#pragma unroll
                for (int j = 0; j < DX; ++j) {
                  const int jj = f * DX + j;
                  xr[r][j] = (valid && jj < d) ? -2.f * to_f(xt[lr * d + jj]) : 0.f;
                }
              }
            }
            const float4* cf = cg + 1 + f * DX;
#pragma unroll
            for (int j = 0; j < DX; ++j) {
              const float4 cv = cf[j];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                acc[r][0] = fmaf(xr[r][j], cv.x, acc[r][0]);
                acc[r][1] = fmaf(xr[r][j], cv.y, acc[r][1]);
                acc[r][2] = fmaf(xr[r][j], cv.z, acc[r][2]);
                acc[r][3] = fmaf(xr[r][j], cv.w, acc[r][3]);
              }
            }
          }
          const int k0 = s0 + 4 * g;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int r = 0; r < R; ++r) red[r](k0 + q, acc[r][q]);
          }
        }
      }
    }
    op.finish(tile, row0, s.n, red, xn, any);
    if (staged && nfc > 1) {
      __syncthreads();  // the tile is consumed
      if (tile + gridDim.x < s.tiles) xoff = load_x_tile(x, s, tile + gridDim.x, xbuf);
    }
  }
  if (staged) cp_async_wait_all();
}

// The wide-row form of the scan, for rows too wide for four candidates to
// stay resident (scan_shape false). One row a thread, 128-row tiles with a
// grid stride, x read from global memory (each thread walks its own row, so
// a row's 128-byte lines serve 32 features from L1). The candidates go by
// in groups of four, in increasing id; a group's features go by in chunks
// of WIDE_FC, staged [WIDE_FC][4] in shared memory, and each thread adds
// its row's four products −2·x·c and the four norms ‖c‖² in registers, one
// chunk's sum at a time (so rounding grows with the chunks, not with d).
// Then the reducer gets p = ‖c‖² − 2·x·c of the group's candidates in
// increasing id: given `cvalid` (B5), of its valid ones only, and a group
// with none is skipped. Every thread of the CTA runs it.
template <typename TX, typename TC, typename Op>
__global__ void __launch_bounds__(SCAN_THREADS)
wide_rows_kernel(const TX* __restrict__ x, const TC* __restrict__ c,
                 const float* __restrict__ cvalid, ScanShape s, Op op) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  using Red = typename Op::Red;
  float* cs = reinterpret_cast<float*>(scan_smem);  // [WIDE_FC][4]
  const float4* cs4 = reinterpret_cast<const float4*>(cs);
  const int t = threadIdx.x, d = s.d;
  for (long long tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    const long long row0 = tile * SCAN_THREADS, row = row0 + t;
    const bool valid = row < s.n;
    const TX* xr = x + (valid ? row : 0) * (long long)d;
    const bool any = op.any_active(row0, min(s.n, row0 + SCAN_THREADS));
    float xn[1] = {0.f};
    Red red[1] = {Red::fresh()};
    for (int f0 = 0; f0 < d; f0 += WIDE_FC) {
      const int fe = min(d, f0 + WIDE_FC);
      float sq = 0.f;
      for (int j = f0; j < fe; ++j) {
        const float v = valid ? to_f(xr[j]) : 0.f;
        sq = fmaf(v, v, sq);
      }
      xn[0] += sq;
    }
    for (int k0 = 0; any && k0 < s.K; k0 += 4) {
      bool use[4], some = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        use[q] = k0 + q < s.K && (cvalid == nullptr || cvalid[k0 + q] != 0.f);
        some |= use[q];
      }
      if (!some) continue;  // the same for every thread
      float dot[4] = {0.f, 0.f, 0.f, 0.f}, nrm[4] = {0.f, 0.f, 0.f, 0.f};
      for (int f0 = 0; f0 < d; f0 += WIDE_FC) {
        const int fn = min(WIDE_FC, d - f0);
        __syncthreads();  // the previous chunk is consumed
        for (int e = t; e < 4 * WIDE_FC; e += SCAN_THREADS) {
          const int q = e / WIDE_FC, j = e - q * WIDE_FC;
          cs[4 * j + q] =
              (j < fn && k0 + q < s.K) ? to_f(c[(long long)(k0 + q) * d + f0 + j]) : 0.f;
        }
        __syncthreads();
        float pd[4] = {0.f, 0.f, 0.f, 0.f}, pn[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < fn; ++j) {
          const float4 cv = cs4[j];
          const float xv = valid ? -2.f * to_f(xr[f0 + j]) : 0.f;
          pd[0] = fmaf(xv, cv.x, pd[0]);
          pd[1] = fmaf(xv, cv.y, pd[1]);
          pd[2] = fmaf(xv, cv.z, pd[2]);
          pd[3] = fmaf(xv, cv.w, pd[3]);
          pn[0] = fmaf(cv.x, cv.x, pn[0]);
          pn[1] = fmaf(cv.y, cv.y, pn[1]);
          pn[2] = fmaf(cv.z, cv.z, pn[2]);
          pn[3] = fmaf(cv.w, cv.w, pn[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dot[q] += pd[q];
          nrm[q] += pn[q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (use[q]) red[0](k0 + q, nrm[q] + dot[q]);
    }
    op.finish(tile, row0, s.n, red, xn, any);
  }
}

// B1–B3's per-row output: the top-2 of every row, written as assign, d1,
// d2. Given `cached` and `active` (B3), a row tile whose rows are all
// inactive skips the scan (d1 = BIG, d2 = +inf there), and every inactive
// row keeps its cached id.
struct Assign {
  using Red = Top2;
  int* assign;
  float* d1;
  float* d2;
  const int* cached;
  const unsigned char* active;

  __device__ bool any_active(long long row0, long long row1) const {
    if (cached == nullptr) return true;
    int any = 0;
    for (long long row = row0 + threadIdx.x; row < row1; row += SCAN_THREADS)
      any |= active[row] != 0;
    return __syncthreads_or(any) != 0;
  }

  template <int R>
  __device__ void finish(long long, long long row0, long long n, const Top2 (&red)[R],
                         const float (&xn)[R], bool computed) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + threadIdx.x + r * SCAN_THREADS;
      if (row >= n) continue;
      const bool act = cached == nullptr || active[row] != 0;
      assign[row] = act ? red[r].a : cached[row];
      d1[row] = computed ? fmaxf(xn[r] + red[r].d1, 0.f) : BIG;
      d2[row] = (!computed || red[r].d2 >= BIG) ? inf_f() : fmaxf(xn[r] + red[r].d2, 0.f);
    }
  }
};

template <int DX, int R, typename TX, typename TC>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
top2_kernel(const TX* __restrict__ x, const TC* __restrict__ c, ScanShape s, Assign o) {
  scan_rows<DX, R>(x, c, static_cast<const float*>(nullptr), s, o);
}

// The top-2 scan of x [n, d] against c [K, d] into `o`, launched with plan
// `p`. Returns a cudaError_t.
template <typename TX, typename TC>
inline int launch_top2(const void* x, const void* c, long long n, int d, int K, Assign o,
                       cudaStream_t stream, const ScanPlan& p) {
  ScanShape s;
  size_t smem = 0;
  bool wide = false;
  const int rc = scan_plan(n, d, K, (int)sizeof(TX), p, &s, &smem, &wide);
  if (rc != 0) return rc;
  const TX* xt = static_cast<const TX*>(x);
  const TC* ct = static_cast<const TC*>(c);
  if (wide)
    return launch_scan(wide_rows_kernel<TX, TC, Assign>, s, WIDE_SMEM, p.ctas, stream, xt, ct,
                       static_cast<const float*>(nullptr), s, o);
  if (scan_dx(d) == 32)
    return launch_scan(top2_kernel<32, 1, TX, TC>, s, smem, p.ctas, stream, xt, ct, s, o);
  return s.rows == 4 * SCAN_THREADS
             ? launch_scan(top2_kernel<19, 4, TX, TC>, s, smem, p.ctas, stream, xt, ct, s, o)
             : launch_scan(top2_kernel<19, 1, TX, TC>, s, smem, p.ctas, stream, xt, ct, s, o);
}

}  // namespace bwkm
