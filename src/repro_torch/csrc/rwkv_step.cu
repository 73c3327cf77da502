// Fused RWKV6 serving step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv_step/rwkv_step.py:
//   rwkv6_step (body _kernel).
//
// What it computes, for each batch row b and wkv head h, over T tokens:
//   y_t = r_t . (S + (u * k_t) v_t^T)          (exclusive: y reads the old S)
//   S  <- diag(exp(w_t)) S + k_t v_t^T
// with r, k, v in bf16, the log-decay w and the bonus u in f32, the K x V
// state S in f32, y rounded to bf16.  Layouts as in the JAX package:
// r/k/w (T, B, H, K), v (T, B, H, V), u (H, K), state (B, H, K, V),
// y (T, B, H, V).
//
// What bounds it on this card: each step does ~6 f32 operations per state
// element on a state of 4 bytes an element read and written once, under one
// operation a byte, so device memory bounds it: ~1.05 MB at the decode shape
// of rwkv6-1.6b (T=1, B=1, H=32, K=V=64), ~0.3 us at 3.35 TB/s, and ~4.2 MB
// (~1.3 us) at B=4.  At those sizes one round trip to device memory, and
// not the bytes, sets a launch's time, so the design aims at one round trip
// over enough SMs with a short chain after it:
//   * column v of a head's state depends on column v alone (y_t[v] and
//     S[:, v]), so a CTA owns bh heads x a slab of bv columns of one batch
//     row: the grid is (H/bh * V/bv, B), and at B=1 the wrapper's default
//     slab (rwkv_step.py: geometry) puts about one CTA on each SM;
//   * a thread owns kRows rows x kCols columns of one head's state: it
//     moves them as 16-byte float4 loads and stores and keeps them in
//     registers for all T tokens.  The column groups of a slab are the
//     lowest bits of the thread index, so a warp reads and writes whole
//     runs of a state row (a plain copy of the state was slower with the
//     rows low); the K rows of a column are split over
//     K / kRows row groups above them, whose partial sums of y meet by warp
//     shuffles and, where they span warps, through shared memory (one
//     barrier a token, two buffers);
//   * every load of a step is issued before any is used: the state slab and
//     u once a call, r, k, w and v of token t, and, while token t computes,
//     token t+1's into a second set of registers.  The operands are
//     const __restrict__, so the compiler may batch them; exp(w) is taken
//     in registers and no barrier comes before the products;
//   * the state is read once and written once a call, so its loads and
//     stores carry the streaming (evict-first) cache hint, which made a
//     launch at B=4 faster; the last token's state goes out before
//     y's reduction, so its stores drain while the shuffles run; it goes to
//     a new tensor (the input state left as it was) or over the input state
//     itself (the engine's in-place update; s0 == sT).
// In-place calls rely on one invariant, so s0 and sT are not __restrict__:
// each thread loads all of its own state elements (into q, before token 0)
// before it stores any, and no thread loads or stores another thread's
// elements.  A card test holds the in-place call bit-equal to the
// out-of-place one at every head tile and column slab.
// A CTA works on hpc heads at a time (hpc | bh, hpc * its threads a head
// <= kMaxThreads); the plan's larger head tiles loop over them.
// Numerics: f32 sums, expf (no fast math: the decay spans
// exp(-e^3) .. exp(-e^-8)), y rounded with __float2bfloat16_rn.  A column's
// sum of y is its thread's kRows rows in order, then a butterfly over the
// row groups (xor 1, 2, 4, ...); both are fixed by K alone, so every bh and
// every bv gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per CTA at most (rwkv_step.py: MAX_THREADS)
constexpr int kRows = 4;          // state rows a thread owns (rwkv_step.py: ROWS)
constexpr int kCols = 4;          // state columns a thread owns, one float4 (rwkv_step.py: COLS)
constexpr int kMaxWarps = kMaxThreads / 32;

// One token's operands for a thread's rows and columns, as loaded: r, k and
// v as four bf16 each (8 bytes), w as four f32 (16 bytes).
struct Tok {
  uint2 r, k, v;
  float4 w;
};

__device__ __forceinline__ Tok load_tok(const __nv_bfloat16* __restrict__ r,
                                        const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v,
                                        const float* __restrict__ w, size_t rk, size_t vo) {
  Tok t;
  t.r = *reinterpret_cast<const uint2*>(r + rk);
  t.k = *reinterpret_cast<const uint2*>(k + rk);
  t.w = *reinterpret_cast<const float4*>(w + rk);
  t.v = *reinterpret_cast<const uint2*>(v + vo);
  return t;
}

__device__ __forceinline__ void unpack4(uint2 p, float* f) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.y));
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}

// The pairwise tree over n = 1, 2, 4 or 8 partial sums p[0], p[V], ...:
// the pairs the butterfly of the lanes would form, level by level.
template <int V>
__device__ __forceinline__ float tree(const float* p, int n) {
  if (n == 1) return p[0];
  if (n == 2) return p[0] + p[V];
  const float a = (p[0] + p[V]) + (p[2 * V] + p[3 * V]);
  if (n == 4) return a;
  return a + ((p[4 * V] + p[5 * V]) + (p[6 * V] + p[7 * V]));
}

template <int K, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rwkv6_step_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* s0,
                      float* sT, __nv_bfloat16* __restrict__ y, int T, int B,
                      int H, int bh, int lbv, int hpc) {
  constexpr int kLgGroups = K == 64 ? 4 : 2;  // log2 of the row groups of a column, K / kRows
  constexpr int kLgV = V == 64 ? 6 : 4;
  // partial sums of y from row groups in other warps: [token parity][head slot x warp][column]
  __shared__ float red[2][kMaxWarps][V];
  const int lg_ncg = lbv - 2;                      // log2 of the column groups, bv / kCols
  const int lg_in = min(kLgGroups, 5 - lg_ncg);    // row-group bits inside a warp
  const int lg_head = kLgGroups + lg_ncg;          // log2 of a head's threads
  const int tid = threadIdx.x;
  const int cg = tid & ((1 << lg_ncg) - 1);
  const int rg = (tid >> lg_ncg) & ((1 << kLgGroups) - 1);
  const int hs = tid >> lg_head;                   // head slot
  const int whi = rg >> lg_in;                     // the row groups' warp within the head
  const int nhi = 1 << (kLgGroups - lg_in);        // warps a head's row groups span
  const int lg_slabs = kLgV - lbv;
  const int h_begin = (blockIdx.x >> lg_slabs) * bh;
  const int b = blockIdx.y;
  const int row0 = rg * kRows;
  const int col = ((blockIdx.x & ((1 << lg_slabs) - 1)) << lbv) + cg * kCols;
  // the lanes of this warp that exist (a CTA may hold fewer than 32 threads)
  const int live = min(32, static_cast<int>(blockDim.x) - (tid & ~31));
  const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
  const size_t tok = size_t(B) * H;  // (b, h) rows between tokens
  int step = 0;                      // tokens done over the head loop: red's parity

  for (int h = h_begin + hs; h < h_begin + bh; h += hpc) {
    const size_t sbase = ((size_t(b) * H + h) * K + row0) * V + col;
    size_t row = size_t(b) * H + h;  // (t, b, h) at t = 0
    // every load of the first token at once: the state slab, u, r, k, w, v
    float4 q[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      q[i] = __ldcs(reinterpret_cast<const float4*>(s0 + sbase + i * V));
    const float4 u4 = *reinterpret_cast<const float4*>(u + size_t(h) * K + row0);
    Tok cur = load_tok(r, k, v, w, row * K + row0, row * V + col);
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i][0] = q[i].x;
      s[i][1] = q[i].y;
      s[i][2] = q[i].z;
      s[i][3] = q[i].w;
    }
    for (int t = 0;; ++t, row += tok) {
      const bool last = t + 1 == T;
      Tok nxt = cur;
      if (!last) nxt = load_tok(r, k, v, w, (row + tok) * K + row0, (row + tok) * V + col);
      float rr[kRows], kk[kRows], vv[kCols];
      unpack4(cur.r, rr);
      unpack4(cur.k, kk);
      unpack4(cur.v, vv);
      const float uu[kRows] = {u4.x, u4.y, u4.z, u4.w};
      const float ew[kRows] = {expf(cur.w.x), expf(cur.w.y), expf(cur.w.z), expf(cur.w.w)};
      float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float kv = kk[i] * vv[c];
          acc[c] += rr[i] * (s[i][c] + uu[i] * kv);  // reads the old state
          s[i][c] = ew[i] * s[i][c] + kv;
        }
      }
      if (last) {  // the state's stores drain while y is reduced
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          __stcs(reinterpret_cast<float4*>(sT + sbase + i * V),
                 make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
      }
      // the butterfly over the row groups: xor 1, 2, ... of rg, in lanes
      // (xor ncg, 2 ncg, ...) while they lie in one warp, then through
      // shared memory in the same pairs
#pragma unroll
      for (int j = 0; j < kLgGroups; ++j) {
        if (j < lg_in) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[c] += __shfl_xor_sync(mask, acc[c], 1 << (lg_ncg + j));
        }
      }
      if (nhi > 1) {
        float* part = red[step & 1][hs * nhi];
        if ((rg & ((1 << lg_in) - 1)) == 0) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) part[whi * V + cg * kCols + c] = acc[c];
        }
        __syncthreads();  // one a token: the two parities keep writes off unread sums
        if (rg == 0) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] = tree<V>(part + cg * kCols + c, nhi);
        }
      }
      if (rg == 0) {
        __nv_bfloat162 lo, hi;
        lo.x = __float2bfloat16_rn(acc[0]);
        lo.y = __float2bfloat16_rn(acc[1]);
        hi.x = __float2bfloat16_rn(acc[2]);
        hi.y = __float2bfloat16_rn(acc[3]);
        uint2 out;
        out.x = *reinterpret_cast<const uint32_t*>(&lo);
        out.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(y + row * V + col) = out;
      }
      ++step;
      if (last) break;
      cur = nxt;
    }
  }
}

template <int K, int V>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* sT, void* y, int T, int B, int H, int bh, int bv,
                   int hpc, cudaStream_t stream) {
  int lbv = 2;
  while ((1 << lbv) < bv) ++lbv;
  const dim3 grid((H / bh) * (V / bv), B), block((K / kRows) * (bv / kCols) * hpc);
  rwkv6_step_kernel<K, V><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0), static_cast<float*>(sT),
      static_cast<__nv_bfloat16*>(y), T, B, H, bh, lbv, hpc);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_v(const void* r, const void* k, const void* v, const void* w, const void* u,
                     const void* s0, void* sT, void* y, int T, int B, int H, int V, int bh,
                     int bv, int hpc, cudaStream_t stream) {
  return V == 16 ? launch<K, 16>(r, k, v, w, u, s0, sT, y, T, B, H, bh, bv, hpc, stream)
                 : launch<K, 64>(r, k, v, w, u, s0, sT, y, T, B, H, bh, bv, hpc, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes by repro_torch/kernels/rwkv_step/rwkv_step.py.
// Returns a cudaError_t (0 on success); -1 when the arguments are not ones
// the kernel takes (the Python wrapper checks them first).  Every pointer is
// 16-byte aligned (the wrapper copies an operand that is not).
extern "C" int rwkv6_step_forward(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* s0, void* sT, void* y, int T,
                                  int B, int H, int K, int V, int bh, int bv, int hpc,
                                  void* stream) {
  if ((K != 16 && K != 64) || (V != 16 && V != 64) || T < 1 || B < 1 || H < 1 || bh < 1 ||
      H % bh || bv < kCols || (bv & (bv - 1)) || V % bv || hpc < 1 || bh % hpc ||
      (K / kRows) * (bv / kCols) * hpc > kMaxThreads)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      K == 16 ? launch_v<16>(r, k, v, w, u, s0, sT, y, T, B, H, V, bh, bv, hpc, s)
              : launch_v<64>(r, k, v, w, u, s0, sT, y, T, B, H, V, bh, bv, hpc, s);
  return static_cast<int>(e);
}
