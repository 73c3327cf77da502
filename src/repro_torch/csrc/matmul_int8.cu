// W8A16 matmul for Hopper (sm_90a): int8-stored weights, bf16 activations,
// f32 accumulation, per-column dequantisation + bias + activation epilogue.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/matmul_int8/:
//   matmul_int8.py: matmul_w8a16 (body _kernel) -> matmul_w8a16_kernel
//   (M > 16) and matmul_w8a16_decode_kernel + matmul_w8a16_reduce_kernel
//   (M <= 16)
//
// What it computes (as the TPU kernel does):
//   out = act(x @ (w_q * scale) + bias)      x (M, K) bf16, w_q (K, N) int8,
//   scale (N,) f32, bias (N,) f32 or none; every int8 code widened exactly
//   to bf16, exact products summed in f32; the scale, bias and act in f32
//   after the last K step; one rounding to bf16.  act: none, silu, gelu
//   (tanh form, jax.nn.gelu's default), relu.
//
// What bounds it on this card.  Decode (the LM's projections at M = B =
// 1..4, K x N up to 5120 x 13824): ~2 M operations per weight byte read
// once is far under the H100's ~295 a byte, so reading the int8 weight
// sets the pace (5120 x 13824: 70.8 MB, ~21 us at 3.35 TB/s).  Prefill
// (M = 2048): ~2 x 2048 operations a weight byte, over the line, so the
// bf16 tensor cores bound it (2048 x 5120 x 13824: 290 GFLOP, ~0.29 ms at
// 989 TFLOP/s).
//
// Decode (M <= 16): a split-K weight stream.  The tiled kernel below gave
// N / 32 CTAs, each walking all of K down a 32-byte column strip with two
// barriers a 4 KB step, and its time followed the number of K steps, not
// the bytes (PERF.md: wq 59.6 us against a 7.9 us bound).  The
// decode kernel instead:
//   * fills the card: a grid of ceil(N / 128) x S CTAs, CTA (n, s) owns
//     128 output columns and a contiguous, step-aligned range of the K
//     rows (split s of S; kernels/matmul_int8/matmul_int8.py::
//     decode_geometry picks the fewest S that give >= 2 CTAs an SM);
//   * reads wide rows: each step stages a 64-row x 128-byte box of the
//     weight (8 KB) and x's 64 columns with two TMA tensor-map loads
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint),
//     which also zero what lies past K, N or M;
//   * keeps the stream deep: a ring of 4 steps on mbarriers, 3 (24 KB) in
//     flight a CTA, 48-72 KB an SM at 2-3 CTAs an SM; one barrier a step;
//   * widens each code once, in registers: warp w takes rows 16w..16w+15
//     of a step, lane (g, t) loads 16 bytes (columns 16g..16g+15) of rows
//     2t, 2t+1, 2t+8, 2t+9 (TMA's 128-byte swizzle puts each quarter-warp
//     on 8 distinct bank groups) and widens byte pairs of rows (2t, 2t+1)
//     and (2t+8, 2t+9) with widen2: exactly the A fragment of mma.sync
//     m16n8k16 for out^T = w^T x^T, with A row g <-> column 16g + 2i and
//     row g + 8 <-> 16g + 2i + 1 of tile i (i = 0..7), and x (B, n8 = 8
//     rows of M) read as 32-bit pairs;
//   * hides launch gaps: both kernels are launched with programmatic
//     dependent launch (griddepcontrol): the reduction is scheduled once
//     every decode CTA holds its sums, the decode kernel once its
//     predecessor's CTAs are done, and each waits for its predecessor's
//     memory before touching its data.  (Scheduling the reduction at the
//     decode kernel's start hid no more time, and a profiler then counts
//     its wait as device time.)
//   Arithmetic: mma.sync rather than CUDA-core FMAs.  Widening a code
//   costs one byte_perm and one f32 subtract (plus half a byte_perm to
//   pack bf16 pairs for mma.sync).  FMAs then add M per weight byte, the
//   tensor cores one mma per 128 bytes (two for M > 8).  At the card's
//   ~25 GB/s a SM (~13 bytes a clock at 1.98 GHz) that is, in lane
//   operations a clock of the SM's 128: FMAs ~40 at M = 1, ~75 at M = 4,
//   ~230 at M = 16; mma.sync ~35 at any M.  Only mma.sync leaves headroom
//   at M = 16, and it costs no more at M = 1.  Transposing the product
//   puts M on the mma's n8 side, so M <= 8 pads to 8 columns, not 16 rows.
//   The sums: the 4 warps' partials meet in shared memory and are added in
//   warp order; with S = 1 the CTA applies scale, bias and act and rounds
//   once; otherwise it writes its f32 partial to a workspace (S, M, N) and
//   matmul_w8a16_reduce_kernel, launched next on the same stream, adds the
//   S partials in the order s = 0, 1, ..., S-1, applies scale, bias and
//   act and rounds once.  No atomics: repeated calls give the same bits.
//   The reduction moves 2 S M N 4 bytes beside the weight's K N (wq at
//   M = 4, S = 7: 1.1 MB beside 26.2 MB).
//   Measured (H100 80GB HBM3, 700 W; PERF.md section 6): at M = 4 one call
//   of a qwen2.5-14b projection takes 1.5-2.2x its weight-read bound on
//   the wide shapes, streaming at ~3.1 TB/s; about 9 us a call is fixed
//   (a one-step call takes 3.3 us, 4.4 us with the reduction; the rest is
//   the ring's fill and the tail), which holds wk / wv at ~6x their bound.
//   Tried and not kept, as no faster: 16-byte cp.async rows, one 128-byte
//   cp.async.bulk a row, deeper rings, 8 warps with 16 KB steps.
//
// Prefill (M > 16).  One CTA of 4 warps owns a BM x BN tile of the output
// (BM in {16, 32, 64, 128}, BN in {32, 64, 128}, template parameters) and
// walks K in steps of bk (a multiple of 32 up to 128, a run-time argument).
// A ring of stages in shared memory holds the x tile (bf16) and the int8 w
// tile, filled with 16-byte cp.async copies (rows along N for w) that run
// ahead of the arithmetic by STAGES - 1 steps, so several tiles of the
// weight stream are in flight per CTA.  Each step widens the int8 tile to
// bf16 (exactly, by an f32 magic-number trick on full-rate integer and
// float units) into a second shared buffer, transposed to [n][k] so that every
// mma.sync m16n8k16 B fragment is two 32-bit loads (rows padded by 16
// bytes so the fragment loads spread over the banks), then every warp
// runs its (BM / WM) x (BN / WN) sub-tile on mma.sync with f32
// accumulators in registers.  The epilogue scales, adds the bias, applies
// act and stores bf16 pairs.  Not yet: wgmma, TMA, fp8 (ROADMAP Queue 2).
//
// Both: ragged edges in M, N and K are zero-filled on load and masked on
// store, so no length has to divide by a tile; shapes whose rows are not
// 16-byte aligned (K % 8 or N % 16 != 0, or unaligned x / w) take
// element-wise guarded loads into the same layout.  Measured on the card:
// PERF.md section 6, row 6.
//
// Numerics: products exact, f32 sums in another order than the plain
// PyTorch version (kernels/matmul_int8/ref.py); expf/tanhf without fast
// math; __float2bfloat16_rn for the output.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;  // 4 warps per CTA
constexpr int kPadH = 8;       // bf16 pad per x / widened-w row (16 bytes)
constexpr int kPadB = 16;      // byte pad per int8 w row

enum Act { kNone = 0, kSilu = 1, kGelu = 2, kRelu = 3 };

struct Args {
  const __nv_bfloat16* x;  // (M, K) row-major
  const int8_t* w;         // (K, N) row-major
  const float* scale;      // (N,)
  const float* bias;       // (N,) or nullptr
  __nv_bfloat16* out;      // (M, N) row-major
  int M, N, K, bk, act, vec;
};

template <int BM>
struct Shape {
  static constexpr int WM = BM >= 32 ? 2 : 1;     // warps along M
  static constexpr int WN = 4 / WM;               // warps along N
  static constexpr int STAGES = BM == 16 ? 4 : 3; // decode keeps more weight in flight
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte e of each of two words of int8 codes (biased to unsigned by
// XOR 0x80) as a bf16 pair, exactly and without the quarter-rate
// conversion instructions: 0x4B0000uu is the f32 2^23 + u, so subtracting
// 2^23 + 128 leaves the code v = u - 128 exactly; |v| <= 128 has at most 8
// significant bits, so the f32's low 16 bits are zero and its high half is
// v's bf16.
__device__ __forceinline__ uint32_t widen2(uint32_t lo_u, uint32_t hi_u, int e) {
  const float magic = 8388736.f;  // 2^23 + 128
  const float lo = __uint_as_float(__byte_perm(lo_u, 0x4B000000u, 0x7650 + e)) - magic;
  const float hi = __uint_as_float(__byte_perm(hi_u, 0x4B000000u, 0x7650 + e)) - magic;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronously; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float epilogue(float v, int act) {
  switch (act) {
    case kSilu: return v / (1.f + expf(-v));
    case kGelu: return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case kRelu: return fmaxf(v, 0.f);
    default: return v;
  }
}

// Stage k-tile kt of x (BM x bk) and w (bk x BN) into shared memory.
template <int BM, int BN>
__device__ __forceinline__ void load_tile(const Args& a, __nv_bfloat16* xs, int8_t* ws, int m0,
                                          int n0, int kt) {
  const int tid = threadIdx.x, k0 = kt * a.bk;
  const int XP = a.bk + kPadH, WP = BN + kPadB;
  const int xc = a.bk / 8;  // 16-byte chunks per x row
  constexpr int wc = BN / 16;  // 16-byte chunks per w row
  if (a.vec) {  // K % 8 == 0, N % 16 == 0: a chunk is wholly inside or outside
    for (int i = tid; i < BM * xc; i += kThreads) {
      const int r = i / xc, c = (i % xc) * 8, gm = m0 + r, gk = k0 + c;
      const bool ok = gm < a.M && gk < a.K;
      cp_async16(xs + r * XP + c, ok ? a.x + (long long)gm * a.K + gk : a.x, ok ? 16 : 0);
    }
    for (int i = tid; i < a.bk * wc; i += kThreads) {
      const int r = i / wc, c = (i % wc) * 16, gk = k0 + r, gn = n0 + c;
      const bool ok = gk < a.K && gn < a.N;
      cp_async16(ws + r * WP + c, ok ? a.w + (long long)gk * a.N + gn : a.w, ok ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < BM * a.bk; i += kThreads) {
    const int r = i / a.bk, c = i % a.bk, gm = m0 + r, gk = k0 + c;
    xs[r * XP + c] = gm < a.M && gk < a.K ? a.x[(long long)gm * a.K + gk] : __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < a.bk * BN; i += kThreads) {
    const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
    ws[r * WP + c] = gk < a.K && gn < a.N ? a.w[(long long)gk * a.N + gn] : int8_t(0);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) matmul_w8a16_kernel(Args a) {
  using S = Shape<BM>;
  constexpr int TM = BM / S::WM, TN = BN / S::WN;  // one warp's sub-tile
  constexpr int MT = TM / 16, NT = TN / 8;         // its m16 and n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int XP = a.bk + kPadH, WP = BN + kPadB;
  __nv_bfloat16* xs0 = reinterpret_cast<__nv_bfloat16*>(smem);        // STAGES x BM x XP
  int8_t* ws0 = reinterpret_cast<int8_t*>(xs0 + S::STAGES * BM * XP);  // STAGES x bk x WP
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(ws0 + S::STAGES * a.bk * WP);  // BN x XP

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm0 = (warp / S::WN) * TM, wn0 = (warp % S::WN) * TN;
  const int nk = (a.K + a.bk - 1) / a.bk;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < nk) load_tile<BM, BN>(a, xs0 + s * BM * XP, ws0 + s * a.bk * WP, m0, n0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::STAGES - 2>();  // step kt has landed
    __syncthreads();                 // ... for every thread; step kt-1 fully consumed
    {
      const int nx = kt + S::STAGES - 1;  // refill the slot step kt-1 used
      if (nx < nk)
        load_tile<BM, BN>(a, xs0 + (nx % S::STAGES) * BM * XP, ws0 + (nx % S::STAGES) * a.bk * WP,
                          m0, n0, nx);
      cp_async_commit();
    }
    const int slot = kt % S::STAGES;
    const __nv_bfloat16* xs = xs0 + slot * BM * XP;
    const int8_t* ws = ws0 + slot * a.bk * WP;
    // widen: thread item (k pair kp, 16 columns) reads two 16-byte rows of
    // int8 and writes 16 bf16 pairs wb[n][2kp .. 2kp+1]
    const int kpairs = a.bk / 2;
    for (int i = tid; i < kpairs * (BN / 16); i += kThreads) {
      const int kp = i % kpairs, c = (i / kpairs) * 16;
      const uint4 r0 = *reinterpret_cast<const uint4*>(ws + (2 * kp) * WP + c);
      const uint4 r1 = *reinterpret_cast<const uint4*>(ws + (2 * kp + 1) * WP + c);
      const uint32_t w0[4] = {r0.x ^ 0x80808080u, r0.y ^ 0x80808080u, r0.z ^ 0x80808080u,
                              r0.w ^ 0x80808080u};
      const uint32_t w1[4] = {r1.x ^ 0x80808080u, r1.y ^ 0x80808080u, r1.z ^ 0x80808080u,
                              r1.w ^ 0x80808080u};
      uint32_t* dst = reinterpret_cast<uint32_t*>(wb) + kp;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[(c + e) * (XP / 2)] = widen2(w0[e / 4], w1[e / 4], e % 4);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < a.bk; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = xs + (wm0 + i * 16 + g) * XP + kk + 2 * t;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * XP);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * XP + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = wb + (wn0 + j * 8 + g) * XP + kk + 2 * t;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
#pragma unroll
        for (int i = 0; i < MT; ++i) mma16816(acc[i][j], af[i], bf);
      }
    }
  }

  // epilogue: scale, bias, act, bf16
  const bool pairs = (a.N % 2) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn0 + j * 8 + 2 * t;
    if (col >= a.N) continue;
    const bool two = col + 1 < a.N;
    const float s0 = a.scale[col], s1 = two ? a.scale[col + 1] : 0.f;
    const float b0 = a.bias ? a.bias[col] : 0.f;
    const float b1 = a.bias && two ? a.bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        if (row >= a.M) continue;
        float v0 = acc[i][j][2 * h] * s0, v1 = acc[i][j][2 * h + 1] * s1;
        if (a.bias) {
          v0 += b0;
          v1 += b1;
        }
        v0 = epilogue(v0, a.act);
        v1 = epilogue(v1, a.act);
        __nv_bfloat16* o = a.out + (long long)row * a.N + col;
        if (two && pairs) {
          *reinterpret_cast<uint32_t*>(o) = pack_f32(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (two) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using S = Shape<BM>;
  const size_t smem = size_t(S::STAGES) * (size_t(BM) * (a.bk + kPadH) * 2 +
                                           size_t(a.bk) * (BN + kPadB)) +
                      size_t(BN) * (a.bk + kPadH) * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_w8a16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  matmul_w8a16_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(const Args& a, int bn, cudaStream_t stream) {
  switch (bn) {
    case 32: return launch<BM, 32>(a, stream);
    case 64: return launch<BM, 64>(a, stream);
    default: return launch<BM, 128>(a, stream);
  }
}

// ---------------------------------------------------------------------------
// Decode (M <= 16): split-K weight stream (see the head note)
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;            // 4 warps
constexpr int kDecBN = 128;                 // output columns a CTA: 128 bytes of a weight row
constexpr int kDecKStep = 64;               // weight rows a step: 8 KB of int8 a CTA
constexpr int kDecStages = 4;               // ring depth: 3 steps (24 KB) in flight a CTA
constexpr int kDecRP = kDecBN + 4;          // f32 a row of the cross-warp sums

struct DecArgs {
  const __nv_bfloat16* x;  // (M, K) row-major
  const int8_t* w;         // (K, N) row-major
  const float* scale;      // (N,)
  const float* bias;       // (N,) or nullptr
  __nv_bfloat16* out;      // (M, N) row-major
  float* part;             // (S, M, N) f32 partial sums, or nullptr when S == 1
  int M, N, K, splits, act, vec;
};

// Staged layout, one ring slot: the weight block as 64 dense 128-byte rows
// and x as 8 MT dense 128-byte rows (64 bf16), the 16-byte chunks of each
// row permuted as TMA's 128-byte swizzle does (chunk c of row r at c ^ (r
// & 7)), so that each quarter-warp's fragment loads hit 8 distinct 16-byte
// bank groups.  Slots start on 1024-byte boundaries (the swizzle's period).
__device__ __forceinline__ int w_at(int r, int chunk) {
  return r * kDecBN + ((chunk ^ (r & 7)) << 4);
}
__device__ __forceinline__ int x_at(int m, int k) {
  return m * kDecKStep + ((((k >> 3) ^ (m & 7)) << 3) | (k & 7));
}

__host__ __device__ constexpr int dec_slot_bytes(int mt) {
  return kDecKStep * kDecBN + 8 * mt * kDecKStep * 2;
}

__host__ __device__ constexpr size_t dec_smem_bytes(int mt) {
  return size_t(kDecStages) * dec_slot_bytes(mt) + 1024;  // + alignment slack
}

// First K step of split s of S over nsteps steps (kernels/matmul_int8/
// matmul_int8.py::split_ranges): every split gets floor or ceil of
// nsteps / S steps, none is empty while S <= nsteps.
__device__ __forceinline__ int split_step(int s, int S, int nsteps) {
  return static_cast<int>(static_cast<long long>(s) * nsteps / S);
}

// Programmatic dependent launch (sm_90): wait for the grids this one
// depends on to complete (a no-op without one); let the next grid be
// scheduled now (it waits in turn).
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_arrive(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of bar with this parity to complete; traps (a launch
// error, not a hang) if it has not after ~2^30 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map (coordinates: inner, outer) -> shared memory
// by the TMA engine, counted on bar as transaction bytes.  Out-of-bounds
// elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Stage step k0.. of the CTA's column strip n0..: the 64 x 128 weight block
// and x's columns k0..k0+63 of its M rows.  Rows >= K, columns >= N and
// rows >= M are zero.
template <int MT>
__device__ __forceinline__ void dec_load(const DecArgs& a, const CUtensorMap* tw,
                                         const CUtensorMap* tx, int8_t* ws, __nv_bfloat16* xs,
                                         int n0, int k0, uint64_t* bar) {
  const int tid = threadIdx.x;
  if (a.vec) {
    if (tid == 0) {
      mbar_expect_arrive(bar, unsigned(dec_slot_bytes(MT)));
      tma_load_2d(ws, tw, n0, k0, bar);
      tma_load_2d(xs, tx, k0, 0, bar);
    }
    return;
  }
  // rows not 16-byte aligned: element-wise, into the same layout
  for (int i = tid; i < kDecKStep * kDecBN; i += kDecThreads) {
    const int r = i / kDecBN, c = i % kDecBN, gk = k0 + r, gn = n0 + c;
    ws[w_at(r, c >> 4) + (c & 15)] =
        gk < a.K && gn < a.N ? a.w[(long long)gk * a.N + gn] : int8_t(0);
  }
  for (int i = tid; i < 8 * MT * kDecKStep; i += kDecThreads) {
    const int r = i / kDecKStep, c = i % kDecKStep, gk = k0 + c;
    xs[x_at(r, c)] =
        r < a.M && gk < a.K ? a.x[(long long)r * a.K + gk] : __float2bfloat16_rn(0.f);
  }
}

// CTA (blockIdx.x, blockIdx.y) = (128-column strip, split).  MT n8 tiles of
// M (MT = 1 for M <= 8, 2 for M <= 16).  tw, tx: tensor maps of w (box 128
// x 64) and x (box 64 x 8 MT), used when a.vec.
template <int MT>
__global__ void __launch_bounds__(kDecThreads)
    matmul_w8a16_decode_kernel(DecArgs a, const __grid_constant__ CUtensorMap tw,
                               const __grid_constant__ CUtensorMap tx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[kDecStages];
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  constexpr int SLOT = dec_slot_bytes(MT);
  auto w_slot = [&](int p) { return reinterpret_cast<int8_t*>(ring + p * SLOT); };
  auto x_slot = [&](int p) {
    return reinterpret_cast<__nv_bfloat16*>(ring + p * SLOT + kDecKStep * kDecBN);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDecBN, s = blockIdx.y;
  const int nsteps = (a.K + kDecKStep - 1) / kDecKStep;
  const int st0 = split_step(s, a.splits, nsteps);
  const int nst = split_step(s + 1, a.splits, nsteps) - st0;

  float acc[8][MT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (a.vec && tid == 0) {
    for (int p = 0; p < kDecStages; ++p) mbar_init(&bar[p], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_dep_wait();  // x, and the buffers this call writes, are the previous grid's
#pragma unroll
  for (int p = 0; p < kDecStages - 1; ++p) {
    if (p < nst)
      dec_load<MT>(a, &tw, &tx, w_slot(p), x_slot(p), n0, (st0 + p) * kDecKStep, &bar[p]);
  }
  const int rb = warp * 16;  // this warp's 16 rows of a step
  for (int kt = 0; kt < nst; ++kt) {
    const int slot = kt % kDecStages;
    if (a.vec) mbar_wait(&bar[slot], unsigned(kt / kDecStages) & 1u);  // step kt has landed
    __syncthreads();  // ... for every thread; step kt-1 fully consumed
    {
      const int nx = kt + kDecStages - 1;  // refill the slot step kt-1 used
      if (nx < nst)
        dec_load<MT>(a, &tw, &tx, w_slot(nx % kDecStages), x_slot(nx % kDecStages), n0,
                     (st0 + nx) * kDecKStep, &bar[nx % kDecStages]);
    }
    const int8_t* ws = w_slot(slot);
    const __nv_bfloat16* xs = x_slot(slot);
    const uint4 q0 = *reinterpret_cast<const uint4*>(ws + w_at(rb + 2 * t, g));
    const uint4 q1 = *reinterpret_cast<const uint4*>(ws + w_at(rb + 2 * t + 1, g));
    const uint4 q2 = *reinterpret_cast<const uint4*>(ws + w_at(rb + 2 * t + 8, g));
    const uint4 q3 = *reinterpret_cast<const uint4*>(ws + w_at(rb + 2 * t + 9, g));
    const uint32_t r0[4] = {q0.x ^ 0x80808080u, q0.y ^ 0x80808080u, q0.z ^ 0x80808080u,
                            q0.w ^ 0x80808080u};
    const uint32_t r1[4] = {q1.x ^ 0x80808080u, q1.y ^ 0x80808080u, q1.z ^ 0x80808080u,
                            q1.w ^ 0x80808080u};
    const uint32_t r2[4] = {q2.x ^ 0x80808080u, q2.y ^ 0x80808080u, q2.z ^ 0x80808080u,
                            q2.w ^ 0x80808080u};
    const uint32_t r3[4] = {q3.x ^ 0x80808080u, q3.y ^ 0x80808080u, q3.z ^ 0x80808080u,
                            q3.w ^ 0x80808080u};
    uint32_t bf[MT][2];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int m = g + 8 * j;
      bf[j][0] = ld32(xs + x_at(m, rb + 2 * t));
      bf[j][1] = ld32(xs + x_at(m, rb + 2 * t + 8));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = i >> 1, e = (i & 1) * 2;  // columns 2i, 2i+1 of the lane's 16
      const uint32_t af[4] = {widen2(r0[q], r1[q], e), widen2(r0[q], r1[q], e + 1),
                              widen2(r2[q], r3[q], e), widen2(r2[q], r3[q], e + 1)};
#pragma unroll
      for (int j = 0; j < MT; ++j) mma16816(acc[i][j], af, bf[j]);
    }
  }

  // the 4 warps' partial sums meet in shared memory, added in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // 4 x 8MT x kDecRP
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = 16 * g + 2 * i;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      float* r = red + (warp * 8 * MT + 8 * j + 2 * t) * kDecRP + n;
      r[0] = acc[i][j][0];
      r[kDecRP] = acc[i][j][1];
      r[1] = acc[i][j][2];
      r[kDecRP + 1] = acc[i][j][3];
    }
  }
  __syncthreads();
  grid_dep_launch();  // the reduction may be scheduled now; it waits for this grid
  const int col = n0 + tid;
  if (col >= a.N) return;
  const float sc = a.scale[col], bi = a.bias ? a.bias[col] : 0.f;
  for (int m = 0; m < a.M; ++m) {
    float v = red[m * kDecRP + tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) v += red[(w * 8 * MT + m) * kDecRP + tid];
    if (a.splits == 1) {
      v *= sc;
      if (a.bias) v += bi;
      a.out[(long long)m * a.N + col] = __float2bfloat16_rn(epilogue(v, a.act));
    } else {
      a.part[((long long)s * a.M + m) * a.N + col] = v;
    }
  }
}

// out = act(sum_s part[s] * scale + bias), the splits added in order.
__global__ void matmul_w8a16_reduce_kernel(const float* part, const float* scale,
                                           const float* bias, __nv_bfloat16* out, int M, int N,
                                           int S, int act) {
  grid_dep_wait();  // the partials are the decode grid's
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long MN = (long long)M * N;
  if (idx >= MN) return;
  const int col = static_cast<int>(idx % N);
  float v = part[idx];
  for (int s = 1; s < S; ++s) v += part[s * MN + idx];
  v *= scale[col];
  if (bias) v += bias[col];
  out[idx] = __float2bfloat16_rn(epilogue(v, act));
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint so that
// the library links only against the CUDA runtime.
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                          uint32_t box_outer) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MT>
cudaError_t launch_decode(const DecArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dec_smem_bytes(MT);
  static_assert(smem >= size_t(4) * 8 * MT * kDecRP * 4 + 1024,
                "cross-warp sums must fit the ring");
  CUtensorMap tw, tx;
  memset(&tw, 0, sizeof(tw));
  memset(&tx, 0, sizeof(tx));
  cudaError_t e = cudaSuccess;
  if (a.vec) {
    e = tensor_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.N, a.K, a.N, kDecBN, kDecKStep);
    if (e != cudaSuccess) return e;
    e = tensor_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K, a.M, 2ull * a.K, kDecKStep,
                      8 * MT);
    if (e != cudaSuccess) return e;
  }
  static int attr_dev = -1;  // the device whose attribute is set
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (attr_dev != dev) {
    e = cudaFuncSetAttribute(matmul_w8a16_decode_kernel<MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    attr_dev = dev;
  }
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kDecBN - 1) / kDecBN, a.splits);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, matmul_w8a16_decode_kernel<MT>, a, tw, tx);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long mn = (long long)a.M * a.N;
  cfg.gridDim = dim3(static_cast<unsigned>((mn + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  cudaLaunchKernelEx(&cfg, matmul_w8a16_reduce_kernel, static_cast<const float*>(a.part),
                     a.scale, a.bias, a.out, a.M, a.N, a.splits, a.act);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes by
// repro_torch/kernels/matmul_int8/matmul_int8.py.  Returns a cudaError_t
// (0 on success), or -1 when the arguments are not ones the kernel takes
// (the Python wrapper checks them first).  x, w, out contiguous row-major;
// bias may be null.  bm in {16, 32, 64, 128}, bn in {32, 64, 128}, bk a
// multiple of 32 in [32, 128]; act 0 none, 1 silu, 2 gelu (tanh), 3 relu.
extern "C" int matmul_w8a16_forward(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int M, int N, int K, int bm,
                                    int bn, int bk, int act, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (bm != 16 && bm != 32 && bm != 64 && bm != 128) ||
      (bn != 32 && bn != 64 && bn != 128) || bk < 32 || bk > 128 || bk % 32 || act < 0 ||
      act > 3)
    return -1;
  const bool vec = K % 8 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(scale), static_cast<const float*>(bias),
               static_cast<__nv_bfloat16*>(out), M, N, K, bk, act, vec ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bm) {
    case 16: e = launch_bn<16>(a, bn, st); break;
    case 32: e = launch_bn<32>(a, bn, st); break;
    case 64: e = launch_bn<64>(a, bn, st); break;
    default: e = launch_bn<128>(a, bn, st); break;
  }
  return static_cast<int>(e);
}

// The decode kernel (M <= 16), same conventions.  splits in [1, ceil(K /
// 64)]; part points at splits x M x N f32 of scratch when splits > 1 (the
// wrapper allocates it), else may be null.  Launches
// matmul_w8a16_decode_kernel, then (splits > 1) matmul_w8a16_reduce_kernel
// on the same stream; returns the first launch error.
extern "C" int matmul_w8a16_decode(const void* x, const void* w, const void* scale,
                                   const void* bias, void* out, void* part, int M, int N, int K,
                                   int splits, int act, void* stream) {
  const int nsteps = K >= 1 ? (K + kDecKStep - 1) / kDecKStep : 0;
  if (M < 1 || M > 16 || N < 1 || K < 1 || splits < 1 || splits > nsteps || act < 0 ||
      act > 3 || (splits > 1 && part == nullptr))
    return -1;
  const bool vec = K % 8 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const DecArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                  static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), M, N, K, splits,
                  act, vec ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = M <= 8 ? launch_decode<1>(a, st) : launch_decode<2>(a, st);
  return static_cast<int>(e);
}
