// W8A16 matmul for Hopper (sm_90a): int8-stored weights, bf16 activations,
// f32 accumulation, per-column dequantisation + bias + activation epilogue.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/matmul_int8/:
//   matmul_int8.py: matmul_w8a16 (body _kernel) -> matmul_w8a16_kernel
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
// Design.  One CTA of 4 warps owns a BM x BN tile of the output (BM in
// {16, 32, 64, 128}, BN in {32, 64, 128}, template parameters) and walks K
// in steps of bk (a multiple of 32 up to 128, a run-time argument).  A
// ring of stages in shared memory holds the x tile (bf16) and the int8 w
// tile, filled with 16-byte cp.async copies (rows along N for w) that run
// ahead of the arithmetic by STAGES - 1 steps, so several tiles of the
// weight stream are in flight per CTA.  Each step widens the int8 tile to
// bf16 (exactly, by an f32 magic-number trick on full-rate integer and
// float units) into a second shared buffer, transposed to [n][k] so that every
// mma.sync m16n8k16 B fragment is two 32-bit loads (rows padded by 16
// bytes so the fragment loads spread over the banks), then every warp
// runs its (BM / WM) x (BN / WN) sub-tile on mma.sync with f32
// accumulators in registers.  Decode's M <= 16 pads to one 16-row tile
// (zero-filled rows): the wasted tensor-core rows cost nothing while the
// weight read sets the pace.  The epilogue scales, adds the bias, applies
// act and stores bf16 pairs.  Ragged edges in M, N and K are zero-filled
// on load and masked on store, so no length has to divide by a tile;
// shapes whose rows are not 16-byte aligned (K % 8 or N % 16 != 0) take
// element-wise guarded loads into the same layout.  Measured on the card
// (PERF.md): at decode the time follows the number of K steps, not the
// bytes a step moves, so each CTA's narrow column strip (32-128 bytes a
// weight row) with its per-step barriers sets the pace, not the weight
// stream.  Not yet: split-K for the narrow-N decode shapes (N / BN CTAs
// only, each walking all of K), wgmma, TMA, fp8 (Queue 2b).
//
// Numerics: products exact, f32 sums in another order than the plain
// PyTorch version (kernels/matmul_int8/ref.py); expf/tanhf without fast
// math; __float2bfloat16_rn for the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
