// W8A16 matmul for Hopper (sm_90a): int8-stored weights, bf16 activations,
// f32 accumulation, per-column dequantisation + bias + activation epilogue.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/matmul_int8/:
//   matmul_int8.py: matmul_w8a16 (body _kernel) -> matmul_w8a16_prefill_kernel
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
// Decode (M <= 16): a split-K weight stream.  A tiled mma.sync kernel gave
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
// Prefill (M > 16): wgmma with the weight as A, widened into registers.
// What bounds it: ~2 M operations a weight byte (4,096 at M = 2048), far
// over the card's ~295, so the bf16 tensor cores (the codes are widened
// to bf16) at 989 TFLOP/s, which only wgmma reaches.  Beside them, each
// SM's shared memory (128 bytes a clock): every operand byte a wgmma reads
// from it, and every byte staged or restaged there, competes for it.  The
// kernel (matmul_w8a16_prefill_kernel<BM>) computes out^T = w^T x^T:
//   * tiles: a CTA owns BM (64, 128 or 256) token rows x 128 output
//     columns and walks K in steps of 64; the grid runs M fastest, so a
//     wave's CTAs share weight tiles in L2;
//   * operands: A = the weight, 64 output columns x 16 k a wgmma, in
//     registers; B = x, BM tokens x 16 k, K-major with the 128-byte
//     swizzle, read from shared memory (the plain K-major descriptor, an
//     8-row group 1024 bytes, a k16 slice 32 bytes along) by wgmma
//     m64nBMk16; f32 accumulators in registers (BM / 2 a thread);
//   * warp roles: a loader warp (its lane 0) keeps a 5-stage mbarrier ring
//     of TMA boxes full: x (64 k x BM rows) and the int8 weight (64 rows x
//     128 bytes); two math warpgroups own 64 output columns each;
//   * widening once per code, in the math warps' registers: a warp's A
//     rows stand for 16 adjacent output columns, permuted so that a lane's
//     two rows are adjacent bytes of a weight row; ldmatrix.trans (the
//     int8 tile read as 8 x 8 matrices of byte pairs) hands each lane its
//     rows (k, k + 1) of those two columns as one word, and the f32
//     magic-number identity (widen2) turns byte pairs into the bf16 pairs
//     of wgmma's A fragment.  Nothing widened goes back to shared memory;
//   * one wgmma group a k16 slice, four in flight: slice q of a step is
//     widened as soon as wait_group 3 shows slice q of the step before done
//     with its registers, then issued, so the widening runs under the
//     tensor cores; a stage is freed once its last slice is done;
//   * epilogue: scale, bias, act and one rounding per element in f32; a
//     thread's two columns are one bf16 pair, staged through the idle ring
//     and stored as 16-byte row pieces.
//   Every tile sums an output's products in the same order (k16 slices in
//   order, K steps in order, no split-K, no atomics), so repeated calls and
//   every BM give the same bits.
//   Measured (H100 80GB HBM3, 700 W; PERF.md section 6): one call at
//   2048 x 5120 x 13824 takes 542 us, 1.85x its 293 us bound and 1.44x
//   cuBLAS's bf16 product; a 4 x 512 prefill layer's seven calls 2.27 ms
//   against a 1.14 ms bound; the int8 model's 4 x 512 prefill 1.31x the
//   bf16 model's.
//   Tried and not kept (the same card): the mma.sync tile (4 warps,
//   cp.async rows, the int8 tile widened into a padded [n][k] bf16 tile
//   between two barriers a step), 1,820 us at 2048 x 5120 x 13824; x as A
//   and the weight widened by a producer warpgroup into a swizzled bf16
//   [n][k] tile as wgmma's shared-memory B, slower however the widening was
//   spread (3 or 4 warps, 2 or 3 B slots, 128 x 256 or 256 x 128 tiles):
//   restaging the weight in bf16 adds 48 KB of shared-memory traffic a
//   step to wgmma's operand reads, and a widening loop of loads and stores
//   alone kept an idle SM's shared memory busy most of a step; 16-bit
//   fragment loads in place of ldmatrix; a step's fragments loaded ahead
//   in one go; rings of 3 to 8 stages.  None was faster.
//
// Both: ragged edges in M, N and K are zero-filled on load and masked on
// store, so no length has to divide by a tile; shapes whose rows are not
// 16-byte aligned (K % 8 or N % 16 != 0, or unaligned x / w) take
// element-wise guarded loads into the same layout (at prefill by the
// loader warp).  Measured on the card: PERF.md
// section 6, row 6.
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

#include "hopper.cuh"

namespace {

enum Act { kNone = 0, kSilu = 1, kGelu = 2, kRelu = 3 };

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ float epilogue(float v, int act) {
  switch (act) {
    case kSilu: return v / (1.f + expf(-v));
    case kGelu: return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case kRelu: return fmaxf(v, 0.f);
    default: return v;
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

// Staged layout, one ring slot: the weight block and x as 128-byte rows
// in TMA's 128-byte swizzle (w_at, x_at: hopper.cuh).
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

// ---------------------------------------------------------------------------
// Prefill (M > 16): wgmma with the widened weight as A in registers and x
// as B from TMA-staged shared memory (head note)
// ---------------------------------------------------------------------------

constexpr int kPreBK = 64;      // K a step: one 128-byte swizzle row of bf16
constexpr int kPreBN = 128;     // output columns a CTA: one 128-byte box of w
constexpr int kPreStages = 5;   // ring of (x, int8 w) steps
constexpr int kPreMath = 2;     // math warpgroups, 64 output columns each
constexpr int kPreThreads = 128 * kPreMath + 32;  // + one loader warp
constexpr int kBox = kPreBK * kPreBN;              // int8 w of one step: 8 KB
static_assert(kPreBK == 64 && kPreBN == 128 && kDecKStep == 64 && kDecBN == 128,
              "x_at / w_at (hopper.cuh) lay out 64 x 128 steps");

struct PreArgs {
  const __nv_bfloat16* x;  // (M, K) row-major
  const int8_t* w;         // (K, N) row-major
  const float* scale;      // (N,)
  const float* bias;       // (N,) or nullptr
  __nv_bfloat16* out;      // (M, N) row-major
  int M, N, K, act;
  int vec;      // x and w rows 16-byte aligned: TMA loads, else element-wise
  int vec_out;  // out rows 16-byte aligned: 16-byte stores, else element-wise
};

// One CTA at BM token rows (kernels/matmul_int8/matmul_int8.py::
// smem_bytes): kPreStages x (x: BM rows x 128 bytes, int8 w: 64 rows x
// 128 bytes), each on a 1024-byte boundary (the swizzle's period), plus
// 1 KB to align the base.  At BM = 256: 5 x 40 KB + 1 KB = 205,824 bytes.
template <int BM>
struct Pre {
  static constexpr int kX = BM * kPreBK * 2;
  static constexpr int kStage = kX + kBox;
  static constexpr int kPitch = kPreBN * 2 + 16;  // staged output row: banks spread
  static constexpr size_t kSmem = size_t(kPreStages) * kStage + 1024;
  static_assert(size_t(BM) * kPitch <= size_t(kPreStages) * kStage,
                "the staged output tile must fit the ring");
};

// Stage step kt of x (BM rows) and w (64 rows x 128 columns) into ring
// stage kt % kPreStages once it is free: TMA boxes counted on full (lane
// 0), or element-wise into the TMA's layouts when rows are not 16-byte
// aligned (the whole warp).
template <int BM>
__device__ __forceinline__ void pre_load(const PreArgs& a, const CUtensorMap* tx,
                                         const CUtensorMap* tw, unsigned char* ring,
                                         uint64_t* full, uint64_t* empty, int kt, int m0, int n0,
                                         int lane) {
  using P = Pre<BM>;
  const int s = kt % kPreStages, k0 = kt * kPreBK;
  unsigned char* xs = ring + s * P::kStage;
  unsigned char* ws = xs + P::kX;
  if (a.vec) {
    if (lane == 0) {
      mbar_wait(&empty[s], ((kt / kPreStages) & 1) ^ 1);
      mbar_expect_arrive(&full[s], unsigned(P::kStage));
      tma_load_2d(xs, tx, k0, m0, &full[s]);
      tma_load_2d(ws, tw, n0, k0, &full[s]);
    }
    return;
  }
  mbar_wait(&empty[s], ((kt / kPreStages) & 1) ^ 1);
  __nv_bfloat16* xe = reinterpret_cast<__nv_bfloat16*>(xs);
  for (int i = lane; i < BM * kPreBK; i += 32) {
    const int r = i / kPreBK, c = i % kPreBK, gm = m0 + r, gk = k0 + c;
    xe[x_at(r, c)] =
        gm < a.M && gk < a.K ? a.x[(long long)gm * a.K + gk] : __float2bfloat16_rn(0.f);
  }
  for (int i = lane; i < kBox; i += 32) {
    const int r = i / kPreBN, c = i % kPreBN, gk = k0 + r, gn = n0 + c;
    ws[w_at(r, c >> 4) + (c & 15)] = gk < a.K && gn < a.N ? a.w[(long long)gk * a.N + gn] : 0;
  }
  fence_proxy_async();  // x is read by wgmma
  __syncwarp();
  if (lane == 0) mbar_arrive(&full[s]);
}

// widen_slice (hopper.cuh): the A fragments of a k16 slice, widened from
// the int8 stage with ldmatrix.trans and the widen identity.

// CTA (blockIdx.x, blockIdx.y) = (BM-row tile of M, 128-column tile of N),
// M fastest, so the CTAs of a wave share weight tiles in L2.  tx, tw:
// tensor maps of x (box 64 x BM) and w (box 128 x 64), used when a.vec.
template <int BM>
__global__ void __launch_bounds__(kPreThreads, 1)
    matmul_w8a16_prefill_kernel(PreArgs a, const __grid_constant__ CUtensorMap tx,
                                const __grid_constant__ CUtensorMap tw) {
  using P = Pre<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kPreStages], empty[kPreStages];
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kPreBN;
  const int nk = (a.K + kPreBK - 1) / kPreBK;
  if (tid == 0) {
    for (int s = 0; s < kPreStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kPreMath);  // lane 0 of each math warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kPreMath) {  // ---- the loader warp: the ring ------------
    if (a.vec && lane != 0) return;
    for (int kt = 0; kt < nk; ++kt)
      pre_load<BM>(a, &tx, &tw, ring, full, empty, kt, m0, n0, lane);
    return;
  }

  // ---- math warpgroup mg: output columns 64 mg .. 64 mg + 63 of the tile --
  // One wgmma group a k16 slice, four in flight: slice q of step kt is
  // widened into A[q] as soon as slice q of step kt - 1 is done with it
  // (wait_group 3), then issued, so widening runs under the tensor cores.
  // Step kt - 1's stage is freed once its last slice is done.
  const int mg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int chunk = 4 * mg + wl, g2 = 2 * g;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t A[kPreBK / 16][4];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kPreStages;
    unsigned char* xs = ring + s * P::kStage;
    const uint64_t db = sw128_desc(xs);
    mbar_wait(&full[s], (kt / kPreStages) & 1);
#pragma unroll
    for (int q = 0; q < kPreBK / 16; ++q) {
      if (kt > 0) {
        wgmma_wait<kPreBK / 16 - 1>();  // slice q of step kt - 1 is done
        fence_regs(A);
      }
      if (q == kPreBK / 16 - 1 && kt > 0 && lane == 0)
        mbar_arrive(&empty[(kt - 1) % kPreStages]);
      widen_slice(xs + P::kX, q, chunk, lane, A[q]);
      fence_regs(acc);
      fence_regs(A);
      wgmma_fence();
      wgmma_rs<BM>(acc, A[q], db + 2 * q);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: scale, bias, act, one rounding; the bf16 tile is staged in
  // the ring (both math warpgroups are past their last wgmma first), then
  // stored as 16-byte row pieces.  This thread holds output columns c, c + 1
  // (one bf16 pair) of tokens 8 j + 2 t + {0, 1}.
  named_sync(1, 128 * kPreMath);
  unsigned char* os = ring;
  const int cl = 64 * mg + 16 * wl + g2, col = n0 + cl;
  const float s0 = col < a.N ? a.scale[col] : 0.f;
  const float s1 = col + 1 < a.N ? a.scale[col + 1] : 0.f;
  const float b0 = a.bias && col < a.N ? a.bias[col] : 0.f;
  const float b1 = a.bias && col + 1 < a.N ? a.bias[col + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v0 = acc[4 * j + c] * s0, v1 = acc[4 * j + 2 + c] * s1;
      if (a.bias) {
        v0 += b0;
        v1 += b1;
      }
      *reinterpret_cast<uint32_t*>(os + (8 * j + 2 * t + c) * P::kPitch + cl * 2) =
          pack_f32(epilogue(v0, a.act), epilogue(v1, a.act));
    }
  }
  named_sync(1, 128 * kPreMath);
  constexpr int CH = kPreBN / 8;  // 16-byte pieces of a row
  for (int i = tid; i < BM * CH; i += 128 * kPreMath) {
    const int r = i / CH, ch = i % CH, gm = m0 + r, gn = n0 + 8 * ch;
    if (gm >= a.M || gn >= a.N) continue;
    const unsigned char* src = os + r * P::kPitch + ch * 16;
    __nv_bfloat16* dst = a.out + (long long)gm * a.N + gn;
    if (a.vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gn + e < a.N; ++e)
        dst[e] = reinterpret_cast<const __nv_bfloat16*>(src)[e];
    }
  }
}

template <int BM>
cudaError_t launch_prefill(const PreArgs& a, cudaStream_t stream) {
  using P = Pre<BM>;
  CUtensorMap tx, tw;
  memset(&tx, 0, sizeof(tx));
  memset(&tw, 0, sizeof(tw));
  cudaError_t e = cudaSuccess;
  if (a.vec) {
    e = tensor_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K, a.M, 2ull * a.K, kPreBK,
                      BM);
    if (e != cudaSuccess) return e;
    e = tensor_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.N, a.K, a.N, kPreBN, kPreBK);
    if (e != cudaSuccess) return e;
  }
  static int attr_dev = -1;  // the device whose attribute is set
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (attr_dev != dev) {
    e = cudaFuncSetAttribute(matmul_w8a16_prefill_kernel<BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(P::kSmem));
    if (e != cudaSuccess) return e;
    attr_dev = dev;
  }
  const dim3 grid((a.M + BM - 1) / BM, (a.N + kPreBN - 1) / kPreBN);
  matmul_w8a16_prefill_kernel<BM><<<grid, kPreThreads, P::kSmem, stream>>>(a, tx, tw);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes by
// repro_torch/kernels/matmul_int8/matmul_int8.py.  Returns a cudaError_t
// (0 on success), or -1 when the arguments are not ones the kernel takes
// (the Python wrapper checks them first).  x, w, out contiguous row-major;
// bias may be null.  The prefill kernel (any M >= 1; the wrapper sends
// M > 16): bm in {64, 128, 256} token rows, bn 128 columns, bk 64; act 0
// none, 1 silu, 2 gelu (tanh), 3 relu.
extern "C" int matmul_w8a16_forward(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int M, int N, int K, int bm,
                                    int bn, int bk, int act, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (bm != 64 && bm != 128 && bm != 256) || bn != kPreBN ||
      bk != kPreBK || act < 0 || act > 3)
    return -1;
  const bool vec = K % 8 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const PreArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                  static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<__nv_bfloat16*>(out), M, N, K, act, vec ? 1 : 0,
                  vec_out ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bm == 64    ? launch_prefill<64>(a, st)
                        : bm == 128 ? launch_prefill<128>(a, st)
                                    : launch_prefill<256>(a, st);
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
