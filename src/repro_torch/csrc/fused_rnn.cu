// Fused LSTM/GRU serving kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_rnn/fused_rnn.py:
//   fused_lstm (_lstm_kernel, _lstm_kernel_persistent) and
//   fused_gru  (_gru_kernel,  _gru_kernel_persistent).
//
// What they compute, per time step t and batch row b:
//   zx = s_x * (bf16(x_t) . W_x)        zh = s_h * (bf16(h_{t-1}) . W_h)
//   (int8 or bf16 weights widened exactly, f32 accumulation, the per-(gate,
//   unit) scale applied after the sum)
//   LSTM (gates i, j, f, o): z = zx + zh + b; c = f*c + i*j; h = o*tanh(c)
//   GRU  (gates r, z, n):    zx += b_x; zh += b_h; r = sig(zx_r + zh_r);
//        z = sig(zx_z + zh_z); n = tanh(zx_n + r*zh_n); h = (1-z)*n + z*h
//   y_t = bf16(h); h and c stay f32.
//
// Streaming mode (the serving path) is two kernels:
//   * xproj_kernel, once per call: zx for all T*B rows at once, the product
//     the TPU kernel makes inside each grid step (_gates_matmul's x half),
//     hoisted because x_t is known for all T before the recurrence starts:
//     half of a step's weight bytes do not depend on h.  An (M = T*B) x
//     (N = G*H) x (K = D) product, the scale after the sum, then the bias
//     (b, or b_x), into f32 scratch.  What bounds it: at M = 1..50 (the
//     short DeepBench tasks) reading the int8 weight (K*N bytes, 0.3-16.8
//     MB); at M >= 150 the bf16 tensor cores (2*M*K*N operations).  The
//     first version (mma.sync on a 64 x 128 tile, 32-deep k-steps loaded
//     with __ldg through registers, int8 widened by I2F and restaged in
//     bf16) was latency-bound on its k-steps, 5-6x torch.matmul.  Its
//     redesign is matmul_int8.cu's prefill mainloop (route (b): the kernel
//     is written here on hopper.cuh's helpers, where that mainloop's
//     pieces now live, so matmul_int8.cu's code generation did not move):
//     out^T = W^T x^T, a loader warp keeping a ring of TMA boxes (x: 64 k x
//     bm rows, int8 W: 64 rows x 128 bytes, both with the 128-byte
//     swizzle), two math warpgroups of 64 output columns with the weight as
//     wgmma's A operand widened in registers (ldmatrix.trans + widen_slice,
//     no I2F, nothing restaged), x as its B operand from shared memory.
//     What differs: bm (16 .. 256 rows, fused_rnn.py:xproj_bm) follows M,
//     and K may be split over the CTAs of a cluster (S = 1 or 2,
//     fused_rnn.py:xproj_splits, a function of N, K and the SM count
//     alone): at small M a CTA's time follows its K steps, not its bytes,
//     so a split fills the card.  The epilogue stages each split's f32
//     sums in its ring; rank s then adds the S splits' sums of its share of
//     the tile in the order 0, 1, ..., S-1 through distributed shared
//     memory, applies the scale, then the bias, with no rounding, and
//     stores whole 16-byte row pieces of zx.  A batch row equals its
//     request alone, bit for bit: an output's sum order (k16 slices, K
//     steps, then the splits, in order) depends on K, N and the SM count,
//     never on M, and every bm gives the same bits.  Ragged and unaligned
//     shapes (K % 8, N % 16, unaligned x or W) take element-wise loads by
//     the loader warp into the same layouts.  bf16 weights (not on the
//     DeepBench path) keep the first mma.sync kernel, xproj_bf16_kernel.
//     Measured (H100 80GB HBM3, 700 W; PERF.md section 6): the ten
//     DeepBench projections 224 us against the first kernel's 560; at M =
//     1..50 5-12 us a call, at M >= 375 2.3-3x torch.matmul on bf16
//     weights (the shared mainloop reaches about half the tensor peak).
//     Tried and not kept (the same card): more K splits (S = 4..8 win up
//     to 2 us at M = 1 but cost 40-130 % at M >= 375, and S may not follow
//     M); two accumulator sets a CTA, alternate k16 slices (no faster at
//     any M: the wgmma chain is not what bounds a small-M CTA).
//   * rnn_stream_kernel, one launch per step, which reads only W_h: g*H*H
//     bytes a step in int8 (19.7 MB at gru-2560, 4.2 MB at lstm-1024, from
//     L2, which holds it).  What bounds a step now is that stream (at about
//     2 FLOPs a byte, and the widening and FMAs that go with it) and the
//     fixed cost of a dependent step: waiting for step t-1, reading h_{t-1},
//     the sums across threads and CTAs, the gates.  Geometry: a tile of bh
//     units x all G gates is split by rows of W_h over the cs CTAs of a
//     thread block cluster (grid cs x H/bh, cs chosen on the host so that
//     the grid covers the SMs); each thread issues 16-byte loads (16 int8
//     codes or 8 bf16 values of one row and gate) and keeps U of them in
//     flight on a rolling register ring, widening int8 with a byte permute
//     and one add (no I2F).  Partials are summed in a fixed order: a
//     thread's rows in order, the CTA's row splits through shared memory
//     (P lanes an output, then a butterfly), then the cluster's CTAs in rank
//     order through distributed shared memory, the rank that owns a (row,
//     unit) finishing its gates.  Steps are chained by programmatic
//     dependent launch: step t+1's CTAs, resident beside step t's (two an
//     SM), issue their first W_h loads and read their gate operands that do
//     not depend on h (zx, scales, b_h) before griddepcontrol.wait, and
//     h_{t-1}, c after it.  Step 0 is launched plainly, after the projection
//     has finished.
// Persistent mode keeps its original kernel unchanged: one cooperative launch
// for all T, each CTA's slice of W_x and W_h in shared memory (the GPU
// analogue of the paper's PMU-resident weights), the in-step product of x_t
// and h_{t-1} with 4-byte loads, and a grid barrier between steps; the host
// checks co-residency before launching.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per CTA (fused_rnn.py: THREADS)
constexpr int kVec = 4;        // persistent: units per thread slot (fused_rnn.py: VEC)
constexpr int kBch = 4;        // batch rows per pass (fused_rnn.py: BCH)
constexpr int kLoad = 16;      // streaming: bytes per weight load (fused_rnn.py: LOAD_BYTES)
constexpr int kMaxCluster = 8; // streaming: CTAs of a cluster at most (fused_rnn.py: MAX_CLUSTER)

// ===========================================================================
// Persistent mode: the original kernel, kept as it was (its code generation,
// and so its time, does not move): the in-step product of x_t|h_{t-1}
// against the CTA's W_x|W_h slice in shared memory.
// ===========================================================================

struct Args {
  const __nv_bfloat16* x;  // (T, B, D)
  const void* wx;          // (D, G, H) int8 or bf16
  const void* wh;          // (H, G, H)
  const float* sx;         // (G, H)
  const float* sh;         // (G, H)
  const float* b;          // (G, H): LSTM bias, GRU b_x
  const float* b_h;        // (G, H): GRU b_h (unused by the LSTM)
  float* hbuf;             // (2, B, H): h by step parity; [0] holds h0
  float* c;                // (B, H): LSTM cell state, updated in place
  __nv_bfloat16* y;        // (T, B, H)
  int T, B, D, H, bh, ks, bch, w_bf16;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory carve-up, in this order: [weight slice (persistent only)]
// [x_t|h_{t-1} staged as bf16: bch x (D+H)] [x-part partials: ks x bch x G*bh]
// [h-part partials: same].  fused_rnn.py:smem_bytes computes the same sum.
struct Layout {
  size_t w, xh, redx, redh, total;
};

__host__ __device__ inline Layout layout(int G, int D, int H, int bh, int ks, int bch,
                                         int w_bf16, bool persistent) {
  const size_t R = size_t(D) + H;
  Layout l;
  l.w = 0;
  const size_t wsz = persistent ? align16(R * G * bh * (w_bf16 ? 2 : 1)) : 0;
  l.xh = wsz;
  l.redx = l.xh + align16(size_t(bch) * R * sizeof(__nv_bfloat16));
  const size_t red = size_t(ks) * bch * G * bh * sizeof(float);
  l.redh = l.redx + red;
  l.total = l.redh + red;
  return l;
}

template <bool kBf16>
__device__ __forceinline__ void load4(const void* base, size_t idx, float w[kVec]) {
  if constexpr (kBf16) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + idx);
    w[0] = __uint_as_float(v.x << 16);
    w[1] = __uint_as_float(v.x & 0xffff0000u);
    w[2] = __uint_as_float(v.y << 16);
    w[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    const char4 v = *reinterpret_cast<const char4*>(
        reinterpret_cast<const int8_t*>(base) + idx);
    w[0] = static_cast<float>(v.x);
    w[1] = static_cast<float>(v.y);
    w[2] = static_cast<float>(v.z);
    w[3] = static_cast<float>(v.w);
  }
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

// acc[b][v] += sum_{r = k, k+ks, ...< nrows} xh[b][row0 + r] * w[(r*G + g)*stride + col + v]
// Rows are taken kUnroll at a time, all loads first, so that kUnroll loads
// are in flight per thread; each accumulator still sums rows in order.
template <int G, bool kBf16>
__device__ __forceinline__ void dot_rows(const void* w, size_t stride, int g, size_t col,
                                         const __nv_bfloat16* xh, int R, int row0, int nrows,
                                         int k, int ks, int nb, float acc[kBch][kVec]) {
  constexpr int kUnroll = 8;
  int r = k;
  for (; r + (kUnroll - 1) * ks < nrows; r += kUnroll * ks) {
    float wv[kUnroll][kVec];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      load4<kBf16>(w, (size_t(r + j * ks) * G + g) * stride + col, wv[j]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
      for (int b = 0; b < kBch; ++b) {
        if (b < nb) {
          const float xv = __bfloat162float(xh[b * R + row0 + r + j * ks]);
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[b][v] = fmaf(xv, wv[j][v], acc[b][v]);
        }
      }
    }
  }
  for (; r < nrows; r += ks) {
    float wv[kVec];
    load4<kBf16>(w, (size_t(r) * G + g) * stride + col, wv);
#pragma unroll
    for (int b = 0; b < kBch; ++b) {
      if (b < nb) {
        const float xv = __bfloat162float(xh[b * R + row0 + r]);
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[b][v] = fmaf(xv, wv[v], acc[b][v]);
      }
    }
  }
}

// Both halves of a work item's product: rows of W_x against x_t, then rows
// of W_h against h_{t-1}.  ws is the shared-memory weight slice (W_h rows
// follow W_x rows, each G*bh wide), or null to read global memory.
template <int G, bool kBf16>
__device__ __forceinline__ void dot_item(const Args& a, const void* ws, int u0, int g, int q,
                                         const __nv_bfloat16* xh, int k, int nb,
                                         float accx[kBch][kVec], float acch[kBch][kVec]) {
  using W = typename std::conditional<kBf16, __nv_bfloat16, int8_t>::type;
  const int D = a.D, H = a.H, R = D + H;
  if (ws) {
    const W* w = static_cast<const W*>(ws);
    const size_t col = size_t(q) * kVec;
    dot_rows<G, kBf16>(w, a.bh, g, col, xh, R, 0, D, k, a.ks, nb, accx);
    dot_rows<G, kBf16>(w + size_t(D) * G * a.bh, a.bh, g, col, xh, R, D, H, k, a.ks, nb, acch);
  } else {
    const size_t col = size_t(u0) + size_t(q) * kVec;
    dot_rows<G, kBf16>(a.wx, H, g, col, xh, R, 0, D, k, a.ks, nb, accx);
    dot_rows<G, kBf16>(a.wh, H, g, col, xh, R, D, H, k, a.ks, nb, acch);
  }
}

// One time step for this CTA's bh units.  ws is the shared-memory weight
// slice in persistent mode (rows 0..D from W_x, then D..D+H from W_h, each
// row G*bh wide), or null to read the weights from global memory.
template <int G>
__device__ void cell_step(const Args& a, int t, const void* ws, unsigned char* smem,
                          const Layout& L) {
  const int D = a.D, H = a.H, bh = a.bh, R = D + H;
  const int u0 = blockIdx.x * bh;
  const int tid = threadIdx.x;
  const int qn = bh / kVec;      // slots per gate
  const int slots = G * qn;
  const float* hprev = a.hbuf + size_t(t & 1) * a.B * H;
  float* hnext = a.hbuf + size_t((t & 1) ^ 1) * a.B * H;
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(smem + L.xh);
  float* redx = reinterpret_cast<float*>(smem + L.redx);
  float* redh = reinterpret_cast<float*>(smem + L.redh);

  for (int b0 = 0; b0 < a.B; b0 += kBch) {
    const int nb = min(kBch, a.B - b0);
    // stage x_t and h_{t-1}, rounded to bf16 as the product's operands
    for (int i = tid; i < nb * R; i += blockDim.x) {
      const int b = i / R, r = i - b * R;
      xh[b * R + r] = r < D ? a.x[(size_t(t) * a.B + b0 + b) * D + r]
                            : __float2bfloat16_rn(__ldcg(hprev + size_t(b0 + b) * H + (r - D)));
    }
    __syncthreads();

    // partial dot products: work item (k, g, q) sums rows k, k+ks, ...
    for (int item = tid; item < a.ks * slots; item += blockDim.x) {
      const int k = item / slots, s = item - k * slots;
      const int g = s / qn, q = s - g * qn;
      float accx[kBch][kVec] = {}, acch[kBch][kVec] = {};
      if (a.w_bf16)
        dot_item<G, true>(a, ws, u0, g, q, xh, k, nb, accx, acch);
      else
        dot_item<G, false>(a, ws, u0, g, q, xh, k, nb, accx, acch);
      for (int b = 0; b < nb; ++b) {
        const size_t base = (size_t(k) * nb + b) * G * bh + size_t(g) * bh + size_t(q) * kVec;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          redx[base + v] = accx[b][v];
          redh[base + v] = acch[b][v];
        }
      }
    }
    __syncthreads();

    // reduce over k, scale, bias, nonlinearities, state update
    for (int i = tid; i < nb * bh; i += blockDim.x) {
      const int b = i / bh, ul = i - b * bh, u = u0 + ul;
      const size_t row = size_t(b0 + b) * H + u;
      float zx[G], zh[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sx = 0.f, sh = 0.f;
        for (int k = 0; k < a.ks; ++k) {
          const size_t idx = (size_t(k) * nb + b) * G * bh + size_t(g) * bh + ul;
          sx += redx[idx];
          sh += redh[idx];
        }
        zx[g] = sx * a.sx[g * H + u];
        zh[g] = sh * a.sh[g * H + u];
      }
      float h_new;
      if constexpr (G == 4) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = zx[g] + zh[g] + a.b[g * H + u];
        const float ig = sigmoidf_(z[0]), jg = tanhf(z[1]);
        const float fg = sigmoidf_(z[2]), og = sigmoidf_(z[3]);
        const float c_new = fg * a.c[row] + ig * jg;
        h_new = og * tanhf(c_new);
        a.c[row] = c_new;
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          zx[g] += a.b[g * H + u];
          zh[g] += a.b_h[g * H + u];
        }
        const float rg = sigmoidf_(zx[0] + zh[0]);
        const float zg = sigmoidf_(zx[1] + zh[1]);
        const float ng = tanhf(zx[2] + rg * zh[2]);
        h_new = (1.0f - zg) * ng + zg * __ldcg(hprev + row);
      }
      hnext[row] = h_new;
      a.y[size_t(t) * a.B * H + row] = __float2bfloat16_rn(h_new);
    }
    __syncthreads();  // xh and the partials are reused by the next batch chunk
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads, 2) rnn_persistent_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(G, a.D, a.H, a.bh, a.ks, a.bch, a.w_bf16, true);
  const int D = a.D, H = a.H, bh = a.bh, R = D + H, qn = bh / kVec;
  const int u0 = blockIdx.x * bh;
  // copy this CTA's weight slice into shared memory once: row r, gate g
  // holds units u0..u0+bh, from W_x for r < D and W_h after
  for (int i = threadIdx.x; i < R * G * qn; i += blockDim.x) {
    const int r = i / (G * qn), rem = i - r * G * qn;
    const int g = rem / qn, q = rem - g * qn;
    const size_t src = (size_t(r < D ? r : r - D) * G + g) * H + u0 + size_t(q) * kVec;
    const size_t dst = (size_t(r) * G + g) * bh + size_t(q) * kVec;
    if (a.w_bf16) {
      const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(r < D ? a.wx : a.wh);
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(smem + L.w) + dst) =
          *reinterpret_cast<const uint2*>(w + src);
    } else {
      const int8_t* w = static_cast<const int8_t*>(r < D ? a.wx : a.wh);
      *reinterpret_cast<uint32_t*>(smem + L.w + dst) =
          *reinterpret_cast<const uint32_t*>(w + src);
    }
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < a.T; ++t) {
    cell_step<G>(a, t, smem + L.w, smem, L);
    grid.sync();  // h_t of every CTA is visible before step t+1 reads it
  }
}

// LSTM gates from the pre-activations z (i, j, f, o); updates c, returns h.
__device__ __forceinline__ float lstm_gates(const float z[4], float& c) {
  const float ig = sigmoidf_(z[0]), jg = tanhf(z[1]);
  const float fg = sigmoidf_(z[2]), og = sigmoidf_(z[3]);
  c = fg * c + ig * jg;
  return og * tanhf(c);
}

// GRU gates from zx (with b_x) and zh (with b_h); returns h.
__device__ __forceinline__ float gru_gates(const float zx[3], const float zh[3], float h_old) {
  const float rg = sigmoidf_(zx[0] + zh[0]);
  const float zg = sigmoidf_(zx[1] + zh[1]);
  const float ng = tanhf(zx[2] + rg * zh[2]);
  return (1.0f - zg) * ng + zg * h_old;
}

// ===========================================================================
// Streaming mode, kernel 1: the input projection for all T*B rows
// ZX[m, n] = s[n] * sum_k bf16(x[m, k]) * W[k, n] + bias[n]   (N = G*H)
// ===========================================================================

// Cluster barrier halves (PTX): arrive with release (this CTA's shared-memory
// writes become visible to the cluster) or relaxed (no ordering, only "I am
// done reading"), and wait with acquire.  cluster_group::sync() would add a
// GPU-wide fence to each.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// --- int8 weights (the DeepBench path): wgmma, the weight as A in registers --

constexpr int kXK = 64;                       // K a step: one 128-byte swizzle row of bf16
constexpr int kXN = 128;                      // output columns a CTA: one 128-byte box of W
constexpr int kXMath = 2;                     // math warpgroups, 64 output columns each
constexpr int kXThreads = 128 * kXMath + 32;  // + one loader warp (fused_rnn.py: XPROJ_THREADS)
constexpr int kXBox = kXK * kXN;              // int8 W of one step: 8 KB
constexpr int kXMaxSplit = 8;                 // K splits a cluster at most (fused_rnn.py: XPROJ_MAX_SPLIT)
constexpr int kXPitch = kXN * 4 + 16;         // bytes of a staged f32 row: banks spread

// One CTA at BM rows of M (fused_rnn.py: xproj_smem_bytes): a ring of
// kStages x (x: BM rows x 128 bytes, int8 W: 64 rows x 128 bytes), each on a
// 1024-byte boundary, plus 1 KB to align the base: 80-96 KB up to BM = 128,
// so that two CTAs share an SM, and 201 KB at BM = 256.
template <int BM>
struct XP {
  static constexpr int kX = BM * kXK * 2;
  static constexpr int kStage = kX + kXBox;
  static constexpr int kStages = BM <= 32 ? 8 : BM == 64 ? 6 : BM == 128 ? 4 : 5;
  static constexpr size_t kSmem = size_t(kStages) * kStage + 1024;
  static_assert(size_t(BM) * kXPitch <= size_t(kStages) * kStage,
                "the staged f32 tile must fit the ring");
};

struct XArgs {
  const __nv_bfloat16* x;  // (M, K) row-major
  const int8_t* w;         // (K, N) row-major
  const float* s;          // (N,)
  const float* bias;       // (N,)
  float* zx;               // (M, N) row-major
  int M, K, N, splits;
  int vec;      // x and W rows 16-byte aligned: TMA loads, else element-wise
  int vec_out;  // zx rows 16-byte aligned: 16-byte stores
};

// First K step of split s of S over nk steps: every split gets floor or ceil
// of nk / S steps, none is empty while S <= nk.
__device__ __forceinline__ int xsplit_step(int s, int S, int nk) {
  return static_cast<int>(static_cast<long long>(s) * nk / S);
}

// Stage K step k0.. (the j-th of this CTA) of x (BM rows from m0) and W (64
// rows x 128 columns from n0) into ring stage j % kStages once it is free:
// TMA boxes counted on full (lane 0), or element-wise into the TMA's layouts
// when rows are not 16-byte aligned (the whole warp).
template <int BM>
__device__ __forceinline__ void xproj_load(const XArgs& a, const CUtensorMap* tx,
                                           const CUtensorMap* tw, unsigned char* ring,
                                           uint64_t* full, uint64_t* empty, int j, int k0, int m0,
                                           int n0, int lane) {
  using P = XP<BM>;
  const int s = j % P::kStages;
  unsigned char* xs = ring + s * P::kStage;
  unsigned char* ws = xs + P::kX;
  mbar_wait(&empty[s], ((j / P::kStages) & 1) ^ 1);
  if (a.vec) {
    mbar_expect_arrive(&full[s], unsigned(P::kStage));
    tma_load_2d(xs, tx, k0, m0, &full[s]);
    tma_load_2d(ws, tw, n0, k0, &full[s]);
    return;
  }
  __nv_bfloat16* xe = reinterpret_cast<__nv_bfloat16*>(xs);
  for (int i = lane; i < BM * kXK; i += 32) {
    const int r = i / kXK, c = i % kXK, gm = m0 + r, gk = k0 + c;
    xe[x_at(r, c)] =
        gm < a.M && gk < a.K ? a.x[(long long)gm * a.K + gk] : __float2bfloat16_rn(0.f);
  }
  for (int i = lane; i < kXBox; i += 32) {
    const int r = i / kXN, c = i % kXN, gk = k0 + r, gn = n0 + c;
    ws[w_at(r, c >> 4) + (c & 15)] = gk < a.K && gn < a.N ? a.w[(long long)gk * a.N + gn] : 0;
  }
  fence_proxy_async();  // x is read by wgmma
  __syncwarp();
  if (lane == 0) mbar_arrive(&full[s]);
}

// CTA (blockIdx.x, blockIdx.y, blockIdx.z) = (K split = rank in its cluster
// of S, BM-row tile of M, 128-column tile of N).  tx, tw: tensor maps of x
// (box 64 x BM) and W (box 128 x 64), used when a.vec.
template <int BM>
__global__ void __launch_bounds__(kXThreads, BM <= 64 ? 2 : 1)
    xproj_kernel(XArgs a, const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw) {
  using P = XP<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[P::kStages], empty[P::kStages];
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.z * kXN;
  const int nk = (a.K + kXK - 1) / kXK;
  const int st0 = xsplit_step(split, a.splits, nk);
  const int nst = xsplit_step(split + 1, a.splits, nk) - st0;
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kXMath);  // lane 0 of each math warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float* part = reinterpret_cast<float*>(ring);  // the staged tile, BM x kXPitch bytes
  if (warp == 4 * kXMath) {  // ---- the loader warp: the ring ----------------
    if (!a.vec || lane == 0)
      for (int j = 0; j < nst; ++j)
        xproj_load<BM>(a, &tx, &tw, ring, full, empty, j, (st0 + j) * kXK, m0, n0, lane);
    __syncwarp();
  } else {
    // ---- math warpgroup mg: output columns 64 mg .. 64 mg + 63 of the tile
    // One wgmma group a k16 slice, four in flight: slice q of step j is
    // widened into A[q] as soon as slice q of step j - 1 is done with it
    // (wait_group 3), then issued, so widening runs under the tensor cores.
    // Step j - 1's stage is freed once its last slice is done.
    const int mg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
    const int chunk = 4 * mg + wl;
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    uint32_t A[kXK / 16][4];
    for (int j = 0; j < nst; ++j) {
      const int s = j % P::kStages;
      unsigned char* xs = ring + s * P::kStage;
      const uint64_t db = sw128_desc(xs);
      mbar_wait(&full[s], (j / P::kStages) & 1);
#pragma unroll
      for (int q = 0; q < kXK / 16; ++q) {
        if (j > 0) {
          wgmma_wait<kXK / 16 - 1>();  // slice q of step j - 1 is done
          fence_regs(A);
        }
        if (q == kXK / 16 - 1 && j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % P::kStages]);
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
    // the split's f32 sums, unscaled, staged in the ring (both math
    // warpgroups are past their last wgmma first).  This thread holds output
    // columns cl, cl + 1 of rows 8 i + 2 t + {0, 1}.
    named_sync(1, 128 * kXMath);
    const int cl = 64 * mg + 16 * wl + 2 * g;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        *reinterpret_cast<float2*>(part + (8 * i + 2 * t + c) * (kXPitch / 4) + cl) =
            make_float2(acc[4 * i + c], acc[4 * i + 2 + c]);
  }
  // every split's tile visible to the cluster (a lone CTA: to its threads)
  cg::cluster_group cluster = cg::this_cluster();
  if (a.splits > 1) {
    cluster_arrive_release();
    cluster_wait();
  } else {
    __syncthreads();
  }
  // rank `split` finishes its share of the tile's 16-byte row pieces: the
  // splits' sums added in the order 0, 1, ..., S-1, then the scale, then the
  // bias, in f32; whole row pieces of zx stored.
  constexpr int CH = kXN / 4;  // 16-byte pieces of a row
  const int lo = split * BM * CH / a.splits, hi = (split + 1) * BM * CH / a.splits;
  for (int i = lo + tid; i < hi; i += kXThreads) {
    const int r = i / CH, ch = i % CH, gm = m0 + r, gn = n0 + 4 * ch;
    if (gm >= a.M || gn >= a.N) continue;
    const int off = r * (kXPitch / 4) + 4 * ch;
    float4 v;
    if (a.splits == 1) {
      v = *reinterpret_cast<const float4*>(part + off);
    } else {
      v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + off);
      for (int rk = 1; rk < a.splits; ++rk) {
        const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, rk) + off);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    }
    const float o[4] = {v.x, v.y, v.z, v.w};
    float z[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) z[e] = gn + e < a.N ? o[e] * a.s[gn + e] + a.bias[gn + e] : 0.f;
    float* dst = a.zx + (long long)gm * a.N + gn;
    if (a.vec_out) {
      *reinterpret_cast<float4*>(dst) = make_float4(z[0], z[1], z[2], z[3]);
    } else {
      for (int e = 0; e < 4 && gn + e < a.N; ++e) dst[e] = z[e];
    }
  }
  // no CTA leaves while another reads its tile
  if (a.splits > 1) {
    __syncwarp();
    cluster_arrive_relaxed();
    cluster_wait();
  }
}

template <int BM>
cudaError_t launch_xproj(const XArgs& a, cudaStream_t stream) {
  using P = XP<BM>;
  CUtensorMap tx, tw;
  memset(&tx, 0, sizeof(tx));
  memset(&tw, 0, sizeof(tw));
  cudaError_t e = cudaSuccess;
  if (a.vec) {
    e = tensor_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K, a.M, 2ull * a.K, kXK, BM);
    if (e != cudaSuccess) return e;
    e = tensor_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.N, a.K, a.N, kXN, kXK);
    if (e != cudaSuccess) return e;
  }
  static int attr_dev = -1;  // the device whose attribute is set
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (attr_dev != dev) {
    e = cudaFuncSetAttribute(xproj_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(P::kSmem));
    if (e != cudaSuccess) return e;
    attr_dev = dev;
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, (a.M + BM - 1) / BM, (a.N + kXN - 1) / kXN);
  cfg.blockDim = dim3(kXThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, xproj_kernel<BM>, a, tx, tw);
  return cudaGetLastError();
}

// --- bf16 weights: the first, mma.sync kernel (not on the DeepBench path) ----

constexpr int kPM = 64, kPN = 128, kPK = 32;  // CTA tile (fused_rnn.py: XPROJ_BF16_TILE)
constexpr int kPSa = kPK + 8;                 // x tile row stride (bf16): no bank conflicts
constexpr int kPSb = kPN + 8;                 // W tile row stride (bf16)

struct ProjArgs {
  const __nv_bfloat16* x;  // (M, K)
  const __nv_bfloat16* w;  // (K, N)
  const float* s;          // (N)
  const float* bias;       // (N)
  float* zx;               // (M, N)
  int M, K, N;
  int x_vec, w_vec;        // 8-element chunks may be loaded as one vector
};

// 8 consecutive x values of row m from column k, zero past the edges.
__device__ __forceinline__ uint4 load_x8(const ProjArgs& a, int m, int k) {
  if (m >= a.M) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* p = a.x + size_t(m) * a.K + k;
  if (a.x_vec && k + 8 <= a.K) return __ldg(reinterpret_cast<const uint4*>(p));
  uint16_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = k + i < a.K ? __bfloat16_as_ushort(p[i]) : uint16_t(0);
  return make_uint4(e[0] | (uint32_t(e[1]) << 16), e[2] | (uint32_t(e[3]) << 16),
                    e[4] | (uint32_t(e[5]) << 16), e[6] | (uint32_t(e[7]) << 16));
}

// 8 consecutive weights of row k from column n, zero past the edges.
__device__ __forceinline__ uint4 load_w8(const ProjArgs& a, int k, int n) {
  if (k >= a.K) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* p = a.w + size_t(k) * a.N + n;
  if (a.w_vec && n + 8 <= a.N) return __ldg(reinterpret_cast<const uint4*>(p));
  uint16_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = n + i < a.N ? __bfloat16_as_ushort(p[i]) : uint16_t(0);
  return make_uint4(e[0] | (uint32_t(e[1]) << 16), e[2] | (uint32_t(e[3]) << 16),
                    e[4] | (uint32_t(e[5]) << 16), e[6] | (uint32_t(e[7]) << 16));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 warps as 2 (rows) x 4 (columns), each a 32 x 32 block of 2 x 4 mma
// tiles; the x and W tiles double-buffered in shared memory, the next
// k-step's loads held in registers while this one is multiplied.
__global__ void __launch_bounds__(kThreads) xproj_bf16_kernel(ProjArgs a) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][kPM * kPSa];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kPK * kPSb];
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  // staging: one 8-element chunk of x and two of W per thread a k-step
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr0 = tid >> 4, wc = (tid & 15) * 8;
  const int nk = (a.K + kPK - 1) / kPK;
  uint4 rx, rw[2];
  auto load = [&](int kt) {
    const int k0 = kt * kPK;
    rx = load_x8(a, m0 + xr, k0 + xc);
#pragma unroll
    for (int i = 0; i < 2; ++i) rw[i] = load_w8(a, k0 + wr0 + 16 * i, n0 + wc);
  };
  auto store = [&](int buf) {
    *reinterpret_cast<uint4*>(&sa[buf][xr * kPSa + xc]) = rx;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&sb[buf][(wr0 + 16 * i) * kPSb + wc]) = rw[i];
  };
  float acc[2][4][4] = {};
  load(0);
  store(0);
  __syncthreads();
  // ldmatrix row addresses: lanes 0-7 / 8-15 / 16-23 / 24-31 give the rows
  // of the four 8x8 matrices (rows +0 / +8, columns +0 / +8)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &sa[cur][(wm + mi * 16 + lr) * kPSa + kk + lc]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], &sb[cur][(kk + lr) * kPSb + wn + nj * 16 + lc]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                         bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
  // scale after the sum, then the bias; f32 out
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + (lane >> 2) + h * 8;
        if (m >= a.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < a.N)
            a.zx[size_t(m) * a.N + n + e] = acc[mi][ni][h * 2 + e] * a.s[n + e] + a.bias[n + e];
      }
    }
  }
}

// ===========================================================================
// Streaming mode, kernel 2: one recurrence step, W_h only
// ===========================================================================

struct StepArgs {
  const float* zx;    // (T*B, G*H) f32: the x half with its bias (b, or b_x)
  const void* wh;     // (H, G, H) int8 or bf16
  const float* sh;    // (G, H)
  const float* b_h;   // (G, H): GRU b_h (unused by the LSTM)
  float* hbuf;        // (2, B, H): h by step parity; [0] holds h0
  float* c;           // (B, H): LSTM cell state, updated in place
  __nv_bfloat16* y;   // (T, B, H)
  int B, H, bh, cs, ks, bch;
};

// Dynamic shared memory (fused_rnn.py:smem_bytes): h_{t-1} staged as bf16
// (bch x H), then the f32 partials of the CTA's row splits (ks x bch x G x bh),
// whose first split also carries the CTA's sum to the cluster.
__host__ __device__ inline size_t stream_red_offset(int H, int bch) {
  return align16(size_t(bch) * H * sizeof(__nv_bfloat16));
}
__host__ __device__ inline size_t stream_smem(int G, int H, int bh, int ks, int bch) {
  return stream_red_offset(H, bch) + size_t(ks) * bch * G * bh * sizeof(float);
}

// acc[b][v] += h[b] * w[v] for the V weights of one 16-byte load.
template <bool kBf16, int NB>
__device__ __forceinline__ void fma_load(const uint4& w, const float (&hv)[NB],
                                         float (&acc)[NB][kBf16 ? 8 : 16]) {
  const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kBf16) {
      const float lo = __uint_as_float(wd[k] << 16), hi = __uint_as_float(wd[k] & 0xffff0000u);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        acc[b][2 * k] = fmaf(hv[b], lo, acc[b][2 * k]);
        acc[b][2 * k + 1] = fmaf(hv[b], hi, acc[b][2 * k + 1]);
      }
    } else {
      // code c: 0x4B000000 | (c ^ 0x80) is the float 2^23 + 128 + c exactly
      const uint32_t biased = wd[k] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u + e)) -
                        8388736.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b][4 * k + e] = fmaf(hv[b], f, acc[b][4 * k + e]);
      }
    }
  }
}

// Step t for the bh units of tile blockIdx.y, rows [r0, r1) of W_h on this
// CTA (its rank in the cluster).  NB: accumulator rows (1, or 4 for B > 1).
template <int G, bool kBf16, int NB>
__global__ void __launch_bounds__(kThreads, 2) rnn_stream_kernel(StepArgs a, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = kBf16 ? 8 : 16;                   // units per load
  constexpr int U = NB == 1 || kBf16 ? 8 : 4;         // loads in flight per thread
  constexpr int W = kBf16 ? 2 : 1;                    // bytes per weight
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = a.H, bh = a.bh, cs = a.cs, ks = a.ks;
  const int u0 = blockIdx.y * bh;
  // rows cut at multiples of 8, so that h is staged in 16-byte loads
  const int r0 = (rank * H / cs) & ~7;
  const int r1 = rank + 1 == cs ? H : ((rank + 1) * H / cs) & ~7;
  const int chunks = G * bh / V, qn = bh / V;
  const int tid = threadIdx.x;
  const int j = tid / chunks, cidx = tid - j * chunks;
  const int g = cidx / qn, q = cidx - g * qn;
  // this thread reads rows r0 + j, r0 + j + ks, ... < r1 of gate g, units
  // u0 + q*V .. + V
  const int n_rows = j < ks && r0 + j < r1 ? (r1 - r0 - j + ks - 1) / ks : 0;
  const uint4* wp = reinterpret_cast<const uint4*>(
      static_cast<const unsigned char*>(a.wh) +
      ((size_t(r0 + j) * G + g) * H + u0 + size_t(q) * V) * W);
  const size_t wstep = size_t(ks) * G * H * W / kLoad;  // uint4s between a thread's rows
  const float* hprev = a.hbuf + size_t(t & 1) * a.B * H;
  float* hnext = a.hbuf + size_t((t & 1) ^ 1) * a.B * H;
  const int gbh = G * bh;

  // The gate stage's operands for a (batch row, unit) pair p this rank
  // finishes: the x half, scale and bias (written before step 0 began),
  // and h_{t-1} (GRU) or c (LSTM), which step t-1 wrote.
  float g_zx[G], g_sh[G], g_bh[G], g_old = 0.f;
  auto gate_in = [&](int p, int b0) {
    const int b = p / bh, u = u0 + p - b * bh;
    const float* zxr = a.zx + (size_t(t) * a.B + b0 + b) * G * H + u;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      g_zx[gg] = zxr[gg * H];
      g_sh[gg] = a.sh[gg * H + u];
      g_bh[gg] = G == 3 ? a.b_h[gg * H + u] : 0.f;
    }
  };
  auto gate_old = [&](int p, int b0) {
    const int b = p / bh;
    const size_t row = size_t(b0 + b) * H + u0 + p - b * bh;
    g_old = G == 4 ? a.c[row] : __ldcg(hprev + row);
  };

  uint4 wv[U];
  auto prefetch = [&]() {
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (i < n_rows) wv[i] = __ldg(wp + i * wstep);
  };
  // Nothing above depends on step t-1: W_h's first loads and the first
  // pair's operands go out before this grid waits for it (programmatic
  // dependent launch; step 0 is launched after the projection completes)
  const int p0 = rank + cs * tid;
  const bool first = p0 < min(a.bch, a.B) * bh;
  if (first) gate_in(p0, 0);
  prefetch();
  grid_dep_launch();
  grid_dep_wait();
  if (first) gate_old(p0, 0);

  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + stream_red_offset(H, a.bch));
  // partial sums: P lanes of one warp per output, P from the tile alone
  int P = 1;
  while (P < 32 && 2 * P * gbh <= kThreads) P *= 2;
  const int ro = tid / P, rl = tid - ro * P;

  for (int b0 = 0; b0 < a.B; b0 += a.bch) {
    const int nb = min(a.bch, a.B - b0);
    if (b0 > 0) prefetch();
    // stage this CTA's rows of h_{t-1}, rounded to bf16 as the operand:
    // four 16-byte loads a thread in flight
    const int n4 = (r1 - r0) / 4, tot = nb * n4;
    for (int i0 = tid; i0 < tot; i0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kThreads;
        if (i < tot) {
          const int b = i / n4, r = r0 + 4 * (i - b * n4);
          v[k] = __ldcg(reinterpret_cast<const float4*>(hprev + size_t(b0 + b) * H + r));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kThreads;
        if (i < tot) {
          const int b = i / n4, r = r0 + 4 * (i - b * n4);
          *reinterpret_cast<uint2*>(hs + b * H + r) =
              make_uint2(pack_f32(v[k].x, v[k].y), pack_f32(v[k].z, v[k].w));
        }
      }
    }
    __syncthreads();

    // the thread's rows in order, U loads in flight on a rolling ring
    float acc[NB][V];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[b][v] = 0.f;
    for (int base = 0; base < n_rows; base += U) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int idx = base + i;
        if (idx < n_rows) {
          const int row = r0 + j + idx * ks;
          float hv[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b)
            hv[b] = b < nb ? __bfloat162float(hs[b * H + row]) : 0.f;
          fma_load<kBf16, NB>(wv[i], hv, acc);
          if (idx + U < n_rows) wv[i] = __ldg(wp + size_t(idx + U) * wstep);
        }
      }
    }
    if (j < ks) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < nb) {
          float4* dst = reinterpret_cast<float4*>(red + (size_t(j) * a.bch + b) * gbh +
                                                  size_t(g) * bh + size_t(q) * V);
#pragma unroll
          for (int v = 0; v < V / 4; ++v)
            dst[v] = make_float4(acc[b][4 * v], acc[b][4 * v + 1], acc[b][4 * v + 2],
                                 acc[b][4 * v + 3]);
        }
      }
    }
    __syncthreads();
    // the CTA's sum over its ks row splits into split 0, in a fixed order:
    // lane l of an output's P lanes sums splits l, l+P, ... in order, then
    // the P lanes are added as a butterfly
    for (int b = 0; b < nb; ++b) {
      for (int o0 = 0; o0 < gbh; o0 += kThreads / P) {
        const int o = o0 + ro;
        float s = 0.f;
        if (o < gbh)
          for (int k = rl; k < ks; k += P) s += red[(size_t(k) * a.bch + b) * gbh + o];
        for (int off = P / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (o < gbh && rl == 0) red[size_t(b) * gbh + o] = s;
      }
    }
    // every CTA's sum visible to the cluster (a lone CTA: to its threads)
    if (cs > 1) {
      cluster_arrive_release();
      cluster_wait();
    } else {
      __syncthreads();
    }

    // the (row, unit) pairs this rank owns: the cluster's sums in rank order,
    // the scale, the x half, the gates and the state update
    for (int p = p0, k = 0; p < nb * bh; p += cs * kThreads, ++k) {
      if (b0 > 0 || k > 0) {
        gate_in(p, b0);
        gate_old(p, b0);
      }
      const int b = p / bh, ul = p - b * bh;
      float zh[G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) zh[gg] = 0.f;
      for (int r = 0; r < cs; ++r) {
        const float* part = cluster.map_shared_rank(red, r) + size_t(b) * gbh + ul;
#pragma unroll
        for (int gg = 0; gg < G; ++gg) zh[gg] += part[gg * bh];
      }
      const size_t row = size_t(b0 + b) * H + u0 + ul;
      float h_new;
      if constexpr (G == 4) {
        float z[4];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) z[gg] = g_zx[gg] + zh[gg] * g_sh[gg];
        h_new = lstm_gates(z, g_old);
        a.c[row] = g_old;
      } else {
        float zhb[3];
#pragma unroll
        for (int gg = 0; gg < 3; ++gg) zhb[gg] = zh[gg] * g_sh[gg] + g_bh[gg];
        h_new = gru_gates(g_zx, zhb, g_old);
      }
      hnext[row] = h_new;
      a.y[size_t(t) * a.B * H + row] = __float2bfloat16_rn(h_new);
    }
    // no CTA reuses or leaves its partials while another reads them
    if (cs > 1) {
      cluster_arrive_relaxed();
      cluster_wait();
    } else {
      __syncthreads();
    }
  }
}

// ===========================================================================
// Host side
// ===========================================================================

template <int G>
cudaError_t persistent_forward(const Args& a, size_t smem, cudaStream_t stream) {
  auto kern = rnn_persistent_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  Args args = a;
  void* params[] = {&args};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(a.H / a.bh), dim3(kThreads),
                              params, smem, stream);
  return cudaGetLastError();
}

template <int G, bool kBf16, int NB>
cudaError_t stream_forward(const StepArgs& a, int T, size_t smem, int pdl, cudaStream_t stream) {
  auto kern = rnn_stream_kernel<G, kBf16, NB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = pdl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cs, a.H / a.bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  for (int t = 0; t < T; ++t) {
    // step 0 reads zx before its wait: it starts after the projection ends
    at[1].val.programmaticStreamSerializationAllowed = t > 0 ? pdl : 0;
    cudaLaunchKernelEx(&cfg, kern, a, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int G, bool kBf16>
cudaError_t stream_dispatch_nb(const StepArgs& a, int T, size_t smem, int pdl,
                               cudaStream_t stream) {
  return a.B == 1 ? stream_forward<G, kBf16, 1>(a, T, smem, pdl, stream)
                  : stream_forward<G, kBf16, kBch>(a, T, smem, pdl, stream);
}

template <int G>
cudaError_t stream_dispatch(const StepArgs& a, int T, int w_bf16, size_t smem, int pdl,
                            cudaStream_t stream) {
  return w_bf16 ? stream_dispatch_nb<G, true>(a, T, smem, pdl, stream)
                : stream_dispatch_nb<G, false>(a, T, smem, pdl, stream);
}

template <typename K>
cudaError_t blocks_per_sm(K kern, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, kThreads, smem);
}

template <int G, bool kBf16>
cudaError_t stream_blocks(int batch, size_t smem, int* out) {
  return batch == 1 ? blocks_per_sm(rnn_stream_kernel<G, kBf16, 1>, smem, out)
                    : blocks_per_sm(rnn_stream_kernel<G, kBf16, kBch>, smem, out);
}

}  // namespace

// Plain C interface, loaded with ctypes by repro_torch/kernels/fused_rnn/fused_rnn.py.
// Each returns a cudaError_t (0 on success), or -1 when the arguments are
// not ones the kernels take (the Python wrapper checks them first).

// Persistent mode: all T steps in one cooperative launch.
extern "C" int fused_rnn_persistent(int n_gates, const void* x, const void* wx, const void* wh,
                                    const void* sx, const void* sh, const void* b,
                                    const void* b_h, void* hbuf, void* c, void* y, int T, int B,
                                    int D, int H, int bh, int ks, int w_bf16, long long smem,
                                    void* stream) {
  if ((n_gates != 3 && n_gates != 4) || bh <= 0 || H % bh || bh % kVec || H % kVec || ks < 1 ||
      B < 1 || T < 1)
    return -1;
  Args a{static_cast<const __nv_bfloat16*>(x), wx, wh, static_cast<const float*>(sx),
         static_cast<const float*>(sh), static_cast<const float*>(b),
         static_cast<const float*>(b_h), static_cast<float*>(hbuf), static_cast<float*>(c),
         static_cast<__nv_bfloat16*>(y), T, B, D, H, bh, ks, B < kBch ? B : kBch, w_bf16};
  if (layout(n_gates, D, H, bh, ks, a.bch, w_bf16, true).total != size_t(smem)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = n_gates == 4 ? persistent_forward<4>(a, smem, s)
                                     : persistent_forward<3>(a, smem, s);
  return static_cast<int>(e);
}

// Streaming mode, kernel 1: zx (M, N) f32 from x (M, K) bf16 and W (K, N).
// int8 W: xproj_kernel<bm> over bm rows of M (16, 32, 64, 128 or 256) and
// `splits` K splits (1 .. min(8, ceil(K / 64)), the CTAs of a cluster);
// bf16 W: xproj_bf16_kernel, whose tile is fixed (bm 64, splits 1).
extern "C" int fused_rnn_xproj(const void* x, const void* w, const void* s, const void* bias,
                               void* zx, int M, int K, int N, int w_bf16, int bm, int splits,
                               void* stream) {
  if (M < 1 || K < 1 || N < 1) return -1;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x), wp = reinterpret_cast<uintptr_t>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    if (bm != kPM || splits != 1) return -1;
    ProjArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
               static_cast<const float*>(s), static_cast<const float*>(bias),
               static_cast<float*>(zx), M, K, N, K % 8 == 0 && xp % 16 == 0,
               N % 8 == 0 && wp % 16 == 0};
    const dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM);
    xproj_bf16_kernel<<<grid, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int nk = (K + kXK - 1) / kXK;
  if ((bm != 16 && bm != 32 && bm != 64 && bm != 128 && bm != 256) || splits < 1 ||
      splits > kXMaxSplit || splits > nk || (M + bm - 1) / bm > 65535)
    return -1;
  const XArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                static_cast<const float*>(s), static_cast<const float*>(bias),
                static_cast<float*>(zx), M, K, N, splits,
                K % 8 == 0 && N % 16 == 0 && xp % 16 == 0 && wp % 16 == 0,
                N % 4 == 0 && reinterpret_cast<uintptr_t>(zx) % 16 == 0};
  const cudaError_t e = bm == 16    ? launch_xproj<16>(a, st)
                        : bm == 32  ? launch_xproj<32>(a, st)
                        : bm == 64  ? launch_xproj<64>(a, st)
                        : bm == 128 ? launch_xproj<128>(a, st)
                                    : launch_xproj<256>(a, st);
  return static_cast<int>(e);
}

// Streaming mode, kernel 2: T step launches on zx, reading only W_h.
extern "C" int fused_rnn_stream(int n_gates, const void* zx, const void* wh, const void* sh,
                                const void* b_h, void* hbuf, void* c, void* y, int T, int B,
                                int H, int bh, int cs, int ks, int w_bf16, long long smem,
                                int pdl, void* stream) {
  const int vec = kLoad / (w_bf16 ? 2 : 1);
  if ((n_gates != 3 && n_gates != 4) || bh <= 0 || H % bh || bh % vec ||
      n_gates * bh / vec > kThreads || cs < 1 || cs > kMaxCluster ||
      ks != kThreads / (n_gates * bh / vec) || B < 1 || T < 1 ||
      reinterpret_cast<uintptr_t>(wh) % kLoad)
    return -1;
  const int bch = B < kBch ? B : kBch;
  if (stream_smem(n_gates, H, bh, ks, bch) != size_t(smem)) return -1;
  StepArgs a{static_cast<const float*>(zx), wh, static_cast<const float*>(sh),
             static_cast<const float*>(b_h), static_cast<float*>(hbuf), static_cast<float*>(c),
             static_cast<__nv_bfloat16*>(y), B, H, bh, cs, ks, bch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = n_gates == 4 ? stream_dispatch<4>(a, T, w_bf16, smem, pdl, s)
                                     : stream_dispatch<3>(a, T, w_bf16, smem, pdl, s);
  return static_cast<int>(e);
}

// CTAs of one kernel that fit on one SM at this dynamic shared memory size:
// the persistent kernel, or the streaming step kernel run at this batch.
extern "C" int fused_rnn_max_blocks_per_sm(int n_gates, int persistent, int w_bf16, int batch,
                                           long long smem, int* out) {
  if (n_gates != 3 && n_gates != 4) return -1;
  cudaError_t e;
  if (persistent)
    e = n_gates == 4 ? blocks_per_sm(rnn_persistent_kernel<4>, smem, out)
                     : blocks_per_sm(rnn_persistent_kernel<3>, smem, out);
  else if (n_gates == 4)
    e = w_bf16 ? stream_blocks<4, true>(batch, smem, out) : stream_blocks<4, false>(batch, smem, out);
  else
    e = w_bf16 ? stream_blocks<3, true>(batch, smem, out) : stream_blocks<3, false>(batch, smem, out);
  return static_cast<int>(e);
}
