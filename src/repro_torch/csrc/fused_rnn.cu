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
// Persistent mode (a plan's `persistent: true`) is the same projection, then
// rnn_persistent_kernel, one launch for all T steps with W_h resident: the
// GPU analogue of the paper's PMU-resident weights.  Only W_h is resident
// (zx comes from xproj_kernel), so every DeepBench cell fits: 0.3-19.7 MB
// of int8 W_h against the ~30 MB of shared memory a grid of 132 SMs holds.
//   * Geometry: a tile of bh units x all G gates (G * bh <= 128, padded to
//     m16 unit tiles), its H rows of W_h split by k-steps over a cluster of
//     cs CTAs (grid cs x H/bh); cs is the smallest cluster whose grid the
//     card holds at once, at a full pass of 8 batch rows, so it never
//     follows the batch.  The host proves residency before launch (a lone
//     CTA a tile: a cooperative launch; clusters:
//     cudaOccupancyMaxActiveClusters) and raises otherwise: the steps wait
//     on each other, which CTAs that are not resident would never do.
//   * Each CTA copies its slice once (coalesced byte reads, eight words a
//     thread in flight), in the order a step reads it: block (k-step, m16
//     tile) holds each lane's mma.sync A fragments as its 16 bytes, so a
//     warp reads the slice with 16-byte ld.shared and no bank conflicts.
//     int8 codes, stored biased by XOR 0x80, are widened exactly in
//     registers by hopper.cuh's widen_bytes (a byte permute into an f32
//     magic number and a subtract; no I2F), then out^T =
//     W_h^T h^T on the tensor cores (m16n8k16: 16 units x 8 batch rows), up
//     to four unit tiles loaded, widened and multiplied side by side, f32
//     sums, the scale after the sum.  A step costs the same for 1 to 8
//     batch rows.
//   * Sums in a fixed order: each warp takes a contiguous share of the
//     CTA's k-steps, in order; the 8 warps' partials meet as a tree through
//     shared memory; the cluster's CTAs in rank order through distributed
//     shared memory, the rank that owns a (batch row, unit) pair finishing
//     its gates.  The order depends on H, G, the tile and the card (cs),
//     never on the batch, so a batch row equals its request alone.
//   * Hand-off: y_t = bf16(h_t) is the operand of step t + 1's product, so
//     y itself carries h to the next step: slot t + 1 of a (T + 1, B, H)
//     buffer whose slot 0 is bf16(h0) and whose other slots hold an empty
//     mark (a NaN that conversion never produces) until the owner of each
//     element stores it.  Step t + 1 reloads its rows of slot t + 1 from L2
//     until none is empty; a slot is written once, so no CTA ever
//     overwrites what another still reads, and no counter, fence or grid
//     barrier sits between the steps.  h and c stay f32 with the owner of
//     their pair; zx_t, s_h, b_h and the owner's h or c are read before the
//     wait.  A wait of 2 s (a grid that was not resident after all) stops
//     the grid instead of hanging it.
//   What bounds a step (PERF.md section 6, the persistent tile sweep, H100
//   80GB HBM3 at 700 W): ~1.9 us of fixed chain (the y stores reaching L2
//   and their poll, the sums, the gates), then the resident slice at about
//   4.8x the SM's shared-memory byte time (its widening, one and a half
//   integer-pipe ops a code, and the products): 3.3 us a step at gru-1024,
//   6.2 at gru-2560 (164 KB an SM).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per CTA (fused_rnn.py: THREADS)
constexpr int kBch = 4;        // batch rows per pass (fused_rnn.py: BCH)
constexpr int kLoad = 16;      // streaming: bytes per weight load (fused_rnn.py: LOAD_BYTES)
constexpr int kMaxCluster = 8; // CTAs of a cluster at most (fused_rnn.py: MAX_CLUSTER)

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

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

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col); no side
// effects, so that the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
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
// Persistent mode: one launch for all T steps, W_h resident
// ===========================================================================

constexpr int kPWarps = kThreads / 32;  // the row splits of a CTA, one a warp
constexpr int kPBatch = 8;              // batch rows a pass: mma.sync's n
constexpr int kPMaxM = 8;               // m16 unit tiles a CTA at most (fused_rnn.py:
                                        // PERSIST_MAX_UNITS = 128 = G * bh at most):
                                        // a warp's sums, 32 registers
constexpr int kPBlock = 512;            // bytes of one (k-step, m-tile) block: 16 a lane
constexpr long long kPTimeoutNs = 2000000000LL;  // a wait this long is a deadlock
constexpr int kPCopy = 8;               // words a thread has in flight copying its slice
constexpr uint32_t kPEmpty = 0xFFFFu;   // a slot of y not yet written: a bf16 NaN that
                                        // cvt.rn.bf16.f32 never produces (its NaN is 0x7FFF)

struct PArgs {
  const float* zx;     // (T, B, G, H) f32: the x half with its bias (b, or b_x)
  const void* wh;      // (H, G, H) int8 or bf16
  const float* sh;     // (G, H)
  const float* b_h;    // (G, H): GRU b_h (unused by the LSTM)
  __nv_bfloat16* yb;   // (T + 1, B, H): [0] = bf16(h0), [t + 1] = y_t = bf16(h_t)
  float* h;            // (B, H) f32: h0 in, h_T out
  float* c;            // (B, H) f32: LSTM cell state, updated in place
  unsigned* abort;     // set by a CTA that gives up waiting (zero at launch)
  int T, B, H, bh, cs, mt, ksr, hs_words;
};

// Rows of W_h a k-step covers: two m16n8k16 k-tiles of int8 codes (16
// bytes a lane), or one of bf16 values (fused_rnn.py: persist_kstep).
template <bool kBf16>
__host__ __device__ constexpr int pkstep() {
  return kBf16 ? 16 : 32;
}

// Dynamic shared memory (fused_rnn.py: persist_smem_bytes): the resident
// slice (mt x ksr blocks), h_{t-1} of a pass staged in bf16 (bch rows of
// hs_words words), the warps' f32 partials (kPWarps x bch x 16 mt).
__host__ __device__ inline size_t persist_hs_offset(int mt, int ksr) {
  return size_t(mt) * ksr * kPBlock;
}
__host__ __device__ inline size_t persist_red_offset(int mt, int ksr, int bch, int hs_words) {
  return persist_hs_offset(mt, ksr) + size_t(bch) * hs_words * 4;
}
__host__ __device__ inline size_t persist_smem(int mt, int ksr, int bch, int hs_words) {
  return persist_red_offset(mt, ksr, bch, hs_words) + size_t(kPWarps) * bch * mt * 16 * 4;
}

// True where any of the 8 bf16 of v is the empty mark kPEmpty.
__device__ __forceinline__ bool has_empty(const uint4& v) {
  constexpr uint32_t e = kPEmpty * 0x10001u;
  return (__vcmpeq2(v.x, e) | __vcmpeq2(v.y, e) | __vcmpeq2(v.z, e) | __vcmpeq2(v.w, e)) != 0u;
}

// Rows r .. r + 7 of one batch row of h (bf16), zero past H; `fresh` reads
// from L2 each time (a slot that another CTA is still writing).
__device__ __forceinline__ uint4 load_h8(const __nv_bfloat16* src, int r, int H, bool fresh) {
  if (r + 8 <= H && (H & 7) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(src);
    return fresh ? __ldcv(p) : __ldcg(p);
  }
  const unsigned short* p = reinterpret_cast<const unsigned short*>(src);
  uint32_t e[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) e[c] = r + c < H ? (fresh ? __ldcv(p + c) : __ldcg(p + c)) : 0u;
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
}

// A thread that has waited kPTimeoutNs for a slot of h, or sees that another
// has, gives up (a grid that was not resident after all) and tells the grid.
__device__ __forceinline__ bool pgive_up(unsigned* abort, long long& t0) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
  if (t0 < 0) t0 = now;
  if (*reinterpret_cast<volatile unsigned*>(abort) || now - t0 > kPTimeoutNs) {
    atomicExch(abort, 1u);
    return true;
  }
  return false;
}

// The CTA's sum of one output over its warps' partials r[w * stride], as a
// tree in a fixed order.
__device__ __forceinline__ float wtree(const float* r, size_t stride) {
  float s[kPWarps];
#pragma unroll
  for (int w = 0; w < kPWarps; ++w) s[w] = r[w * stride];
#pragma unroll
  for (int half = kPWarps / 2; half > 0; half >>= 1)
#pragma unroll
    for (int w = 0; w < half; ++w) s[w] = s[2 * w] + s[2 * w + 1];
  return s[0];
}

// kN unit tiles from m0 of one k-step (clamped to mt - 1: a copy past mt
// goes to a sum that is never read): their loads first, then their k16
// products side by side, so that neither the widening nor a product waits
// on the tile before it.
template <int kN, bool kBf16, int KT>
__device__ __forceinline__ void ptiles(float (&acc)[kPMaxM][4], const uint4* blk, int m0, int mt,
                                       const uint32_t (&bf)[KT][2]) {
  uint4 q[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) q[i] = blk[min(m0 + i, mt - 1) * 32];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t A[kN][4];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if constexpr (kBf16) {
        A[i][0] = q[i].x;
        A[i][1] = q[i].y;
        A[i][2] = q[i].z;
        A[i][3] = q[i].w;
      } else {
        const uint32_t u0 = kt ? q[i].z : q[i].x, u1 = kt ? q[i].w : q[i].y;
        A[i][0] = widen_bytes(u0, 0, 1);
        A[i][1] = widen_bytes(u0, 2, 3);
        A[i][2] = widen_bytes(u1, 0, 1);
        A[i][3] = widen_bytes(u1, 2, 3);
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) mma_bf16_16816(acc[m0 + i], A[i], bf[kt][0], bf[kt][1]);
  }
}

// All T steps.  CTA (rank, tile) of a grid cs x H/bh in clusters of cs:
// tile blockIdx.y owns units u0 .. u0 + bh of every gate (G * bh <= 128
// outputs, mt m16 tiles); the rank holds k-steps ks0 .. ks0 + nk of W_h's
// rows (of ceil(H / kstep), split evenly over the cluster) in shared memory.
template <int G, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2) rnn_persistent_kernel(PArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = pkstep<kBf16>();
  const int cs = a.cs, mt = a.mt, H = a.H, bh = a.bh;
  const int rank = cs > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int u0 = blockIdx.y * bh;
  const int nks = (H + KS - 1) / KS;
  const int ks0 = rank * nks / cs, nk = (rank + 1) * nks / cs - ks0;
  const int row0 = ks0 * KS, nrows = nk * KS;
  const int bch = min(a.B, kPBatch), S = a.hs_words, U = G * bh, UP = 16 * mt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);
  uint32_t* hs = reinterpret_cast<uint32_t*>(smem + persist_hs_offset(mt, a.ksr));
  float* red = reinterpret_cast<float*>(smem + persist_red_offset(mt, a.ksr, bch, S));

  // 1. The slice, once, in the order a step reads it: block (ks, m) holds
  // lane l's A fragments of unit tile m, k-step ks as its 16 bytes, so a
  // warp reads a block with 16-byte loads and no bank conflicts.  int8: two
  // k16 tiles, each 4 words of code pairs (the fragment registers a0..a3:
  // unit g or g + 8, rows 2 t (+ 8) and + 1), biased by XOR 0x80 for
  // widen_bytes; bf16: one k16 tile, a0..a3.
  // A thread keeps one column of words (its units) and walks pairs of
  // rows, consecutive threads on consecutive units (reads that coalesce),
  // kPCopy words in flight.
  {
    constexpr int UPW = kBf16 ? 1 : 2;        // units a word covers
    constexpr int PPK = KS / 2;               // row pairs a k-step
    const int per_pair = UP / UPW, groups = kThreads / per_pair;
    const int j = tid % per_pair, grp = tid / per_pair;
    // the word's units o (and o + 8), as offsets in a row of W_h (-1: none)
    int m, g, col0, col8 = -1;
    auto col = [&](int o) {
      if (o >= U) return -1;
      const int gate = o / bh;
      return gate * H + u0 + o - gate * bh;
    };
    if constexpr (kBf16) {
      m = j >> 4;
      g = j & 15;
      col0 = col(16 * m + g);
    } else {
      m = j >> 3;
      g = j & 7;
      col0 = col(16 * m + g);
      col8 = col(16 * m + g + 8);
    }
    using W = typename std::conditional<kBf16, uint16_t, uint8_t>::type;
    const W* wg = static_cast<const W*>(a.wh);
    const size_t rstride = size_t(G) * H;
    auto ld = [&](int r, int c) -> uint32_t {
      return r < H && c >= 0 ? uint32_t(__ldg(wg + size_t(r) * rstride + c)) : 0u;
    };
    const int pairs = nk * PPK;
    if (grp < groups) {
      for (int rp0 = grp; rp0 < pairs; rp0 += kPCopy * groups) {
        uint32_t v[kPCopy];
#pragma unroll
        for (int k = 0; k < kPCopy; ++k) {
          const int r = row0 + 2 * (rp0 + k * groups);
          if constexpr (kBf16)
            v[k] = ld(r, col0) | ld(r + 1, col0) << 16;
          else
            v[k] = ld(r, col0) | ld(r + 1, col0) << 8 | ld(r, col8) << 16 | ld(r + 1, col8) << 24;
        }
#pragma unroll
        for (int k = 0; k < kPCopy; ++k) {
          const int rp = rp0 + k * groups;
          if (rp < pairs) {
            const int ks = rp / PPK, pi = rp % PPK;
            int q, l;
            if constexpr (kBf16) {  // pair pi = t + 4 (q >> 1); unit g = (q & 1) 8 + lane / 4
              q = 2 * (pi >> 2) + (g >> 3);
              l = 4 * (g & 7) + (pi & 3);
            } else {  // pair pi = t + 4 hk + 8 kt, word q = 2 kt + hk
              q = 2 * (pi >> 3) + ((pi >> 2) & 1);
              l = 4 * g + (pi & 3);
            }
            ws[((ks * mt + m) * 32 + l) * 4 + q] = kBf16 ? v[k] : v[k] ^ 0x80808080u;
          }
        }
      }
    }
  }
  // staged rows of batch rows past the batch stay zero
  for (int i = tid; i < bch * S; i += kThreads) hs[i] = 0u;
  __syncthreads();

  // The (batch row, unit) pairs p = b * bh + unit of a pass this rank owns:
  // p = rank + cs * (tid + kThreads * k).  Their gate operands that do not
  // depend on step t - 1 (zx_t, s_h, b_h; h_{t-1} or c, which only the owner
  // writes) are read before the wait.
  float g_zx[G], g_sh[G], g_bh[G], g_old = 0.f;
  auto gate_in = [&](int t, int b0, int p) {
    const int b = p / bh, u = u0 + p - b * bh;
    const float* zxr = a.zx + (size_t(t) * a.B + b0 + b) * G * H + u;
    const size_t row = size_t(b0 + b) * H + u;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      g_zx[gg] = __ldg(zxr + gg * H);
      g_sh[gg] = __ldg(a.sh + gg * H + u);
      g_bh[gg] = G == 3 ? __ldg(a.b_h + gg * H + u) : 0.f;
    }
    g_old = G == 4 ? a.c[row] : a.h[row];
  };
  const int p0 = rank + cs * tid;

  for (int t = 0; t < a.T; ++t) {
    const __nv_bfloat16* hprev = a.yb + size_t(t) * a.B * H;
    __nv_bfloat16* hnext = a.yb + size_t(t + 1) * a.B * H;
    for (int b0 = 0; b0 < a.B; b0 += kPBatch) {
      const int nb = min(kPBatch, a.B - b0);
      if (p0 < nb * bh) gate_in(t, b0, p0);

      // Stage this rank's rows of h_{t-1} (bf16, 16-byte loads, four a thread
      // in flight), zero past H.  h_{t-1} is y's slot t: its owners' stores
      // are the hand-off.  Slot t > 0 holds kPEmpty until written, each
      // element by one 2-byte store, so a thread reloads its pieces from L2
      // until none is empty; a slot is written once, so no CTA ever
      // overwrites what another still reads.
      const int pieces = nrows / 8;
      bool give_up = false;
      long long t_wait = -1;
      for (int i0 = tid; i0 < nb * pieces && !give_up; i0 += 4 * kThreads) {
        uint4 v[4];
        for (int spin = 0;; ++spin) {
          bool empty = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = i0 + k * kThreads;
            if (i < nb * pieces) {
              const int b = i / pieces, r = row0 + 8 * (i - b * pieces);
              v[k] = load_h8(hprev + size_t(b0 + b) * H + r, r, H, t > 0);
              empty |= t > 0 && has_empty(v[k]);
            }
          }
          if (!empty) break;
          if ((spin & 63) == 63 && pgive_up(a.abort, t_wait)) {
            give_up = true;
            break;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + k * kThreads;
          if (i < nb * pieces) {
            const int b = i / pieces;
            *reinterpret_cast<uint4*>(hs + b * S + 4 * (i - b * pieces)) = v[k];
          }
        }
      }
      if (__syncthreads_or(give_up)) return;

      // This warp's k-steps of the slice against h: acc[m] holds units 16 m
      // + g8 (+ 8) for batch rows 2 t4, 2 t4 + 1.  Each output's products go
      // through its k-steps in order, whatever the batch.
      float acc[kPMaxM][4];
#pragma unroll
      for (int m = 0; m < kPMaxM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
      const uint32_t* hrow = hs + g8 * S + t4;
      const bool hlive = g8 < nb;
      for (int ks = warp * nk / kPWarps; ks < (warp + 1) * nk / kPWarps; ++ks) {
        uint32_t bf[KS / 16][2];
#pragma unroll
        for (int kt = 0; kt < KS / 16; ++kt) {
          const int wk = 8 * (ks * (KS / 16) + kt);
          bf[kt][0] = hlive ? hrow[wk] : 0u;
          bf[kt][1] = hlive ? hrow[wk + 4] : 0u;
        }
        const uint4* blk = reinterpret_cast<const uint4*>(ws) + size_t(ks) * mt * 32 + lane;
        // four unit tiles at a time, then the last one to three
#pragma unroll
        for (int m0 = 0; m0 < kPMaxM; m0 += 4) {
          if (m0 + 4 <= mt) {
            ptiles<4, kBf16>(acc, blk, m0, mt, bf);
          } else if (m0 < mt) {
            if (m0 + 1 == mt)
              ptiles<1, kBf16>(acc, blk, m0, mt, bf);
            else
              ptiles<2, kBf16>(acc, blk, m0, mt, bf);
            if (m0 + 3 == mt) ptiles<1, kBf16>(acc, blk, m0 + 2, mt, bf);
          }
        }
      }
      // the warps' partials
#pragma unroll
      for (int m = 0; m < kPMaxM; ++m) {
        if (m < mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = 2 * t4 + (e & 1), o = 16 * m + g8 + 8 * (e >> 1);
            if (b < nb) red[(size_t(warp) * bch + b) * UP + o] = acc[m][e];
          }
        }
      }
      __syncthreads();
      const size_t wst = size_t(bch) * UP;
      if (cs > 1) {
        // the CTA's sums into warp 0's slot, visible to the cluster
        for (int i = tid; i < nb * U; i += kThreads) {
          const int b = i / U, o = i - b * U;
          red[size_t(b) * UP + o] = wtree(red + size_t(b) * UP + o, wst);
        }
        cluster_arrive_release();
        cluster_wait();
      }

      // the pairs this rank owns: the CTA's sum (a lone CTA sums its warps
      // here), or the cluster's sums in rank order, the scale, the x half,
      // the gates; h (f32) and c stay with their owner, y_t = bf16(h_t) is
      // h_t for step t + 1
      for (int p = p0, k = 0; p < nb * bh; p += cs * kThreads, ++k) {
        if (k > 0) gate_in(t, b0, p);
        const int b = p / bh, ul = p - b * bh;
        float zh[G];
        if (cs == 1) {
#pragma unroll
          for (int gg = 0; gg < G; ++gg) zh[gg] = wtree(red + size_t(b) * UP + gg * bh + ul, wst);
        } else {
#pragma unroll
          for (int gg = 0; gg < G; ++gg) zh[gg] = 0.f;
          for (int r = 0; r < cs; ++r) {
            const float* part = cg::this_cluster().map_shared_rank(red, r) + size_t(b) * UP + ul;
#pragma unroll
            for (int gg = 0; gg < G; ++gg) zh[gg] += part[gg * bh];
          }
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
        a.h[row] = h_new;
        hnext[row] = __float2bfloat16_rn(h_new);
      }
      // A lone CTA's partials are rewritten only after the next pass's
      // staging barrier.  A cluster's CTAs read each other's: none rewrites
      // its partials, or exits, until all have read them.
      if (cs > 1) {
        cluster_arrive_relaxed();
        cluster_wait();
      }
    }
  }
}

// ===========================================================================
// Host side
// ===========================================================================

template <int G, bool kBf16>
cudaError_t persist_forward(const PArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = rnn_persistent_kernel<G, kBf16>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // A lone CTA a tile is a cooperative launch, which the runtime refuses
  // unless the grid is resident; a cluster cannot be one, so the wrapper
  // has checked cudaOccupancyMaxActiveClusters (persist_clusters) first.
  cudaLaunchAttribute at[1];
  if (a.cs > 1) {
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = a.cs;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
  } else {
    at[0].id = cudaLaunchAttributeCooperative;
    at[0].val.cooperative = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cs, a.H / a.bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kern, a);
  return cudaGetLastError();
}

template <int G, bool kBf16>
cudaError_t persist_clusters(int cs, size_t smem, int* out) {
  auto kern = rnn_persistent_kernel<G, kBf16>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (cs == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    *out = per_sm * sms;
    return e;
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kern, &cfg);
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

// Persistent mode: all T steps in one launch on zx, W_h resident.  yb (T + 1,
// B, H) bf16 holds bf16(h0) in [0] and kPEmpty (0xFFFF) in every element of
// [1..T], which receive y; h (B, H) f32 holds h0 and receives h_T; abort (one
// word) must be zero.
extern "C" int fused_rnn_persistent(int n_gates, const void* zx, const void* wh, const void* sh,
                                    const void* b_h, void* yb, void* h, void* c, void* abort,
                                    int T, int B, int H, int bh, int cs, int w_bf16,
                                    int hs_words, long long smem, void* stream) {
  const int ks = w_bf16 ? pkstep<true>() : pkstep<false>();
  const int nks = (H + ks - 1) / ks;
  const int mt = (n_gates * bh + 15) / 16, ksr = (nks + cs - 1) / cs;
  if ((n_gates != 3 && n_gates != 4) || bh <= 0 || H % bh || mt > kPMaxM || cs < 1 ||
      cs > kMaxCluster || cs > nks || B < 1 || T < 1 || hs_words < ksr * ks / 2 ||
      hs_words % 4)
    return -1;
  if (persist_smem(mt, ksr, B < kPBatch ? B : kPBatch, hs_words) != size_t(smem)) return -1;
  const PArgs a{static_cast<const float*>(zx), wh, static_cast<const float*>(sh),
                static_cast<const float*>(b_h), static_cast<__nv_bfloat16*>(yb),
                static_cast<float*>(h), static_cast<float*>(c), static_cast<unsigned*>(abort),
                T, B, H, bh, cs, mt, ksr, hs_words};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (n_gates == 4)
    e = w_bf16 ? persist_forward<4, true>(a, smem, s) : persist_forward<4, false>(a, smem, s);
  else
    e = w_bf16 ? persist_forward<3, true>(a, smem, s) : persist_forward<3, false>(a, smem, s);
  return static_cast<int>(e);
}

// Clusters of cs persistent CTAs (smem bytes each) the card holds at once
// (cs = 1: CTAs).
extern "C" int fused_rnn_persist_clusters(int n_gates, int w_bf16, int cs, long long smem,
                                          int* out) {
  if ((n_gates != 3 && n_gates != 4) || cs < 1 || cs > kMaxCluster) return -1;
  cudaError_t e;
  if (n_gates == 4)
    e = w_bf16 ? persist_clusters<4, true>(cs, smem, out) : persist_clusters<4, false>(cs, smem, out);
  else
    e = w_bf16 ? persist_clusters<3, true>(cs, smem, out) : persist_clusters<3, false>(cs, smem, out);
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

// CTAs of the streaming step kernel that fit on one SM at this dynamic
// shared memory size and batch.
extern "C" int fused_rnn_max_blocks_per_sm(int n_gates, int w_bf16, int batch, long long smem,
                                           int* out) {
  if (n_gates != 3 && n_gates != 4) return -1;
  const cudaError_t e = n_gates == 4 ? (w_bf16 ? stream_blocks<4, true>(batch, smem, out)
                                               : stream_blocks<4, false>(batch, smem, out))
                                     : (w_bf16 ? stream_blocks<3, true>(batch, smem, out)
                                               : stream_blocks<3, false>(batch, smem, out));
  return static_cast<int>(e);
}
