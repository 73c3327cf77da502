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
// What bounds them on this card: at batch 1 a step is a matrix-vector
// product, so each step must read the whole weight, g*H*(D+H) bytes in int8
// (0.5 MB for lstm-256 .. 39 MB for gru-2560), against 2 FLOPs per byte.
// The card's 3.35 TB/s of HBM (or L2, where the weight fits its 50 MB) is
// the limit, not its arithmetic; the recurrence h_{t-1} -> h_t adds a
// grid-wide dependency between steps.
//
// The TPU grid (T, H/bh) runs in order on one core and carries h in VMEM.
// CTAs here run in parallel and in no order, so:
//   * one CTA owns bh units across all G gates; a thread slot covers 4
//     consecutive units of one gate (one 32-bit int8 load, or 64-bit for
//     bf16, per row) and the D+H contraction rows are split across the
//     CTA's threads, then reduced through shared memory;
//   * streaming mode launches one kernel per step: h_{t-1} is read from one
//     of two global buffers by t parity and h_t written to the other; c is
//     updated in place (each unit has one owner).  Weights come from
//     global memory (L2) every step;
//   * persistent mode is one cooperative launch for all T: each CTA copies
//     its weight slice into shared memory once, the GPU analogue of the
//     paper's PMU-resident weights, and a grid barrier separates the steps.
//     The host checks co-residency before launching.
// No tensor cores (wgmma) and no TMA yet: at batch 1 the product is a
// matrix-vector product, and the first aim is a kernel that is right.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per CTA (fused_rnn.py: THREADS)
constexpr int kVec = 4;        // units per thread slot (fused_rnn.py: VEC)
constexpr int kBch = 4;        // batch rows per pass (fused_rnn.py: BCH)

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
__global__ void __launch_bounds__(kThreads) rnn_step_kernel(Args a, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(G, a.D, a.H, a.bh, a.ks, a.bch, a.w_bf16, false);
  cell_step<G>(a, t, nullptr, smem, L);
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

template <int G>
cudaError_t forward(const Args& a, int persistent, size_t smem, cudaStream_t stream) {
  const dim3 grid(a.H / a.bh), block(kThreads);
  if (persistent) {
    auto kern = rnn_persistent_kernel<G>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    Args args = a;
    void* params[] = {&args};
    cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), grid, block, params, smem,
                                stream);
    return cudaGetLastError();
  }
  auto kern = rnn_step_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  for (int t = 0; t < a.T; ++t) {
    kern<<<grid, block, smem, stream>>>(a, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int G>
cudaError_t max_blocks(int persistent, size_t smem, int* out) {
  if (persistent) {
    auto kern = rnn_persistent_kernel<G>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, kThreads, smem);
  }
  auto kern = rnn_step_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, kThreads, smem);
}

}  // namespace

// Plain C interface, loaded with ctypes by repro_torch/kernels/fused_rnn/fused_rnn.py.
// Returns a cudaError_t (0 on success); -1 when the arguments are not ones
// the kernels take (the Python wrapper checks them first).
extern "C" int fused_rnn_forward(int n_gates, int persistent, const void* x, const void* wx,
                                 const void* wh, const void* sx, const void* sh, const void* b,
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
  if (layout(n_gates, D, H, bh, ks, a.bch, w_bf16, persistent).total != size_t(smem)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = n_gates == 4 ? forward<4>(a, persistent, smem, s)
                                     : forward<3>(a, persistent, smem, s);
  return static_cast<int>(e);
}

// CTAs of one kernel that fit on one SM at this dynamic shared memory size.
extern "C" int fused_rnn_max_blocks_per_sm(int n_gates, int persistent, long long smem,
                                           int* out) {
  if (n_gates != 3 && n_gates != 4) return -1;
  const cudaError_t e = n_gates == 4 ? max_blocks<4>(persistent, smem, out)
                                     : max_blocks<3>(persistent, smem, out);
  return static_cast<int>(e);
}
