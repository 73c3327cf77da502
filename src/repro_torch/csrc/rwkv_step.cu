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
// What bounds it on this card: each step does 4*K*V operations per head on
// a state of 4*K*V bytes, under one operation per byte, so device memory
// bounds it: the state read and written once plus r, k, v, w and y, over
// 3.35 TB/s.  At the decode shape of rwkv6-1.6b (T=1, B=1, H=32, K=V=64)
// that is ~1.05 MB, ~0.3 us, well under the few microseconds of one
// kernel launch: one launch per layer and decode step sets the pace.
// Fusing the layers' steps into fewer launches (a CUDA graph of the decode
// tick) is later work.
//
// The TPU grid (T, H/bh) runs in order with t outermost and carries S in a
// VMEM scratch between grid steps.  CTAs run in no order, so here:
//   * a CTA owns bh heads of one batch row and loops over t inside;
//     it works on hpc heads at a time (hpc * V <= 256 threads, hpc | bh);
//   * thread (v, head) holds column v of its head's K x V state in
//     registers for all T steps: no reduction across threads is needed;
//   * r, k, exp(w) and u for the step are staged in shared memory, so each
//     is read from device memory once per (b, head, t);
//   * the state is read before any write by its one owner thread, so the
//     state output may alias the input (in place).
// Numerics: f32 sums, expf (no fast math: the decay spans
// exp(-e^3) .. exp(-e^-8)), y rounded with __float2bfloat16_rn.  Each
// thread's arithmetic is the same for any bh, so every head tile gives the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per CTA at most (rwkv_step.py: MAX_THREADS)

struct Args {
  const __nv_bfloat16* r;  // (T, B, H, K)
  const __nv_bfloat16* k;  // (T, B, H, K)
  const __nv_bfloat16* v;  // (T, B, H, V)
  const float* w;          // (T, B, H, K): log-decay, <= 0
  const float* u;          // (H, K)
  const float* s0;         // (B, H, K, V)
  float* sT;               // (B, H, K, V); may alias s0
  __nv_bfloat16* y;        // (T, B, H, V)
  int T, B, H, bh;
};

template <int K, int V>
__global__ void __launch_bounds__(kMaxThreads) rwkv6_step_kernel(Args a) {
  constexpr int kHpc = kMaxThreads / V;  // heads in flight per CTA, at most
  __shared__ float s_r[kHpc][K], s_k[kHpc][K], s_ew[kHpc][K], s_u[kHpc][K];
  const int vi = threadIdx.x;  // state column owned by this thread
  const int hy = threadIdx.y;  // head slot within the CTA
  const int hpc = blockDim.y;
  const int b = blockIdx.y;
  const int h_begin = blockIdx.x * a.bh;
  for (int h0 = h_begin; h0 < h_begin + a.bh; h0 += hpc) {
    const int h = h0 + hy;
    float s[K];
    const size_t sbase = (size_t(b) * a.H + h) * K * V + vi;
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = a.s0[sbase + size_t(i) * V];
    for (int i = vi; i < K; i += V) s_u[hy][i] = a.u[size_t(h) * K + i];
    for (int t = 0; t < a.T; ++t) {
      const size_t row = (size_t(t) * a.B + b) * a.H + h;  // (t, b, h)
      for (int i = vi; i < K; i += V) {
        s_r[hy][i] = __bfloat162float(a.r[row * K + i]);
        s_k[hy][i] = __bfloat162float(a.k[row * K + i]);
        s_ew[hy][i] = expf(a.w[row * K + i]);
      }
      __syncthreads();
      const float vv = __bfloat162float(a.v[row * V + vi]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = s_k[hy][i] * vv;
        acc += s_r[hy][i] * (s[i] + s_u[hy][i] * kv);  // reads the old state
        s[i] = s_ew[hy][i] * s[i] + kv;
      }
      a.y[row * V + vi] = __float2bfloat16_rn(acc);
      __syncthreads();  // the next step restages r, k, exp(w)
    }
#pragma unroll
    for (int i = 0; i < K; ++i) a.sT[sbase + size_t(i) * V] = s[i];
  }
}

template <int K, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  int hpc = a.bh < kMaxThreads / V ? a.bh : kMaxThreads / V;
  while (a.bh % hpc) --hpc;
  const dim3 grid(a.H / a.bh, a.B), block(V, hpc);
  rwkv6_step_kernel<K, V><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_v(const Args& a, int V, cudaStream_t stream) {
  if (V == 16) return launch<K, 16>(a, stream);
  return launch<K, 64>(a, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes by repro_torch/kernels/rwkv_step/rwkv_step.py.
// Returns a cudaError_t (0 on success); -1 when the arguments are not ones
// the kernel takes (the Python wrapper checks them first).
extern "C" int rwkv6_step_forward(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* s0, void* sT, void* y, int T,
                                  int B, int H, int K, int V, int bh, void* stream) {
  if ((K != 16 && K != 64) || (V != 16 && V != 64) || T < 1 || B < 1 || H < 1 || bh < 1 ||
      H % bh)
    return -1;
  Args a{static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
         static_cast<const float*>(u), static_cast<const float*>(s0), static_cast<float*>(sT),
         static_cast<__nv_bfloat16*>(y), T, B, H, bh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = K == 16 ? launch_v<16>(a, V, s) : launch_v<64>(a, V, s);
  return static_cast<int>(e);
}
