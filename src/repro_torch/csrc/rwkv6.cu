// rwkv6: the RWKV-6 (Finch) wkv recurrence, forward, per batch·head.
//
// Replaces the TPU kernel `_wkv_kernel` / `rwkv6_pallas`
// (src/repro/kernels/rwkv6/kernel.py), which keeps the (N, N) state in
// VMEM and streams time in blocks.  For each b·h, from S = 0:
//
//     y_t = (S + (u * k_t) v_t^T)^T r_t        S <- diag(w_t) S + k_t v_t^T
//
// with S (keys x values) and all arithmetic in f32, y_t written in the
// inputs' type (bf16 rounded to nearest even).
//
// What bounds it on an H100: the function needs 5 N^2 + 5 N f32
// operations per step per b·h (S^T r, diag(w) S + k v^T, and the bonus
// as v (u·k·r), a dot product) against (3 + 1) N loads and N stores, so
// at N = 64 the operations bound it (the rwkv6-3b prefill at BH=160,
// T=4096: 13.6 GFLOP, 0.20 ms at 67 TFLOP/s, against 0.15 ms for its
// bytes).  This kernel forms (u * k_t) v_t^T per column, 7 N^2 a step.
// Time is a serial chain, so only b·h and the state's columns run in
// parallel.
//
// Design: column m of S evolves on its own given r_t, k_t, w_t and
// v_t[m], so one block serves one b·h with N threads and thread m keeps
// S[:, m] in N registers.  A chunk of TC = 2048 / N steps of r, k, w, v
// is staged in shared memory as f32 (coalesced loads, two barriers a
// chunk); each thread then walks the chunk with no barrier, reading r_t,
// k_t, w_t as shared-memory broadcasts, and writes y_t[m] (a warp writes
// one contiguous row).  The sum over keys runs in four partial sums, in
// another order than the plain version, so the two agree to f32
// rounding, not bitwise.  No tensor cores: the recurrence is not a
// matrix product step by step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunkElems = 2048;  // elements of one staged time chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int N, typename TI, typename TW>
__global__ void __launch_bounds__(N)
    rwkv6_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                 const TI* __restrict__ v, const TW* __restrict__ w,
                 const TI* __restrict__ u, TI* __restrict__ y, int T) {
  constexpr int TC = kChunkElems / N;
  __shared__ __align__(16) float sr[TC * N];
  __shared__ __align__(16) float sk[TC * N];
  __shared__ __align__(16) float sw[TC * N];
  __shared__ __align__(16) float sv[TC * N];
  __shared__ __align__(16) float su[N];
  const int m = threadIdx.x;  // the value column of S this thread owns
  const size_t base = (size_t)blockIdx.x * T * N;
  su[m] = to_float(u[(size_t)blockIdx.x * N + m]);
  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int steps = min(TC, T - t0);
    const size_t off = base + (size_t)t0 * N;
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = m; e < steps * N; e += N) {
      sr[e] = to_float(r[off + e]);
      sk[e] = to_float(k[off + e]);
      sw[e] = to_float(w[off + e]);
      sv[e] = to_float(v[off + e]);
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float* rt = sr + t * N;
      const float* kt = sk + t * N;
      const float* wt = sw + t * N;
      const float vm = sv[t * N + m];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float kv = kt[n] * vm;
        acc[n & 3] = fmaf(fmaf(su[n], kv, s[n]), rt[n], acc[n & 3]);
        s[n] = fmaf(wt[n], s[n], kv);
      }
      put(y + off + (size_t)t * N + m, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
}

template <int N, typename TI, typename TW>
int launch_typed(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* y, int BH, int T, cudaStream_t stream) {
  rwkv6_kernel<N, TI, TW><<<BH, N, 0, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TW*>(w),
      static_cast<const TI*>(u), static_cast<TI*>(y), T);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, int BH, int T, int in_bf16, int w_bf16,
             cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (in_bf16 && w_bf16)
    return launch_typed<N, bf16, bf16>(r, k, v, w, u, y, BH, T, stream);
  if (in_bf16)
    return launch_typed<N, bf16, float>(r, k, v, w, u, y, BH, T, stream);
  if (w_bf16)
    return launch_typed<N, float, bf16>(r, k, v, w, u, y, BH, T, stream);
  return launch_typed<N, float, float>(r, k, v, w, u, y, BH, T, stream);
}

}  // namespace

// r, k, v, w: (BH, T, N) contiguous; u: (BH, N); y: (BH, T, N) in the
// type of r.  in_bf16: r, k, v, u, y are bf16 (else f32); w_bf16: w is
// bf16 (else f32).  Launch on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a head size not compiled here.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* y, int BH,
                            int T, int N, int in_bf16, int w_bf16,
                            void* stream) {
  if (BH == 0 || T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16:
      return launch_n<16>(r, k, v, w, u, y, BH, T, in_bf16, w_bf16, st);
    case 32:
      return launch_n<32>(r, k, v, w, u, y, BH, T, in_bf16, w_bf16, st);
    case 64:
      return launch_n<64>(r, k, v, w, u, y, BH, T, in_bf16, w_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
