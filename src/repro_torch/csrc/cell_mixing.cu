// cell_mixing: y[b] = W[b]^rounds @ x[b] for every cell b, in f32.
//
// Replaces the TPU kernel `_mixing_kernel` / `cell_mixing_pallas`
// (src/repro/kernels/cell_mixing/kernel.py), which fuses the rounds in
// VMEM so the cell state crosses device memory once per call.
//
// What bounds it on an H100: for the shapes this system gives it (m = C
// slots of 4 to a few hundred, d = 2 channels in the engine's matmul
// backend, d = features + 1 in the synchronous path) the arithmetic is
// small, rounds*2*m*m*d flops per cell against (m*m + 2*m*d)*4 bytes,
// so the bound is bytes: each W and x read once, y written once.
//
// Design: one block per (cell, d-tile).  W[b] (when it fits) and two
// (m, dt) tiles of the state live in shared memory; the rounds run
// inside the block, ping-ponging between the two tiles with one
// __syncthreads per round, so W and x are read from device memory once
// whatever `rounds` is.  Each thread computes output elements (r, c) as
// a sequential fmaf chain over k — f32 throughout, no tensor cores, no
// TF32.  A W too large for shared memory is read from device memory
// (through L1/L2) instead.  The sums run in another order than the
// plain matmul, so the two agree to f32 rounding, not bitwise.

#include <cuda_runtime.h>

__global__ void cell_mixing_kernel(const float* __restrict__ w,
                                   const float* __restrict__ x,
                                   float* __restrict__ y, int m, int d,
                                   int dt, int rounds, int w_in_smem) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const long long b = blockIdx.x;
  const int d0 = blockIdx.y * dt;
  const int dw = min(dt, d - d0);
  const float* wb = w + b * m * m;
  float* cur = smem + (w_in_smem ? m * m : 0);
  float* nxt = cur + m * dt;
  const float* W = wb;
  if (w_in_smem) {
    for (int e = tid; e < m * m; e += nth) smem[e] = wb[e];
    W = smem;
  }
  const float* xb = x + b * m * d + d0;
  for (int e = tid; e < m * dw; e += nth) {
    const int r = e / dw, c = e - r * dw;
    cur[r * dt + c] = xb[(long long)r * d + c];
  }
  __syncthreads();
  for (int round = 0; round < rounds; ++round) {
    for (int e = tid; e < m * dw; e += nth) {
      const int r = e / dw, c = e - r * dw;
      const float* wr = W + (long long)r * m;
      float acc = 0.0f;
      for (int k = 0; k < m; ++k) acc = fmaf(wr[k], cur[k * dt + c], acc);
      nxt[r * dt + c] = acc;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float* yb = y + b * m * d + d0;
  for (int e = tid; e < m * dw; e += nth) {
    const int r = e / dw, c = e - r * dw;
    yb[(long long)r * d + c] = cur[r * dt + c];
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cell_mixing_launch(const float* w, const float* x, float* y,
                                  int B, int m, int d, int dt, int rounds,
                                  int w_in_smem, int threads, void* stream) {
  if (B == 0 || m == 0 || d == 0) return 0;
  const size_t smem =
      ((w_in_smem ? (size_t)m * m : 0) + 2 * (size_t)m * dt) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cell_mixing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)B, (unsigned)((d + dt - 1) / dt));
  cell_mixing_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      w, x, y, m, d, dt, rounds, w_in_smem);
  return (int)cudaGetLastError();
}
