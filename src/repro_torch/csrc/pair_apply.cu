// pair_apply: walk a presampled (T, B) gossip schedule over (B, C, V) cell state.
//
// Replaces the TPU kernel `_pair_apply_kernel` / `pair_apply_pallas`
// (src/repro/kernels/pair_apply/kernel.py).  At every tick t, cell b
// averages rows i[t, b] and j[t, b] as avg = 0.5f * (x_i + x_j), then
// writes row j if upd_j[t, b] and after it row i if upd_i[t, b].  Cells
// never interact.
//
// What bounds it on an H100: bytes.  The work is 2 f32 adds/muls per
// tick and value channel; the state is read once and written once
// (2*B*C*V*4 bytes) and the schedule read once (T*B*(4+4+1+1) bytes).
// At the finest level of n=10^5 (B=43250, C=9, V=2, T=50) that is about
// 28 MB, some 8 us at the H100 SXM data-sheet rate of 3.35 TB/s.  The
// ticks of one cell are a serial chain, so the kernel is in practice
// bound by the latency of that chain times T.
//
// Design: one thread per cell, the cell's C*V floats in shared memory
// for the whole walk.  Shared memory is laid out element-major,
// state[e * threads + tid], so the 32 threads of a warp always hit 32
// distinct banks whichever rows they touch.  The schedule's (T, B)
// layout puts the threads of a warp on neighbouring addresses at each
// tick (coalesced), and the next tick's four entries are loaded before
// the current tick is applied, so their latency overlaps the row
// updates.  A cell too wide for shared memory walks its rows in device
// memory instead (use_smem = 0; the output doubles as the state).
//
// Bitwise equality with the plain version: __fadd_rn / __fmul_rn pin
// the two roundings of 0.5f * (x_i + x_j) (no contraction, no
// reassociation), and the writes keep the plain version's order (row j,
// then row i), which decides the result when i == j.  The update bits
// come in as uint8, never bool.  A tick whose row index lies outside
// [0, C) is skipped.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pair_apply_kernel(const float* __restrict__ x,
                                  float* __restrict__ out,
                                  const int* __restrict__ si,
                                  const int* __restrict__ sj,
                                  const uint8_t* __restrict__ sui,
                                  const uint8_t* __restrict__ suj,
                                  int T, int B, int C, int V, int use_smem) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const long long b = (long long)blockIdx.x * blockDim.x + tid;
  if (b >= B) return;
  const int CV = C * V;
  const float* xb = x + b * CV;
  float* st;
  long long stride;
  if (use_smem) {
    st = smem + tid;
    stride = blockDim.x;
  } else {
    st = out + b * CV;
    stride = 1;
  }
  for (int e = 0; e < CV; ++e) st[e * stride] = xb[e];

  int it = 0, jt = 0, ui = 0, uj = 0;
  if (T > 0) {
    it = si[b];
    jt = sj[b];
    ui = sui[b];
    uj = suj[b];
  }
  for (int t = 0; t < T; ++t) {
    int nit = 0, njt = 0, nui = 0, nuj = 0;
    if (t + 1 < T) {
      const long long o = (long long)(t + 1) * B + b;
      nit = si[o];
      njt = sj[o];
      nui = sui[o];
      nuj = suj[o];
    }
    if ((ui | uj) && (unsigned)it < (unsigned)C && (unsigned)jt < (unsigned)C) {
      float* ri = st + (long long)it * V * stride;
      float* rj = st + (long long)jt * V * stride;
      for (int v = 0; v < V; ++v) {
        const float xi = ri[v * stride];
        const float xj = rj[v * stride];
        const float avg = __fmul_rn(0.5f, __fadd_rn(xi, xj));
        if (uj) rj[v * stride] = avg;  // partner row first,
        if (ui) ri[v * stride] = avg;  // then the initiator
      }
    }
    it = nit;
    jt = njt;
    ui = nui;
    uj = nuj;
  }
  if (use_smem) {
    float* ob = out + b * CV;
    for (int e = 0; e < CV; ++e) ob[e] = st[e * stride];
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pair_apply_launch(const float* x, float* out, const int* i,
                                 const int* j, const uint8_t* upd_i,
                                 const uint8_t* upd_j, int T, int B, int C,
                                 int V, int threads, int use_smem,
                                 void* stream) {
  if (B == 0) return 0;
  const size_t smem =
      use_smem ? (size_t)threads * (size_t)C * (size_t)V * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + threads - 1) / threads;
  pair_apply_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      x, out, i, j, upd_i, upd_j, T, B, C, V, use_smem);
  return (int)cudaGetLastError();
}
