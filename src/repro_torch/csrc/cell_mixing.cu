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
// so the bound is bytes: each W and x read once, y written once.  At the
// matmul backend's finest level of n=20000 (B=3584, m=15, d=2) that is
// 4.1 MB, 1.2 us at 3.35 TB/s, which is about what one launch costs: at
// this size the launch itself, and the host's path to it, bound the op.
//
// Design, m <= 32 (the finest levels' cells): one warp per cell, eight
// cells a block, so 3584 cells make 448 blocks of 256 threads and not
// 3584 blocks of one warp.  The warp copies its cell's W row by row
// (coalesced; 16-byte loads where m is 8, 16 or 32 and W is 16-byte
// aligned, since every row then starts 16-byte aligned) into its own
// shared-memory tile with an odd row stride, so lane r reading row r
// hits 32 distinct banks, and then into registers: lane r holds W[r, :] and x[r, c].  A round is
// y_r = sum_k W[r, k] x_k with x_k taken from lane k by __shfl_sync: no
// __syncthreads anywhere, no integer division, W and x read from device
// memory once whatever `rounds` is.
//
// Design, m > 32: one block of up to 256 threads per (cell, d-tile).  W
// (when it fits) and two (m, dt) tiles of the state live in shared
// memory; the threads form an (nx, ny) grid, nx columns by ny rows, and
// walk rows and columns with strided loops (no division); the rounds
// ping-pong between the two tiles with one __syncthreads per round.  W
// is stored with an odd row stride, so the ny rows a warp reads fall in
// distinct banks.  A W too large for shared memory is read from device
// memory instead.
//
// Both paths form each output as a sequential fmaf chain over k, f32
// throughout, no tensor cores, no TF32.  The sums run in another order
// than the plain matmul, so the two agree to f32 rounding, not bitwise.
//
// Binding: besides the plain C entry point the library is a CPython
// extension module (Python.h only, no PyTorch headers), whose one
// METH_FASTCALL function takes the ten integers of a launch.  At the
// matmul backend's shapes the host's path to the launch is most of the
// op's time, and ctypes' per-argument conversions were the largest part
// of the wrapper's own share.

#include <Python.h>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCellsPerBlock = 8;  // warps, and cells, of a warp-path block
constexpr int kBlockThreads = 256;  // most threads of a block-path block

template <int MB>  // MB >= m: 8, 16 or 32
__global__ void __launch_bounds__(32 * kCellsPerBlock)
    mixing_warp_kernel(const float* __restrict__ w,
                       const float* __restrict__ x, float* __restrict__ y,
                       int B, int m, int d, int rounds, int vec) {
  constexpr int P = MB + 1;  // odd row stride: conflict-free row reads
  __shared__ float tiles[kCellsPerBlock][MB * P];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kCellsPerBlock + warp;
  if (b >= B) return;  // whole warps only: no block barrier follows
  float* tile = tiles[warp];
  const float* wb = w + b * m * m;
  if (vec) {  // m == MB and W 16-byte aligned
    // rows of MB floats are MB / 4 16-byte pieces; 32 / (MB / 4) rows a
    // pass, lane -> (row offset, piece) by shifts
    constexpr int Q = MB / 4, RP = 32 / Q;
    const int pr = lane / Q, pc = lane % Q;  // constants: shifts and masks
    for (int r0 = 0; r0 < MB; r0 += RP) {
      if (RP > MB && pr >= MB) break;  // MB = 8: 16 rows a pass, 8 exist
      const float4 v =
          reinterpret_cast<const float4*>(wb + (r0 + pr) * MB)[pc];
      float* dst = tile + (r0 + pr) * P + 4 * pc;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else if (lane < m) {
    for (int r = 0; r < m; ++r) tile[r * P + lane] = wb[r * m + lane];
  }
  __syncwarp();
  float wr[MB];
#pragma unroll
  for (int k = 0; k < MB; ++k)
    wr[k] = (lane < m && k < m) ? tile[lane * P + k] : 0.0f;
  const float* xb = x + b * m * d + (long long)lane * d;
  float* yb = y + b * m * d + (long long)lane * d;
  for (int c = 0; c < d; ++c) {
    float xv = lane < m ? xb[c] : 0.0f;
    for (int round = 0; round < rounds; ++round) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MB; ++k)
        acc = fmaf(wr[k], __shfl_sync(0xffffffffu, xv, k), acc);
      xv = acc;
    }
    if (lane < m) yb[c] = xv;
  }
}

__global__ void mixing_block_kernel(const float* __restrict__ w,
                                    const float* __restrict__ x,
                                    float* __restrict__ y, int m, int d,
                                    int dt, int rounds, int w_in_smem) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x, nx = blockDim.x;  // columns of the tile
  const int ty = threadIdx.y, ny = blockDim.y;  // rows
  const int tid = ty * nx + tx, nth = nx * ny;
  const long long b = blockIdx.x;
  const int d0 = blockIdx.y * dt;
  const int dw = min(dt, d - d0);
  const int P = m | 1;  // odd row stride of W in shared memory
  const float* wb = w + b * m * m;
  float* cur = smem + (w_in_smem ? (size_t)m * P : 0);
  float* nxt = cur + (size_t)m * dt;
  const float* W = wb;
  int ws = m;  // W's row stride where it is read
  if (w_in_smem) {
    for (int r = 0; r < m; ++r)
      for (int c = tid; c < m; c += nth) smem[r * P + c] = wb[r * m + c];
    W = smem;
    ws = P;
  }
  const float* xb = x + b * m * d + d0;
  for (int r = ty; r < m; r += ny)
    for (int c = tx; c < dw; c += nx) cur[r * dt + c] = xb[(long long)r * d + c];
  __syncthreads();
  for (int round = 0; round < rounds; ++round) {
    for (int r = ty; r < m; r += ny) {
      const float* wr = W + (long long)r * ws;
      for (int c = tx; c < dw; c += nx) {
        float acc = 0.0f;
        for (int k = 0; k < m; ++k) acc = fmaf(wr[k], cur[k * dt + c], acc);
        nxt[r * dt + c] = acc;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float* yb = y + b * m * d + d0;
  for (int r = ty; r < m; r += ny)
    for (int c = tx; c < dw; c += nx) yb[(long long)r * d + c] = cur[r * dt + c];
}

}  // namespace

// w: (B, m, m), x and y: (B, m, d), f32, contiguous.
// m <= 32 takes the warp path (dt and w_in_smem are not read); m > 32
// the block path with d-tiles of dt columns and W in shared memory if
// w_in_smem.  Launch on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int cell_mixing_launch(const float* w, const float* x, float* y,
                                  int B, int m, int d, int rounds, int dt,
                                  int w_in_smem, void* stream) {
  if (B == 0 || m == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 32) {
    const unsigned grid = (unsigned)((B + kCellsPerBlock - 1) / kCellsPerBlock);
    const int threads = 32 * kCellsPerBlock;
    const int mb = m <= 8 ? 8 : m <= 16 ? 16 : 32;
    const int vec = m == mb && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (mb == 8)
      mixing_warp_kernel<8><<<grid, threads, 0, st>>>(w, x, y, B, m, d,
                                                      rounds, vec);
    else if (mb == 16)
      mixing_warp_kernel<16><<<grid, threads, 0, st>>>(w, x, y, B, m, d,
                                                       rounds, vec);
    else
      mixing_warp_kernel<32><<<grid, threads, 0, st>>>(w, x, y, B, m, d,
                                                       rounds, vec);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      ((w_in_smem ? (size_t)m * (m | 1) : 0) + 2 * (size_t)m * dt) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mixing_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // nx columns of a tile (a power of two, up to a warp) by ny rows of
  // threads: whole warps, and no more rows than whole warps of m need
  int nx = 1;
  while (nx < dt && nx < 32) nx <<= 1;
  const int rows_a_warp = 32 / nx;
  const int ny = min(kBlockThreads / nx,
                     (m + rows_a_warp - 1) / rows_a_warp * rows_a_warp);
  dim3 grid((unsigned)B, (unsigned)((d + dt - 1) / dt));
  mixing_block_kernel<<<grid, dim3(nx, ny), smem, st>>>(w, x, y, m, d, dt,
                                                        rounds, w_in_smem);
  return (int)cudaGetLastError();
}

namespace {

// launch(w, x, y, B, m, d, rounds, dt, w_in_smem, stream) -> int: the
// three device pointers and the stream as Python ints, the rest as ints
// that fit a C int; returns cell_mixing_launch's error code.
PyObject* py_launch(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 10) {
    PyErr_SetString(PyExc_TypeError, "launch takes 10 arguments");
    return nullptr;
  }
  void* ptr[4];  // w, x, y and the stream
  for (int i = 0; i < 4; ++i) {
    ptr[i] = PyLong_AsVoidPtr(args[i < 3 ? i : 9]);
    if (ptr[i] == nullptr && PyErr_Occurred()) return nullptr;
  }
  int v[6];
  for (int i = 0; i < 6; ++i) {
    const long t = PyLong_AsLong(args[3 + i]);
    if (t == -1 && PyErr_Occurred()) return nullptr;
    if (t > INT_MAX || t < INT_MIN) {
      PyErr_SetString(PyExc_OverflowError, "launch argument beyond a C int");
      return nullptr;
    }
    v[i] = (int)t;
  }
  return PyLong_FromLong(cell_mixing_launch(
      static_cast<const float*>(ptr[0]), static_cast<const float*>(ptr[1]),
      static_cast<float*>(ptr[2]), v[0], v[1], v[2], v[3], v[4], v[5],
      ptr[3]));
}

PyMethodDef kMethods[] = {
    {"launch", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(
                   py_launch)),
     METH_FASTCALL, "Launch cell_mixing on a stream; returns its error code."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "cell_mixing", nullptr, -1,
                       kMethods, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_cell_mixing(void) { return PyModule_Create(&kModule); }
