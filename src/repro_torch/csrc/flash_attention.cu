// flash_attention: blocked online-softmax attention, forward, on f32
// q, k, v.  bf16 inputs go to csrc/flash_attention_sm90.cu (wgmma, TMA);
// this kernel serves f32 only, because tensor-core products in TF32 or
// bf16 would not hold the reference tests' f32 tolerance of 2e-5.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py), which streams KV blocks
// past a query block held in VMEM with the running (m, l, acc) in
// scratch.  For query row i of head h (KV head h / (Hq / Hkv)):
//
//     s_j = (scale * q_i) . k_j             in f32
//     s_j = softcap * tanh(s_j / softcap)   (if softcap > 0)
//     s_j = -1e30 unless j < Sk, (j <= i if causal), (j > i - window)
//     o_i = sum_j softmax(s)_j v_j          online over key tiles, f32
//
// and o_i / max(l, 1e-30) is written in f32.  The masks are
// by index (i and j count from 0), as in the reference kernel; a masked
// score is the -1e30 sentinel, not -inf, so a row that meets a wholly
// masked tile first carries exp(0) = 1 terms until a real score arrives
// and rescales them away by exp(-1e30 - m) = 0, as the reference does.
// Key tiles wholly above the causal frontier or wholly before the window
// are skipped.
//
// What bounds it on an H100: the function needs 4 D operations per
// (query, key) pair it keeps (two products of length D), 412 GFLOP at the
// llama3.2-3b prefill shape (B=4, Hq=24, S=4096, D=128, causal) against
// 537 MB of f32 q, k, v and o: operations bound it by far.  In f32 they
// run as FMAs on the CUDA cores, at most 67 TFLOP/s.
//
// Design: one block of 256 threads per (query tile of 64 rows, query
// head, batch row); causal blocks with more key tiles are scheduled
// first.  The query tile (pre-scaled) stays in shared memory; each
// 64-key tile of K, then of V, is staged into one shared buffer (84 KB
// in all at D = 128, so two blocks share an SM).  Thread (ty, tx) of a
// 16 x 16 grid owns query rows 4 ty .. 4 ty + 3: it computes the scores
// of those rows against keys tx + 16 c (c < 4) from float4 reads of
// shared memory, 64 FMAs per eight reads; the 16 threads that own a row
// sit in one half-warp, so the row max and sum of the online softmax are
// shuffle reductions, and every thread keeps its rows' m and l in
// registers.  P goes to shared memory transposed, and the same thread
// accumulates O for its 4 rows at columns 4 tx + 64 c' in registers (32
// floats at D = 128).  Tails of Sq and Sk are bounds-checked: rows past
// Sq are computed on zeros and not stored, keys past Sk are masked and
// read as zeros.  expf and tanhf are the accurate ones (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows of a block
constexpr int BK = 64;        // keys of a staged tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int LDP = BQ + 4;   // row stride of the transposed P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory times
// `mul`, row stride D + 4; rows at or past `rows` are zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int rows, float mul) {
  constexpr int V = D / 4;  // 4-element vectors a row
  for (int e = threadIdx.x; e < 64 * V; e += THREADS) {
    const int r = e / V, c = (e % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      x = load4(src + (size_t)(row0 + r) * D + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    store4(dst + r * (D + 4) + c, x);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 128 ? 2 : 1)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Hq,
                 int Hkv, int Sq, int Sk, int causal, int window,
                 float scale, float softcap) {
  constexpr int LD = D + 4;   // row stride of the Q and K/V tiles
  constexpr int NC = D / 64;  // float4 columns of O a thread owns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // (BQ, LD)
  float* kv = qs + BQ * LD;      // (BK, LD): K, then V, of one tile
  float* ps = kv + BK * LD;      // (BK, LDP): P transposed

  const int nq = gridDim.x;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const float* qg = q + ((size_t)b * Hq + h) * Sq * D;
  const float* kg = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vg = v + ((size_t)b * Hkv + hk) * Sk * D;
  float* og = o + ((size_t)b * Hq + h) * Sq * D;

  // key tiles this query tile needs: up to the causal frontier, from the
  // first key any of its rows keeps in the window
  const int nk = (Sk + BK - 1) / BK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;

  stage<D>(qs, qg, q0, Sq, scale);

  float acc[4][NC][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous V tile
    stage<D>(kv, kg, k0, Sk, 1.f);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = load4(kv + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // softcap, masks, and the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = kj < Sk;
        if (causal) keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        s[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(ps + (tx + 16 * j) * LDP + ty * 4,
             make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));

    __syncthreads();  // every thread is done with the K tile
    stage<D>(kv, vg, k0, Sk, 1.f);
    __syncthreads();  // the V tile and P are in place

    // O[4 ty + i, 4 tx + 64 c + e] += sum_j P[i, j] V[j, ...]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p = load4(ps + j * LDP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = load4(kv + j * LD + tx * 4 + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(pr[i], x.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pr[i], x.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pr[i], x.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pr[i], x.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store4(og + (size_t)qi * D + tx * 4 + 64 * c,
             make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                         acc[i][c][2] * inv, acc[i][c][3] * inv));
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int causal, int window,
             float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (2 * 64 * (D + 4) + BK * LDP);
  // more than 48 KB of dynamic shared memory only when asked for
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Sk,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Hq, Sq, D) contiguous f32; k, v: (B, Hkv, Sk, D) contiguous
// f32.  causal: 0 or 1; window: 0 for none; softcap: 0 for none.  Launch
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a D not compiled here or heads that do not
// group.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int D,
                                      int causal, int window, float scale,
                                      float softcap, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                          scale, softcap, st);
    case 128:
      return launch_d<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                           scale, softcap, st);
    case 256:
      return launch_d<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                           scale, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
