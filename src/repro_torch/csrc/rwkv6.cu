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
// What bounds it on an H100: operations.  The function needs 5 N^2 + 5 N
// f32 operations per step per b·h (S^T r, diag(w) S + k v^T, and the
// bonus as v (u·k·r), a dot product) against (3 + 1) N loads and N
// stores: at the rwkv6-3b prefill (BH=160, T=4096, N=64) 13.63 GFLOP,
// 0.2035 ms at 67 TFLOP/s, against 0.15 ms for its bytes.  Time is a
// serial chain; b·h, the state's columns and its keys run in parallel.
//
// What the first design (one block of N threads per b·h, thread m owning
// column S[:, m]) lost, 2.05 ms at that shape: 160 blocks of 2 warps left
// most of the 528 warp schedulers idle and each warp alone with a serial
// chain of 64 keys a step; the bonus u·kv was formed per (key, column),
// four instructions a pair; u, r, k, w were scalar shared loads, 4 N a
// step for each column; and staging was synchronous.
//
// Design: columns of S evolve independently given r_t, k_t, w_t and
// v_t[m], and keys only meet in the sum of y.  So the grid is (BH, N/VC):
// a block owns VC columns of one b·h's S.  KS neighbouring lanes share a
// group of CPT columns, each holding NK = N/KS keys of them in
// registers.  One split is compiled per head size (`Split` below); at
// N=64 it is VC=32, KS=16, CPT=4: 320 blocks of 128 threads, 9.7 warps an
// SM, 4 keys by 4 columns a lane.  Several columns a lane make each shared
// load of r, k, w serve CPT columns; shared-memory traffic per column and
// the lane's share of the per-key work fall by CPT, while KS keeps enough
// warps in flight.  It was the fastest of the splits timed at the rwkv6-3b
// prefill shape on an H100 (PERF.md records them).
//
// The inner loop is three instructions per (key, column): kv = k v;
// y += S r; S = w S + kv.  The bonus is taken once per key, not per
// pair: beta_t = sum_n u_n k_n r_n, y_t[m] = sum_n S[n,m] r_n +
// v_t[m] beta_t, each lane adding v beta_part to its partial sums.  A
// lane's keys are groups of four (g = s + j*KS for lane s), read as one
// 8-byte (bf16) or 16-byte (f32) shared load that a phase of the warp
// takes from contiguous bytes, free of bank conflicts; bf16 becomes f32
// by a shift or a mask.  The KS partial sums of a column are added in
// batches: a lane keeps KS sums (KS/CPT steps by CPT columns) and a
// reduce-scatter over its KS lanes, KS-1 shuffles, leaves each lane one
// total to store, in place of log2(KS) shuffles per sum.
//
// Staging: time runs in chunks of TC steps through a ring of NSTAGE
// shared-memory stages filled by cp.async (16-byte copies, L2 only), so
// chunks c+1 and c+2 load while chunk c is stepped.  The inputs land in
// their own types (bf16 halves the bytes) and are read from the ring as
// they are; one barrier a chunk frees a stage.  The N/VC blocks of a b·h
// each read its r, k and w, from L2 after the first.
//
// The sum over keys runs in another order than the plain version, so the
// two agree to f32 rounding, not bitwise.  No tensor cores: each step is
// a rank-1 update and a matrix-vector product, not a matrix product.  The
// tensor-core route is the chunked form (attention within a chunk over
// cumulative decays, the state between chunks by matrix products); it
// divides by products of w over a chunk, which in f32, with the decays
// of a trained model near 0, needs sub-chunks and a new error budget.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;     // steps of one staged chunk
constexpr int NSTAGE = 3;  // chunks in flight in the cp.async ring

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// four consecutive elements (8- or 16-byte aligned), as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the high half of its f32: one shift or mask per value
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// p ? a : b as one PTX selp, both operands in registers
__device__ __forceinline__ float select(int p, float a, float b) {
  float out;
  asm("{\n .reg .pred q;\n setp.ne.s32 q, %3, 0;\n"
      " selp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(out)
      : "f"(a), "f"(b), "r"(p));
  return out;
}

// Sums P = 2H partial sums over the 2H lanes that hold them, lane s
// keeping the total of sum s in acc[0]: at each level a lane sends the
// half it gives away and adds its partner's copy of the half it keeps.
// The levels are template steps, so every index is a constant and acc
// stays in registers.
template <int H, int P>
__device__ __forceinline__ void reduce_scatter(float (&acc)[P], int s) {
  if constexpr (H > 0) {
    const int upper = s & H;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = select(upper, acc[i], acc[i + H]);
      const float keep = select(upper, acc[i + H], acc[i]);
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    reduce_scatter<H / 2>(acc, s);
  }
}

__device__ __forceinline__ float get(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// CPT consecutive elements as f32: one vector load where CPT is 4
template <int CPT, typename T>
__device__ __forceinline__ void load_cols(const T* p, float* out) {
  if constexpr (CPT == 4) {
    const float4 v = load4(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i) out[i] = to_float(p[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// One stage of the ring, in bytes: a chunk's r, k, w rows and the
// block's VC columns of v, in the inputs' own types.
template <int N, int VC, typename TI, typename TW>
struct Stage {
  static constexpr int kRK = TC * N * sizeof(TI);  // r, or k
  static constexpr int kW = TC * N * sizeof(TW);
  static constexpr int kV = TC * VC * sizeof(TI);
  static constexpr int kBytes = 2 * kRK + kW + kV;
};

template <int N, int VC, int KS, int CPT, typename TI, typename TW>
__global__ void __launch_bounds__(VC / CPT * KS)
    rwkv6_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                 const TI* __restrict__ v, const TW* __restrict__ w,
                 const TI* __restrict__ u, TI* __restrict__ y, int T) {
  constexpr int NT = VC / CPT * KS;  // threads
  constexpr int NK = N / KS;         // keys a lane holds
  constexpr int G = NK / 4;          // its 4-key groups
  constexpr int B = KS / CPT;        // steps of a batch
  using L = Stage<N, VC, TI, TW>;
  static_assert(NT % 32 == 0 && NK % 4 == 0 && N % VC == 0, "split");
  static_assert(B >= 1 && B * CPT == KS && TC % B == 0, "split");
  static_assert(CPT == 1 || CPT == 2 || CPT == 4, "split");
  static_assert((VC * sizeof(TI)) % 16 == 0, "v slices of 16-byte pieces");
  static_assert((N * sizeof(TI)) % 16 == 0, "rows of 16-byte pieces");

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * VC;
  const size_t base = (size_t)bh * T * N;
  const int nchunks = (T + TC - 1) / TC;

  // chunk c's r, k, w rows and v's VC columns into its ring stage
  auto issue = [&](int c) {
    if (c >= nchunks) return;
    unsigned char* stage = smem + (c % NSTAGE) * L::kBytes;
    const int t0 = c * TC;
    const int steps = min(TC, T - t0);
    const size_t off = base + (size_t)t0 * N;
    // 16-byte pieces of a step's r (or k) row, w row and v slice
    constexpr int PRK = N * sizeof(TI) / 16, PW = N * sizeof(TW) / 16;
    constexpr int PV = VC * sizeof(TI) / 16;  // powers of two
    const char* gr = reinterpret_cast<const char*>(r + off);
    const char* gk = reinterpret_cast<const char*>(k + off);
    const char* gw = reinterpret_cast<const char*>(w + off);
    const char* gv = reinterpret_cast<const char*>(v + off + m0);
#pragma unroll
    for (int p = tid; p < TC * PRK; p += NT) {
      if (p < steps * PRK) {
        cp_async16(stage + 16 * p, gr + 16 * p);
        cp_async16(stage + L::kRK + 16 * p, gk + 16 * p);
      }
    }
#pragma unroll
    for (int p = tid; p < TC * PW; p += NT)
      if (p < steps * PW) cp_async16(stage + 2 * L::kRK + 16 * p, gw + 16 * p);
    unsigned char* sv = stage + 2 * L::kRK + L::kW;
#pragma unroll
    for (int p = tid; p < TC * PV; p += NT) {
      const int t = p / PV, o = p % PV;
      if (t < steps)
        cp_async16(sv + 16 * p, gv + (size_t)t * N * sizeof(TI) + 16 * o);
    }
  };

  // lane (cg, s) holds keys 4 (s + j KS) .. + 3, j < G, of columns
  // m0 + cg CPT .. + CPT - 1, and u of those keys
  const int s = tid % KS;
  const int cg = tid / KS;
  float S[CPT][NK];
  float uk[NK];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float4 u4 = load4(u + (size_t)bh * N + 4 * (s + j * KS));
#pragma unroll
    for (int x = 0; x < 4; ++x) uk[4 * j + x] = get(u4, x);
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int n = 0; n < NK; ++n) S[i][n] = 0.0f;

#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) {
    issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NSTAGE - 2>();  // this lane's copies of chunk c landed
    __syncthreads();  // everyone's have, and chunk c-1 is stepped, so its
                      // stage is free for chunk c + NSTAGE - 1
    issue(c + NSTAGE - 1);
    cp_async_commit();

    const int t0 = c * TC;
    const int steps = min(TC, T - t0);
    const unsigned char* stage = smem + (c % NSTAGE) * L::kBytes;
    const TI* sr = reinterpret_cast<const TI*>(stage);
    const TI* sk = reinterpret_cast<const TI*>(stage + L::kRK);
    const TW* sw = reinterpret_cast<const TW*>(stage + 2 * L::kRK);
    const TI* sv = reinterpret_cast<const TI*>(stage + 2 * L::kRK + L::kW);

    // steps in batches of B: a lane's KS partial sums of a batch (B steps
    // by CPT columns) are summed over its KS lanes by a reduce-scatter,
    // after which lane s holds the total of sum s.  Steps of a batch past
    // `steps` (the last chunk's tail) run on stale shared data after
    // every real step and are never stored.
#pragma unroll 2
    for (int tb = 0; tb < steps; tb += B) {
      float acc[B * CPT];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = tb + b;
        float vm[CPT];
        load_cols<CPT>(sv + t * VC + cg * CPT, vm);
        float beta = 0.0f;  // this lane's part of sum_n u_n k_n r_n
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[b * CPT + i] = 0.0f;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int g = 4 * (s + j * KS);
          const float4 r4 = load4(sr + t * N + g);
          const float4 k4 = load4(sk + t * N + g);
          const float4 w4 = load4(sw + t * N + g);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float rn = get(r4, x), kn = get(k4, x), wn = get(w4, x);
            beta = fmaf(uk[4 * j + x] * kn, rn, beta);
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
              float& sn = S[i][4 * j + x];
              const float kv = kn * vm[i];
              acc[b * CPT + i] = fmaf(sn, rn, acc[b * CPT + i]);
              sn = fmaf(wn, sn, kv);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          acc[b * CPT + i] = fmaf(vm[i], beta, acc[b * CPT + i]);
      }
      reduce_scatter<KS / 2>(acc, s);
      const int t = tb + s / CPT;  // CPT is a power of two
      if (t < steps)
        put(y + base + (size_t)(t0 + t) * N + m0 + cg * CPT + s % CPT, acc[0]);
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block
}

// The split launched for each head size: VC value columns a block, KS
// lanes a column, CPT columns a lane.
template <int N>
struct Split;
template <>
struct Split<16> {
  static constexpr int VC = 16, KS = 4, CPT = 2;
};
template <>
struct Split<32> {
  static constexpr int VC = 16, KS = 8, CPT = 4;
};
template <>
struct Split<64> {
  static constexpr int VC = 32, KS = 16, CPT = 4;
};

template <int N, typename TI, typename TW>
int launch_typed(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* y, int BH, int T, cudaStream_t stream) {
  using P = Split<N>;
  auto kernel = rwkv6_kernel<N, P::VC, P::KS, P::CPT, TI, TW>;
  constexpr int smem = NSTAGE * Stage<N, P::VC, TI, TW>::kBytes;
  constexpr int threads = P::VC / P::CPT * P::KS;
  // the largest shared-memory carveout, so that the ring of several
  // blocks fits one SM beside the registers they need
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)BH, N / P::VC);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TW*>(w),
      static_cast<const TI*>(u), static_cast<TI*>(y), T);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, int BH, int T, int in_bf16, int w_bf16,
             cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (in_bf16 && w_bf16)
    return launch_typed<N, bf16, bf16>(r, k, v, w, u, y, BH, T, st);
  if (in_bf16) return launch_typed<N, bf16, float>(r, k, v, w, u, y, BH, T, st);
  if (w_bf16) return launch_typed<N, float, bf16>(r, k, v, w, u, y, BH, T, st);
  return launch_typed<N, float, float>(r, k, v, w, u, y, BH, T, st);
}

}  // namespace

// r, k, v, w: (BH, T, N) contiguous; u: (BH, N); y: (BH, T, N) in the
// type of r; every pointer 16-byte aligned.  in_bf16: r, k, v, u, y are
// bf16 (else f32); w_bf16: w is bf16 (else f32); N is 16, 32 or 64.
// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for another head size.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* y, int BH,
                            int T, int N, int in_bf16, int w_bf16,
                            void* stream) {
  if (BH == 0 || T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch_n<16>(r, k, v, w, u, y, BH, T, in_bf16, w_bf16, st);
  if (N == 32) return launch_n<32>(r, k, v, w, u, y, BH, T, in_bf16, w_bf16, st);
  if (N == 64) return launch_n<64>(r, k, v, w, u, y, BH, T, in_bf16, w_bf16, st);
  return (int)cudaErrorInvalidValue;
}

// The split rwkv6_launch uses for head size N, for reports: {VC, KS, CPT}
// into split[0..2]; returns 0, or cudaErrorInvalidValue for another N.
extern "C" int rwkv6_split(int N, int* split) {
  auto put3 = [split](int vc, int ks, int cpt) {
    split[0] = vc, split[1] = ks, split[2] = cpt;
    return 0;
  };
  if (N == 16) return put3(Split<16>::VC, Split<16>::KS, Split<16>::CPT);
  if (N == 32) return put3(Split<32>::VC, Split<32>::KS, Split<32>::CPT);
  if (N == 64) return put3(Split<64>::VC, Split<64>::KS, Split<64>::CPT);
  return (int)cudaErrorInvalidValue;
}
