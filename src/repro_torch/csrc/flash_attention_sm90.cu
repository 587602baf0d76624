// flash_attention_sm90: blocked online-softmax attention, forward, on
// bf16 q, k, v, for Hopper (sm_90a): wgmma on bf16 tiles with f32 sums,
// TMA loads into a ring of shared-memory stages, a producer warp.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py) for bf16 inputs; f32
// inputs go to csrc/flash_attention.cu.  For query row i of head h (KV
// head h / (Hq / Hkv)), as there:
//
//     s_j = scale * (q_i . k_j)             bf16 products, f32 sums
//     s_j = softcap * tanh(s_j / softcap)   (if softcap > 0)
//     s_j = -1e30 unless j < Sk, (j <= i if causal), (j > i - window)
//     o_i = sum_j softmax(s)_j v_j          online over key tiles
//
// and o_i / max(l, 1e-30) is written in bf16.  The masks are by index; a
// masked score is the -1e30 sentinel, not -inf, so a row that meets a
// wholly masked tile first carries exp(0) = 1 terms until a real score
// rescales them away by exp(-1e30 - m) = 0, as the reference does.  The
// softmax runs in base 2: the scale with log2(e) folded in multiplies S
// in f32 (q is not pre-scaled, which would round q * scale to bf16), and
// the sentinel stays -1e30 in those units, with the same effect.
//
// What bounds it on an H100: 4 D operations per (query, key) pair kept,
// 412.4 GFLOP at the llama3.2-3b prefill shape (B=4, Hq=24, Hkv=8,
// S=4096, D=128, causal) against 268 MB of q, k, v and o, so operations:
// 0.417 ms at the bf16 tensor cores' 989 TFLOP/s.  Only wgmma reaches
// that rate, so both products run on it.
//
// Design.  One CTA of 384 threads per (128 query rows, head, batch row),
// the query tile index slowest and, when causal, the heaviest tiles
// first.  Warpgroups 0 and 1 are consumers, 64 query rows each (wgmma's
// M); warp 8 of warpgroup 2 is the producer, whose one elected thread
// issues every TMA load; `setmaxnreg` gives the producer warpgroup 24
// registers and the consumers 240.  Tiles per D (keys a tile, dynamic
// shared memory of the Q tile and the ring, plus barriers and 1 KB of
// room to align the base to the swizzle's 1024 bytes):
//
//     D = 64:  BK = 128, 2 stages,  80 KB (83,000 bytes)
//     D = 128: BK = 128, 2 stages, 160 KB (164,920 bytes)
//     D = 256: BK =  64, 2 stages, 192 KB (197,688 bytes): the O
//              accumulator alone is 128 f32 registers a thread, so S is
//              kept to 32
//
// One CTA an SM at every D.  `nvcc -Xptxas -v` (CUDA 12.9, sm_90a) on
// the H100 reports, for each D, 168 registers at entry (the 384-thread
// launch bound; `setmaxnreg` then moves them), 0 bytes of stack and 0
// bytes of spill stores and loads, and no warning that `setmaxnreg` was
// ignored.
//
// Loads: host-built 3-D tensor maps over (D, S, B*H), boxes of 64
// columns (128 bytes, the widest box under the 128-byte swizzle), so a
// tile is D/64 boxes and a tile past Sq or Sk reads zeros, never the
// next head's rows.  Q loads once; K and V of each key tile go through
// a ring of 2 stages with a full barrier each (transaction bytes) and
// one empty barrier a stage (one arrival per consumer warp).
//
// S = Q K^T: wgmma m64nBKk16, A and B both from shared memory, K-major
// (K as stored), 128-byte swizzle, D/16 steps.  Softmax in registers:
// each thread holds 2 rows of the m64 accumulator, so a row's max and
// sum are shuffles within a quad of threads; l is kept per thread and
// summed over the quad at the end.  Masks are applied only to tiles
// that cross Sk, the causal diagonal or the window's edge; tiles wholly
// masked for a warpgroup's rows are skipped (their result would be
// zero, or cancelled exactly by a later alpha = 0).  O += P V: P is
// rounded to bf16 in registers, where an accumulator column pair is
// the A fragment of wgmma with no shuffle; V stays (keys, D) in shared
// memory, MN-major for this product (the descriptor's transpose bit),
// one m64n64k16 per 64 columns of D and 16 keys.  O is rescaled by
// alpha in registers, divided by max(l, 1e-30) at the end and stored
// as bf16 pairs; rows past Sq are not stored.
//
// Fast math: ex2.approx.ftz for exp2 and tanh.approx for the softcap; P
// is rounded to bf16 anyway.
//
// Not done yet (ROADMAP Queue B): a persistent scheduler, overlap of
// one tile's softmax with the next tile's QK^T within a warpgroup, and
// ping-pong between the two consumer warpgroups.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // the runtime, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;         // query rows of a CTA
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = 384;    // and the producer warpgroup
constexpr int STAGES = 2;       // K and V ring depth
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {  // byte offsets from a 1024-byte aligned base
  static constexpr int BK = D == 256 ? 64 : 128;  // keys a tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K = Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BAR = V + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarrier
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
// arrive once and expect `bytes` of TMA transactions
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------- TMA
// box at (c0, c1, c2) of a 3-D map into shared memory at `dst`,
// completing `bytes` of `bar`'s transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// --------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a tile laid out by a 128-byte
// swizzled TMA box: rows of 128 bytes, 8-row groups 1024 bytes apart.
// Both byte offsets are 1024 (64 units of 16 bytes): the K-major
// operands read only the stride between 8-row groups, and the MN-major
// V, one 64-column atom wide for each instruction, only the stride
// between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)64 << 16) |
         ((uint64_t)64 << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator
// across the asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (m64 x n64, f32) += A (64 x 16, K-major) * B (16 x 64, K-major),
// both from shared memory; `acc` 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D (m64 x n128, f32) += A (64 x 16, K-major) * B (16 x 128, K-major),
// both from shared memory; `acc` 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// D (m64 x n64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64),
// B from shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// scale_log2 = scale * log2(e); with a softcap, the score in base-2
// units is tanh(s * cap_in) * cap_out (cap_in = scale / softcap, cap_out
// = softcap * log2(e)); cap_in = 0 for none
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                      int Sk, int causal, int window, float scale_log2,
                      float cap_in, float cap_out) {
  using L = Layout<D>;
  constexpr int BK = L::BK;
  constexpr int NB = D / 64;  // 64-column boxes of a row (128 bytes each)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + L::K, sv = base + L::V;
  const uint32_t q_full = base + L::BAR;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int nq = gridDim.z;
  const int qt = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  // key tiles this query tile needs: up to the causal frontier, from the
  // first key any of its rows keeps in the window
  const int nk = (Sk + BK - 1) / BK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(k_full + 8 * s, 1);
      bar_init(v_full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      bar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load(sq + c * BQ * 128, &tq, q_full, 64 * c, q0, b * Hq + h);
      const int bh = b * Hkv + hk;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        // the stage's previous tile released by every consumer warp
        if (i >= STAGES) bar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        const int k0 = (kt_begin + i) * BK;
        const uint32_t ks = sk + s * L::KV_BYTES, vs = sv + s * L::KV_BYTES;
        bar_expect_tx(k_full + 8 * s, L::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(ks + c * BK * 128, &tk, k_full + 8 * s, 64 * c, k0, bh);
        bar_expect_tx(v_full + 8 * s, L::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(vs + c * BK * 128, &tv, v_full + 8 * s, 64 * c, k0, bh);
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32;
    const int wq0 = q0 + 64 * wg;  // this warpgroup's first row
    // this thread's rows (ra and ra + 8) and first column of each 8
    const int ra = wq0 + 16 * (t / 32) + lane / 4;
    const int col = 2 * (lane % 4);
    const uint32_t qa = sq + wg * 64 * 128;

    float acc[NB][32];  // O: one m64n64 accumulator per 64 columns
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

    bar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = (kt_begin + i) * BK;
      const uint32_t ks = sk + s * L::KV_BYTES, vs = sv + s * L::KV_BYTES;
      // wholly above this warpgroup's causal frontier, or before its
      // window: nothing to add (or only terms a later alpha = 0 cancels)
      const bool skip = (causal && k0 > wq0 + 63) ||
                        (window > 0 && k0 + BK - 1 <= wq0 - window);
      bar_wait(k_full + 8 * s, parity);
      if (!skip) {
        // ---- S = Q K^T
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns in a box
          wgmma_ss(sc, sw128_desc(qa + (kk / 4) * BQ * 128 + off),
                   sw128_desc(ks + (kk / 4) * BK * 128 + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        reg_fence(sc);

        // ---- scale, softcap, masks; the online softmax of rows ra, ra+8
        const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wq0) ||
                          (window > 0 && k0 <= wq0 + 63 - window);
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float xa = sc[4 * j + e], xb = sc[4 * j + 2 + e];
            if (cap_in > 0.f) {
              xa = fast_tanh(xa * cap_in) * cap_out;
              xb = fast_tanh(xb * cap_in) * cap_out;
            } else {
              xa *= scale_log2;
              xb *= scale_log2;
            }
            if (edge) {
              const int kj = k0 + 8 * j + col + e;
              bool ka = kj < Sk, kb = ka;
              if (causal) {
                ka = ka && kj <= ra;
                kb = kb && kj <= ra + 8;
              }
              if (window > 0) {
                ka = ka && kj > ra - window;
                kb = kb && kj > ra + 8 - window;
              }
              xa = ka ? xa : kNeg;
              xb = kb ? xb : kNeg;
            }
            sc[4 * j + e] = xa;
            sc[4 * j + 2 + e] = xb;
            mx_a = fmaxf(mx_a, xa);
            mx_b = fmaxf(mx_b, xb);
          }
        mx_a = quad_max(mx_a);
        mx_b = quad_max(mx_b);
        const float alpha_a = fast_exp2(m_a - mx_a);
        const float alpha_b = fast_exp2(m_b - mx_b);
        m_a = mx_a;
        m_b = mx_b;
        // P in bf16 as the A fragments of the 16-key steps: registers 0
        // and 2 hold row ra, 1 and 3 row ra + 8; 0 and 1 the step's first
        // 8 keys, 2 and 3 its last 8
        uint32_t p[BK / 16][4];
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float a0 = fast_exp2(sc[4 * j] - m_a);
          const float a1 = fast_exp2(sc[4 * j + 1] - m_a);
          const float b0 = fast_exp2(sc[4 * j + 2] - m_b);
          const float b1 = fast_exp2(sc[4 * j + 3] - m_b);
          sum_a += a0 + a1;
          sum_b += b0 + b1;
          p[j / 2][2 * (j % 2)] = pack_bf16(a0, a1);
          p[j / 2][2 * (j % 2) + 1] = pack_bf16(b0, b1);
        }
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[c][4 * j] *= alpha_a;
            acc[c][4 * j + 1] *= alpha_a;
            acc[c][4 * j + 2] *= alpha_b;
            acc[c][4 * j + 3] *= alpha_b;
          }

        // ---- O += P V
        bar_wait(v_full + 8 * s, parity);
#pragma unroll
        for (int c = 0; c < NB; ++c) reg_fence(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NB; ++c)
            wgmma_rs(acc[c], p[kk],
                     sw128_desc(vs + c * BK * 128 + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int c = 0; c < NB; ++c) reg_fence(acc[c]);
      } else {
        bar_wait(v_full + 8 * s, parity);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * s);
    }

    // ---- o = O / max(l, 1e-30) in bf16; rows past Sq are not stored
    const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
    const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
    __nv_bfloat16* og = o + ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row >= Sq) continue;
      const float inv = r ? inv_b : inv_a;
      uint32_t* dst = reinterpret_cast<uint32_t*>(og + (size_t)row * D + col);
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[(64 * c + 8 * j) / 2] = pack_bf16(acc[c][4 * j + 2 * r] * inv,
                                                acc[c][4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous bf16 (BH, S, D) tensor as a 3-D map over (D, S, BH) read
// in boxes of 64 columns x `rows` rows, 128-byte swizzled; elements out
// of bounds read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
              int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int causal, int window,
             float scale, float softcap, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * Hq, Sq, D, BQ) ||
      !make_map(&tk, k, B * Hkv, Sk, D, L::BK) ||
      !make_map(&tv, v, B * Hkv, Sk, D, L::BK))
    return -1;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::ALLOC);
  if (err != cudaSuccess) return (int)err;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_kernel_sm90<D><<<grid, THREADS, L::ALLOC, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk, causal,
      window, scale * kLog2e, cap_in, softcap * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Hq, Sq, D) contiguous bf16; k, v: (B, Hkv, Sk, D) contiguous
// bf16; every base address 16-byte aligned.  causal: 0 or 1; window: 0
// for none; softcap: 0 for none.  Launch on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a D not
// compiled here, heads that do not group or too many query tiles, or -1
// when libcuda's tensor-map encoder is missing or refuses a map.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Hq, int Hkv, int Sq, int Sk,
                                           int D, int causal, int window,
                                           float scale, float softcap,
                                           void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 ||
      (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sk == 0)  // no key: every row's sum is 0, and o is 0 / 1e-30
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Hq * Sq * D * 2, st);
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
