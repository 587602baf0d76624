// flash_attention: blocked online-softmax attention, forward, on f32
// q, k, v.  bf16 inputs go to csrc/flash_attention_sm90.cu (wgmma, TMA);
// this kernel serves f32 on the CUDA cores' FMAs.  Single-pass TF32 or
// bf16 tensor-core products would not hold the reference tests' f32
// tolerance of 2e-5 (10 and 8 bits of mantissa); a 3xTF32 split
// (hi*hi + hi*lo + lo*hi) might, and has not been tried.
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
// and o_i / max(l, 1e-30) is written in f32.  The masks are by index (i
// and j count from 0), as in the reference kernel; a masked score is the
// -1e30 sentinel, not -inf, so a row that meets a wholly masked tile
// first carries exp(0) = 1 terms until a real score arrives and rescales
// them away by exp(-1e30 - m) = 0, as the reference does.  Key tiles
// wholly above the causal frontier or wholly before the window are
// skipped.  The softcap divides by multiplying with its reciprocal,
// taken once a thread; expf and tanhf are the accurate ones.
//
// What bounds it on an H100: the function needs 4 D operations per
// (query, key) pair it keeps (two products of length D), 412 GFLOP at the
// llama3.2-3b prefill shape (B=4, Hq=24, S=4096, D=128, causal) against
// 537 MB of f32 q, k, v and o: operations bound it by far.  In f32 they
// run as FMAs on the CUDA cores, at most 67 TFLOP/s, 6.16 ms there.  A
// warp issues one instruction a cycle, so every instruction that is not
// an FMA (a shared-memory load, the softmax, a barrier's wait) takes an
// FMA's place.  chip_smoke.py times this design at 9.68 ms there on an
// NVIDIA H100 80GB HBM3 at 700 W, 1.57x the bound (the 4 x 4 tiles it
// replaced took 12.72 ms).
//
// Design.  A block of 8 warps takes BQ query rows of one (batch, head)
// and walks the key tiles of BK = D keys its rows need.  Each warp owns
// R = 2048 / D rows for the whole walk, so the online softmax's row
// statistics and P never leave the warp.  Thread (r, c) of the warp (lane
// r * D/8 + c) holds an 8 x 8 register tile of scores, rows 4r..4r+3 and
// R/2 + 4r..+3 of its warp's rows against keys c + (D/8) j, j < 8, and
// the same 8 rows of O at columns 4c..4c+3 and D/2 + 4c..+3.  So the
// scores take 16 float4 reads of shared memory per 256 FMAs (8 of k
// along the head, 8 of q^T across rows), and P V four per 64: each read
// feeds 16 FMAs.  Both products are software-pipelined: the next
// column's q^T and k, or the next key's P and v, load into a second set
// of registers while the current one's FMAs run.  q is staged once,
// pre-scaled and transposed to (D, BQ), so that a thread's 4 rows at one
// column are one float4.  Row maxima are shuffle reductions over the D/8
// lanes of a row group; each thread sums l over its own keys, and the
// lanes' sums are added at the end.  P goes to the warp's own (BK, R)
// slice of shared memory, P^T, whose float4 at a key is the thread's 4
// rows.  Between one tile's P V and the next one's softmax the warp's O
// waits in that same slice, so that the score product runs with 64 more
// registers free for its pipelining (a warp's O and its P^T are both
// 2048 floats).
//
// K and V arrive by 16-byte cp.async copies, issued by all threads, into
// a ring of STAGES units of UNIT floats (6 of 16 KB; 3 of 32 KB at D =
// 256): a K unit is DC = UNIT / BK head columns of the tile's keys (the
// score product is a sum over the head, so it consumes K a column block
// at a time), a V unit VC = UNIT / D whole rows (P V is a sum over
// keys).  The units of all tiles form one stream: before a thread reads
// unit g it waits for its own copies of g (cp.async.wait_group) and the
// block's barrier, and then issues unit g + STAGES - 1 into the stage
// that g - 1 has just freed, so STAGES - 1 units are in flight while a
// product runs.  K rows past Sk are zero-filled by the copy.  A warp's P
// V skips the V units whose keys none of its rows keeps.  A K unit's and
// P^T's rows are 16-byte slots swizzled by key, so that the 8 keys one
// wavefront serves lie in distinct banks.  Shared memory: q^T 64 KB, P^T
// (or O) 64 KB, the ring 96 KB: one block (8 warps) an SM at every D,
// with copies in flight at D = 256 as well.
//
// Causal blocks are launched heaviest first: the block index runs over
// (batch, head) fastest and query tiles from the last, so the longest
// walks start in the first wave and neighbouring blocks share K and V
// (GQA groups, and the same KV head) in L2.  Tails of Sq and Sk are
// bounds-checked: rows past Sq are computed on zeros and not stored,
// keys past Sk are masked and read as zeros.  Masks are evaluated only
// on a warp's tiles that cross the causal frontier, the window's start
// or Sk.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

// floats of a ring stage and stages in the ring, by head size: 16 KB
// stages, or 32 KB at D = 256, where a 16 KB K unit would hold only 16
// head columns and take twice the barriers
template <int D>
struct Ring { static constexpr int kUnit = 4096, kStages = 6; };
template <>
struct Ring<256> { static constexpr int kUnit = 8192, kStages = 3; };

template <int D>
struct Tiles {
  static constexpr int R = 2048 / D;  // query rows of a warp
  static constexpr int G = R / 8;     // row groups of a warp
  static constexpr int NC = D / 8;    // lanes of a row group
  static constexpr int BQ = R * kWarps;
  static constexpr int BK = D;
  static constexpr int UNIT = Ring<D>::kUnit, STAGES = Ring<D>::kStages;
  static constexpr int DC = UNIT / BK;  // head columns of a K unit
  static constexpr int VC = UNIT / D;   // keys of a V unit
  static constexpr int KU = D / DC;     // K units of a key tile
  static constexpr int VU = BK / VC;    // V units of a key tile
  static constexpr int W = DC / 4;      // 16-byte slots of a K unit's row
  static constexpr int COPIES = UNIT / 4 / kThreads;  // 16 B a thread
  static constexpr int KR = kThreads / W;             // K rows a copy
  static constexpr int VR = kThreads / (D / 4);       // V rows a copy
  static constexpr int SMEM = 4 * (D * BQ + STAGES * UNIT + kWarps * BK * R);
  // P^T: a key's row is PS float4 slots, PL keys to a 128-byte line
  static constexpr int PS = R / 4, PL = 32 / R;
  static_assert(G * NC == 32, "a warp is G row groups of NC lanes");
  static_assert(W % 8 == 0, "a K unit's row spans all 32 banks");
  static_assert(COPIES * KR == BK && COPIES * VR == VC, "whole units");
  static_assert(SMEM <= 232448, "shared memory of a block");
  // Slot s of a K unit's row k lies at s ^ (k & 7), so the 8 keys that a
  // wavefront serves (k, k + 1, ... at one slot) fall in distinct banks.
  // Slot s of P^T's row k lies at s ^ pswz(k), so the 8 keys that one
  // wavefront of the warp's P^T stores writes do too.
  static __device__ __forceinline__ int swz(int key) { return key & 7; }
  static __device__ __forceinline__ int pswz(int key) {
    return (key / PL) & (PS - 1);
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void split4(float* d, float4 x) {
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}

// 16 bytes from global `src` to shared `dst`; bytes past `size` (0 or
// 16) are zeros
__device__ __forceinline__ void copy16(uint32_t dst, const float* src,
                                       int size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(size)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int B,
                 int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                 float scale, float softcap) {
  using T = Tiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, R = T::R, G = T::G, NC = T::NC;
  constexpr int DC = T::DC, VC = T::VC, KU = T::KU, VU = T::VU, W = T::W;
  constexpr int UNIT = T::UNIT, STAGES = T::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;          // (D, BQ): q^T, pre-scaled
  float* ring = qs + D * BQ;  // (STAGES, UNIT)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = lane / NC, c = lane % NC;
  // the warp's (BK, R) slice: P^T during P V; the warp's O from one
  // tile's P V to the next one's softmax, a thread's 16 float4 at ow[32 n]
  float* pw = ring + STAGES * UNIT + warp * BK * R;
  float4* ow = reinterpret_cast<float4*>(pw) + lane;
  static_assert(BK * R == 32 * 64, "a warp's O fills its P^T slice");

  const int heads = B * Hq;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)(blockIdx.x / heads)
                        : (int)(blockIdx.x / heads);
  const int h = (int)(blockIdx.x % heads) % Hq;
  const int b = (int)(blockIdx.x % heads) / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;

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
  const int units = max(0, kt_end - kt_begin) * (KU + VU);

  // unit g of the stream into stage g % STAGES (tile kt_begin + g / (KU +
  // VU): its K units, then its V units), and a commit either way, so that
  // the group count stays one a unit.  This thread copies K rows kr + n
  // KR at slot ks, or V rows vr + n VR at column 4 vc.
  const int kr = tid / W, ks = tid % W, vr = tid / (D / 4), vc = tid % (D / 4);
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t kdst = ring_s + 4 * (kr * DC + 4 * (ks ^ T::swz(kr)));
  const uint32_t vdst = ring_s + 4 * (vr * D + 4 * vc);
  auto issue = [&](int g) {
    if (g < units) {
      const int k0 = (kt_begin + g / (KU + VU)) * BK, u = g % (KU + VU);
      const uint32_t st = 4 * (g % STAGES) * UNIT;
      if (u < KU) {
        const int row = k0 + kr;
        const float* src = kg + (size_t)row * D + u * DC + 4 * ks;
#pragma unroll
        for (int n = 0; n < T::COPIES; ++n) {
          const bool in = row + n * T::KR < Sk;
          copy16(kdst + st + 4 * n * T::KR * DC,
                 in ? src + n * T::KR * D : kg, in ? 16 : 0);
        }
      } else {
        const int row = k0 + (u - KU) * VC + vr;
        const float* src = vg + (size_t)row * D + 4 * vc;
#pragma unroll
        for (int n = 0; n < T::COPIES; ++n) {
          const bool in = row + n * T::VR < Sk;
          copy16(vdst + st + 4 * n * T::VR * D,
                 in ? src + n * T::VR * D : vg, in ? 16 : 0);
        }
      }
    }
    copy_commit();
  };

  for (int g = 0; g < STAGES - 1; ++g) issue(g);

  // q^T, times the scale; rows past Sq are zeros.  Row-fastest, so that
  // a warp's stores are consecutive
#pragma unroll 4
  for (int p = tid; p < BQ * (D / 4); p += kThreads) {
    const int row = p % BQ, c4 = p / BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < Sq) {
      x = load4(qg + (size_t)(q0 + row) * D + c4 * 4);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    float* d = qs + (4 * c4) * BQ + row;
    d[0] = x.x; d[BQ] = x.y; d[2 * BQ] = x.z; d[3 * BQ] = x.w;
  }

  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const int wrow = warp * R;  // the warp's first row in the query tile
  const int rlo = q0 + wrow, rhi = rlo + R - 1;
  const int kx = T::swz(c);   // the swizzle of the thread's key rows
  // the thread's row i (of 8) within its warp's rows
#define ROW(i) (((i) / 4) * 4 * G + 4 * r + (i) % 4)

  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) ow[32 * n] = make_float4(0.f, 0.f, 0.f, 0.f);

  int g = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    // S = (scale q) K^T over the tile's K units, a column block each.  The
    // next column's q^T and (spread over a slot's four columns) the next
    // slot's k load into the other buffer while this column's 64 FMAs run.
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int u = 0; u < KU; ++u, ++g) {
      copy_wait<STAGES - 2>();
      __syncthreads();  // unit g landed; every thread is done with g - 1
      issue(g + STAGES - 1);
      const float* ku = ring + (g % STAGES) * UNIT + c * DC;
      const float* qu = qs + u * DC * BQ + wrow + 4 * r;
      float kb[2][8][4], ab[2][8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        split4(kb[0][j], load4(ku + j * NC * DC + 4 * kx));
      split4(ab[0], load4(qu));
      split4(ab[0] + 4, load4(qu + 4 * G));
#pragma unroll
      for (int sl = 0; sl < W; ++sl) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * sl + e;
          if (d + 1 < DC) {
            split4(ab[(d + 1) & 1], load4(qu + (d + 1) * BQ));
            split4(ab[(d + 1) & 1] + 4, load4(qu + (d + 1) * BQ + 4 * G));
          }
          if (sl + 1 < W) {
#pragma unroll
            for (int j = 2 * e; j < 2 * e + 2; ++j)
              split4(kb[(sl + 1) & 1][j],
                     load4(ku + j * NC * DC + 4 * ((sl + 1) ^ kx)));
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              s[i][j] = fmaf(ab[d & 1][i], kb[sl & 1][j][e], s[i][j]);
        }
      }
    }

    // softcap, masks, and the online softmax of each row
    const int k0 = kt * BK;
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = softcap * tanhf(s[i][j] * inv_cap);
    }
    if ((causal && k0 + BK - 1 > rlo) || (window > 0 && k0 <= rhi - window) ||
        k0 + BK > Sk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qi = rlo + ROW(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kj = k0 + c + NC * j;
          bool keep = kj < Sk;
          if (causal) keep = keep && kj <= qi;
          if (window > 0) keep = keep && kj > qi - window;
          if (!keep) s[i][j] = kNegInf;
        }
      }
    }
    float alpha[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = NC / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha[i] + sum;
    }
    // O back from the warp's slice, rescaled (it stays out of the
    // registers while the scores are summed), then P^T in its place
    float acc[8][8];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float4 x = ow[32 * n];
      const int i = n / 2, e = 4 * (n % 2);
      acc[i][e] = x.x * alpha[i];
      acc[i][e + 1] = x.y * alpha[i];
      acc[i][e + 2] = x.z * alpha[i];
      acc[i][e + 3] = x.w * alpha[i];
    }
    __syncwarp();
    const int px = T::pswz(c);  // that of the thread's keys c + NC j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* pj = pw + (c + NC * j) * R;
      store4(pj + 4 * (r ^ px),
             make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
      store4(pj + 4 * (r ^ G ^ px),
             make_float4(s[4][j], s[5][j], s[6][j], s[7][j]));
    }

    // O += P V over the tile's V units, VC keys each (read by the warp
    // after the next barrier); the next key's P and v load into the
    // other buffer while this key's 64 FMAs run
    for (int u = 0; u < VU; ++u, ++g) {
      copy_wait<STAGES - 2>();
      __syncthreads();
      issue(g + STAGES - 1);
      // keys that none of the warp's rows keeps: their P is 0, or (before
      // a row's first kept key) a term that key's rescale sets to 0
      const int v0 = kt * BK + u * VC;
      if ((causal && v0 > rhi) || (window > 0 && v0 + VC <= rlo - window + 1) ||
          v0 >= Sk)
        continue;
      const float* vu = ring + (g % STAGES) * UNIT + 4 * c;
      // the thread's two slots of key kk at p0[x] + kk R and p1[x] + kk R,
      // x = pswz(kk) (VC is a multiple of the swizzle's period)
      static_assert(VC % (T::PS * T::PL) == 0, "whole swizzle periods");
      const float *p0[T::PS], *p1[T::PS];
#pragma unroll
      for (int x = 0; x < T::PS; ++x) {
        p0[x] = pw + u * VC * R + 4 * (r ^ x);
        p1[x] = pw + u * VC * R + 4 * (r ^ G ^ x);
      }
      float pb[2][8], xb[2][8];
      split4(pb[0], load4(p0[0]));
      split4(pb[0] + 4, load4(p1[0]));
      split4(xb[0], load4(vu));
      split4(xb[0] + 4, load4(vu + 4 * NC));
#pragma unroll
      for (int kk = 0; kk < VC; ++kk) {
        if (kk + 1 < VC) {
          const int nb = (kk + 1) & 1;
          const int x = T::pswz(kk + 1);
          split4(pb[nb], load4(p0[x] + (kk + 1) * R));
          split4(pb[nb] + 4, load4(p1[x] + (kk + 1) * R));
          split4(xb[nb], load4(vu + (kk + 1) * D));
          split4(xb[nb] + 4, load4(vu + (kk + 1) * D + 4 * NC));
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[i][e] = fmaf(pb[kk & 1][i], xb[kk & 1][e], acc[i][e]);
      }
    }
    __syncwarp();  // the warp is done with P^T
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int i = n / 2, e = 4 * (n % 2);
      ow[32 * n] = make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2],
                               acc[i][e + 3]);
    }
  }
  copy_wait<0>();

  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = NC / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qi = q0 + wrow + ROW(i);
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const float4 x0 = ow[32 * (2 * i)], x1 = ow[32 * (2 * i + 1)];
    float* orow = og + (size_t)qi * D + 4 * c;
    store4(orow, make_float4(x0.x * inv, x0.y * inv, x0.z * inv, x0.w * inv));
    store4(orow + 4 * NC,
           make_float4(x1.x * inv, x1.y * inv, x1.z * inv, x1.w * inv));
  }
#undef ROW
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int causal, int window,
             float scale, float softcap, cudaStream_t stream) {
  using T = Tiles<D>;
  // more than 48 KB of dynamic shared memory only when asked for
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + T::BQ - 1) / T::BQ) * B * Hq;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_kernel<D><<<(unsigned)blocks, kThreads, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, Hq, Hkv, Sq,
      Sk, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Hq, Sq, D) contiguous f32; k, v: (B, Hkv, Sk, D) contiguous
// f32.  causal: 0 or 1; window: 0 for none; softcap: 0 for none.  Launch
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a D not compiled here, heads that do not
// group, or more blocks than a grid holds.
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
