// pair_apply: walk a presampled (T, B) gossip schedule over (B, C, V) cell state.
//
// Replaces the TPU kernel `_pair_apply_kernel` / `pair_apply_pallas`
// (src/repro/kernels/pair_apply/kernel.py).  At every tick t, cell b
// averages rows i[t, b] and j[t, b] as avg = 0.5f * (x_i + x_j), then
// writes row j if upd_j[t, b] and after it row i if upd_i[t, b].  Cells
// never interact, and the V value channels of a cell are independent
// chains.
//
// What bounds it on an H100: bytes.  The work is 2 f32 adds/muls per
// tick and value channel; the state is read once and written once
// (2*B*C*V*4 bytes) and the schedule read once (T*B*(4+4+1+1) bytes).
// At the finest level of n=10^5 (B=43250, C=9, V=2, T=50) that is about
// 28 MB, some 8 us at the H100 SXM data-sheet rate of 3.35 TB/s.
//
// Design.  The ticks of one chain are serial, so a walk that reads each
// tick's schedule entries from device memory waits one memory latency a
// tick.  Here a block takes 32 cells and two warps.  The producer warp
// stages the cells' schedule into a shared-memory ring of tiles (TT
// ticks each, kStages in flight) with 16-byte `cp.async.cg` copies,
// coalesced along the cells of a tick row, whose completion arrives on
// the stage's mbarrier.  The consumer warp, a lane a cell, loads the
// state first (its first loads go out before the producer's copies, so
// they do not queue behind them), then walks the ring tile by tile,
// reading each tick's entries one tick ahead of the state update, and
// hands each stage back on a second mbarrier.  Copying and walking
// overlap: a warp that issues copies stalls at the rate memory delivers
// them, and the walking warp does not.
//
// At the finest level every block is resident at once and the walk is
// bound by instruction issue, so a tick is kept to few instructions.  A
// lane walks all V channels of its cell, which share the tick's entries
// (a lane per (cell, channel) decodes each tick V times), and holds a
// row's channels as one value, a float2 for V == 2 (one load and one
// store a row; other V go channel by channel).  A tick updates without a
// branch, so the warp never splits: a lane with no update reads row 0
// and writes nothing.  chip_smoke.py times it at (43250, 9, 2, 50) at
// 0.0126 ms on an NVIDIA H100 80GB HBM3 (700 W), 1.5x its bytes bound.
//
// The arrays are (T, B), so a block's slice of a tick row is 32
// consecutive entries that start anywhere; a slice is copied as the
// 16-byte-aligned chunks that hold it (an aligned 16 bytes never cross a
// page, so reading a chunk's other bytes is safe), each producer lane
// always the same chunk of the same array, and read at the slice's
// offset within its first chunk.  Shared state holds value e of cell k
// (a row, or one channel of a row) at st[e * 32 + k], so the warp's
// lanes hit distinct banks whatever rows they touch.  A cell too wide for shared memory walks its rows in
// device memory (the output doubles as the state).
//
// Bitwise equality with the plain version: __fadd_rn / __fmul_rn pin
// the two roundings of 0.5f * (x_i + x_j) (no contraction, no
// reassociation), and the writes keep the plain version's order (row j,
// then row i), which decides the result when i == j.  The update bits
// come in as uint8, never bool.  A tick whose row index lies outside
// [0, C) is skipped.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCells = 32;  // cells a block, one consumer lane each
constexpr int kStages = 2;  // schedule tiles in flight

// One staged tick row: the 16-byte-aligned chunks that hold the block's
// slices of i and j (at most 9 each), then of upd_i and upd_j (3 each).
constexpr int kIntChunks = kCells / 4 + 1;
constexpr int kByteChunks = kCells / 16 + 1;
constexpr int kSlots = 2 * kIntChunks + 2 * kByteChunks;  // 24 copies a row
constexpr int kJ = 16 * kIntChunks;
constexpr int kUi = 2 * kJ;
constexpr int kUj = kUi + 16 * kByteChunks;
constexpr int kRow = kUj + 16 * kByteChunks;
constexpr int kBars = 128;  // bytes for the barriers, before the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// this thread's arrival on `bar`, once its cp.async copies so far landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// The producer warp: lane q < kSlots copies chunk `c` of array `a`'s
// slice of every tick row into the ring; every lane arrives on the
// stage's full barrier when its copies of a tile have landed, after the
// consumers handed the stage back.
__device__ __forceinline__ void produce(uint32_t ring, uint32_t full,
                                        uint32_t empty, const int* si,
                                        const int* sj, const uint8_t* sui,
                                        const uint8_t* suj, int T, int TT,
                                        long long B, long long b0, int ncell) {
  const int q = threadIdx.x & 31;
  int a = 3, c = 0;
  if (q < kIntChunks) {
    a = 0, c = q;
  } else if (q < 2 * kIntChunks) {
    a = 1, c = q - kIntChunks;
  } else if (q < 2 * kIntChunks + kByteChunks) {
    a = 2, c = q - 2 * kIntChunks;
  } else {
    c = q - 2 * kIntChunks - kByteChunks;
  }
  const int size = a < 2 ? 4 : 1;
  const unsigned char* src =
      a == 0   ? reinterpret_cast<const unsigned char*>(si + b0)
      : a == 1 ? reinterpret_cast<const unsigned char*>(sj + b0)
      : a == 2 ? sui + b0
               : suj + b0;
  const uint32_t at = (a == 0 ? 0 : a == 1 ? kJ : a == 2 ? kUi : kUj) + 16 * c;
  const long long row_bytes = B * size;
  const uintptr_t span = (uintptr_t)ncell * size;
  const bool copies = q < kSlots;
  const int ntiles = (T + TT - 1) / TT;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int s = tile % kStages;
    if (tile >= kStages) bar_wait(empty + 8 * s, (tile / kStages - 1) & 1);
    const int rows = min(TT, T - tile * TT);
    uint32_t dst = ring + s * TT * kRow + at;
    for (int r = 0; r < rows && copies; ++r, src += row_bytes, dst += kRow) {
      const uintptr_t chunk =
          ((uintptr_t)src & ~(uintptr_t)15) + 16 * (uintptr_t)c;
      if (chunk < (uintptr_t)src + span)
        cp_async16(dst, reinterpret_cast<const void*>(chunk));
    }
    cp_async_arrive(full + 8 * s);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float mean(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}
__device__ __forceinline__ float2 mean(float2 a, float2 b) {
  return make_float2(mean(a.x, b.x), mean(a.y, b.y));
}

// A lane's cell, its V channels of a row one value: a float (V == 1) or
// a float2 (V == 2), one load and one store a row.  Row e at sk[e * rs].
template <typename R>
struct VecCell {
  R* sk;
  int rs;
  __device__ __forceinline__ void update(int it, int jt, bool wi, bool wj) {
    R* pi = sk + it * rs;
    R* pj = sk + jt * rs;
    const R avg = mean(*pi, *pj);
    if (wj) *pj = avg;  // partner row first,
    if (wi) *pi = avg;  // then the initiator
  }
};

// Any V, channel by channel: channel v of row e at sk[e * rs + v * cs].
struct ScalarCell {
  float* sk;
  int rs, cs, V;
  __device__ __forceinline__ void update(int it, int jt, bool wi, bool wj) {
    float* pi = sk + it * rs;
    float* pj = sk + jt * rs;
    for (int v = 0; v < V; ++v) {
      const float avg = mean(pi[v * cs], pj[v * cs]);
      if (wj) pj[v * cs] = avg;
      if (wi) pi[v * cs] = avg;
    }
  }
};

// The consumer warp walks the ring, a lane a cell.  A tick updates
// without a branch, so that the warp never splits: a lane with no update
// reads row 0 and writes nothing.
template <typename Cell>
__device__ __forceinline__ void walk(Cell cell, bool live,
                                     const unsigned char* ring, uint32_t full,
                                     uint32_t empty, const int* si,
                                     const int* sj, const uint8_t* sui,
                                     const uint8_t* suj, int T, int TT, int B,
                                     int C, long long b0) {
  const int k = threadIdx.x;
  // a row's slice starts (base + size * (t * B + b0)) mod 16 bytes into
  // its first chunk
  const unsigned lo_i = (unsigned)(uintptr_t)si;
  const unsigned lo_j = (unsigned)(uintptr_t)sj;
  const unsigned lo_ui = (unsigned)(uintptr_t)sui;
  const unsigned lo_uj = (unsigned)(uintptr_t)suj;
  unsigned e = (unsigned)b0;  // entry (t, b0), mod 2^32
  const int ntiles = (T + TT - 1) / TT;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int s = tile % kStages;
    const int rows = min(TT, T - tile * TT);
    bar_wait(full + 8 * s, (tile / kStages) & 1);
    const unsigned char* rk = ring + s * TT * kRow + 4 * k;
    const unsigned char* rb = rk - 3 * k;
    // the next tick's entries, read before this tick's state update (the
    // ring and the state never overlap); past the tile's last row they
    // are read and dropped
    auto entries = [&](int& it, int& jt, int& ui, int& uj) {
      it = *reinterpret_cast<const int*>(rk + ((lo_i + 4 * e) & 15));
      jt = *reinterpret_cast<const int*>(rk + kJ + ((lo_j + 4 * e) & 15));
      ui = rb[kUi + ((lo_ui + e) & 15)];
      uj = rb[kUj + ((lo_uj + e) & 15)];
      rk += kRow;
      rb += kRow;
      e += (unsigned)B;
    };
    int it, jt, ui, uj;
    entries(it, jt, ui, uj);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      int nit, njt, nui, nuj;
      entries(nit, njt, nui, nuj);
      const bool ok =
          live && (unsigned)it < (unsigned)C && (unsigned)jt < (unsigned)C;
      cell.update(ok ? it : 0, ok ? jt : 0, ok && ui, ok && uj);
      it = nit;
      jt = njt;
      ui = nui;
      uj = nuj;
    }
    e -= (unsigned)B;  // the dropped read past the tile
    __syncwarp();
    if (k == 0) bar_arrive(empty + 8 * s);
  }
}

// kV is the channel count when the kernel keeps a row's channels as one
// value (1 or 2), else 0.
template <bool kSmemState, int kV>
__global__ void __launch_bounds__(64)
    pair_apply_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const int* __restrict__ si, const int* __restrict__ sj,
                      const uint8_t* __restrict__ sui,
                      const uint8_t* __restrict__ suj, int T, int B, int C,
                      int V_arg, int TT) {
  using R = typename std::conditional<kV == 2, float2, float>::type;
  constexpr int kW = kV ? kV : 1;  // floats a value
  extern __shared__ __align__(128) unsigned char smem[];
  const int V = kV ? kV : V_arg;
  const int n = C * V / kW;  // values a cell
  const long long b0 = (long long)blockIdx.x * kCells;
  const int ncell = (int)min((long long)kCells, (long long)B - b0);
  const uint32_t full = smem_u32(smem), empty = full + 8 * kStages;
  // the ring has one spare row, so a lane may read a row past a tile
  R* st = reinterpret_cast<R*>(smem + kBars + (kStages * TT + 1) * kRow);
  // The consumer lanes' first state loads go out before the producer's
  // copies, so that they do not queue behind them; the rest follow in
  // batches of eight, while the first tiles land.
  const int k = threadIdx.x;  // a consumer lane's cell
  const bool live = k < ncell;
  const R* xk = reinterpret_cast<const R*>(x) + (b0 + k) * n;
  constexpr int kFirst = 16 / kW;
  R first[kFirst];
#pragma unroll
  for (int f = 0; f < kFirst; ++f)
    if (live && f < n) first[f] = xk[f];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 32);
      bar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    produce(full + kBars, full, empty, si, sj, sui, suj, T, TT, B, b0, ncell);
    return;
  }

  // value f of the lane's cell at sk[f * fs]; a lane without a cell walks
  // cell 0's rows in device memory, or its own unused column of shared
  // memory, and writes nothing
  constexpr int fs = kSmemState ? kCells : 1;
  R* const sk = kSmemState ? st + k
                           : reinterpret_cast<R*>(out) + (b0 + (live ? k : 0)) * n;
  if (live) {
#pragma unroll
    for (int f = 0; f < kFirst; ++f)
      if (f < n) sk[f * fs] = first[f];
    for (int f0 = kFirst; f0 < n; f0 += 8) {
      R v[8];
#pragma unroll
      for (int f = 0; f < 8; ++f)
        if (f0 + f < n) v[f] = xk[f0 + f];
#pragma unroll
      for (int f = 0; f < 8; ++f)
        if (f0 + f < n) sk[(f0 + f) * fs] = v[f];
    }
  }
  const unsigned char* ring = smem + kBars;
  if (kV)
    walk(VecCell<R>{sk, fs}, live, ring, full, empty, si, sj, sui, suj, T,
         TT, B, C, b0);
  else
    walk(ScalarCell{reinterpret_cast<float*>(sk), V * fs, fs, V}, live, ring,
         full, empty, si, sj, sui, suj, T, TT, B, C, b0);
  if (kSmemState && live) {
    R* ok = reinterpret_cast<R*>(out) + (b0 + k) * n;
    for (int f = 0; f < n; ++f) ok[f] = sk[f * fs];
  }
}

template <bool kSmemState, int kV>
int launch(const float* x, float* out, const int* i, const int* j,
           const uint8_t* upd_i, const uint8_t* upd_j, int T, int B, int C,
           int V, int TT, cudaStream_t stream) {
  const size_t smem = kBars + (size_t)(kStages * TT + 1) * kRow +
                      (kSmemState ? (size_t)C * V * kCells * 4 : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_apply_kernel<kSmemState, kV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kCells - 1) / kCells;
  pair_apply_kernel<kSmemState, kV><<<blocks, 64, smem, stream>>>(
      x, out, i, j, upd_i, upd_j, T, B, C, V, TT);
  return (int)cudaGetLastError();
}

template <bool kSmemState>
int launch_v(const float* x, float* out, const int* i, const int* j,
             const uint8_t* upd_i, const uint8_t* upd_j, int T, int B, int C,
             int V, int TT, cudaStream_t stream) {
  // a row's two channels as one float2 needs x 8-byte aligned (out is a
  // fresh allocation)
  if (V == 1)
    return launch<kSmemState, 1>(x, out, i, j, upd_i, upd_j, T, B, C, V, TT,
                                 stream);
  if (V == 2 && ((uintptr_t)x & 7) == 0 && ((uintptr_t)out & 7) == 0)
    return launch<kSmemState, 2>(x, out, i, j, upd_i, upd_j, T, B, C, V, TT,
                                 stream);
  return launch<kSmemState, 0>(x, out, i, j, upd_i, upd_j, T, B, C, V, TT,
                               stream);
}

}  // namespace

// Launch on `stream` (64 threads a block: a consumer and a producer
// warp); returns cudaGetLastError() (0 on success).  `tile` is the ticks
// of one staged schedule tile; `use_smem` keeps the state in shared
// memory.
extern "C" int pair_apply_launch(const float* x, float* out, const int* i,
                                 const int* j, const uint8_t* upd_i,
                                 const uint8_t* upd_j, int T, int B, int C,
                                 int V, int tile, int use_smem, void* stream) {
  if (B == 0) return 0;
  if (tile < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return use_smem
             ? launch_v<true>(x, out, i, j, upd_i, upd_j, T, B, C, V, tile, s)
             : launch_v<false>(x, out, i, j, upd_i, upd_j, T, B, C, V, tile, s);
}
