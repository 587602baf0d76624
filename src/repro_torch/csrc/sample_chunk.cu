// sample_chunk: draw one gossip chunk's exchange schedule and count its
// messages, for R trials and B graphs, in one launch.
//
// Replaces no Pallas kernel: the reference draws a chunk in one jitted,
// vmapped XLA pass (`sample_schedule`, src/repro/core/schedule.py:204)
// and counts it in the same jitted chunk body (`_presampled_chunk`,
// src/repro/core/gossip.py:275-313, the `failure_ctx is None` branch).
// Its plain version is `sample_chunk_ref` (kernels/sample_chunk/ref.py),
// which runs `core.schedule.sample_schedule` as eager torch ops,
// hundreds of launches a chunk; this kernel gives the same bits in one.
//
// For tick t = t0 .. t0+T-1, trial r and graph b it computes what
// `sample_tick` draws (src/repro_torch/core/schedule.py:154-195) and the
// chunk accounting of `gossip_core`:
//   i, j           (T, R*B) int32   waking node, contacted node
//   upd_i, upd_j   (T, R*B) uint8   0/1: initiator / partner row updates
//   usage[r*nflat + pos] += active  (flat per-edge exchange counters)
//   msgs[r*B + b]        += active ? cost : 0
// with active = valid & !done[r, b], upd_j = active & fwd_ok and
// upd_i = upd_j & rep_ok.  Integer atomics are order-free, so usage and
// msgs stay exact.
//
// Bitwise points, each against src/repro_torch/core/prng.py:
// * Words are uint32; torch holds them in int64 masked to 32 bits, whose
//   add, xor, shift and mask give the same bits (prng.py:24-28).
// * fold_in(key, t) = threefry(key, (0, t)) (prng.py:101-108).
// * split(kt, 4) hashes the counters in halves, (0..3, 4..7), and reads
//   the 8 words as 4 key pairs: ki = (y1[0], y1[1]), kj = (y1[2], y1[3]),
//   kf = (y2[0], y2[1]), kr = (y2[2], y2[3]) (prng.py:78-87, 111-113).
// * A draw of B words hashes counter c with (c, c + half), half =
//   (B+1)/2: word c is y1, word c + half is y2.  For odd B the last
//   pair's second counter is 0, not 2*half - 1 (prng.py:82-84).
// * uniform: the float with bits ((w >> 9) | 0x3F800000), minus 1,
//   clamped at 0 (prng.py:123-127).
// * i = min((int)(u * n_nodes), n_nodes - 1) and jidx = min((int)(v *
//   deg_i), max(deg_i - 1, 0)), each product one f32 rounding
//   (__fmul_rn: torch promotes the int32 operand to f32), the cast a
//   truncation (schedule.py:167-171).  A negative i (only for a graph of
//   0 nodes) indexes its row from the end, as torch indexing does.
// * Under loss: s = floor(logf(u) / logf(max(p, 1e-12))), one correctly
//   rounded division, compared as a float against hops; delivered sends
//   hops, else (int)(s + 1) (schedule.py:136-151).  Built without
//   --use_fast_math, logf and the division are the library's, as in
//   torch's own kernels.
//
// Shape of the work: draws are independent over ticks, trials and
// graphs.  The top level of a hierarchy has B = 1 and T = 64, so the
// grid covers (t, r, c) with c fastest, one thread per counter pair c,
// which hashes once per key for its two graphs c and c + half.  A block
// first computes the tick keys of the (t, r) pairs it covers into shared
// memory, four threads a pair, each one fold_in and one split hash.
//
// What bounds it on an H100: the integer work of the hash (20 rounds of
// add, rotate, xor; 72 operations a hash) against the int32 lanes, and
// the bytes of the schedule it writes (10 a draw).  chip_smoke.py takes
// the larger of the two.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// (t, r) pairs a block of kThreads counters can touch: kThreads when
// half == 1, at most kThreads / half + 2 otherwise
constexpr int kMaxPairs = kThreads + 1;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The 20-round threefry-2x32 hash of (x1, x2) under key (k1, k2)
// (prng.py:54-69).
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t x1,
                                         uint32_t x2, uint32_t& y1,
                                         uint32_t& y2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += k1;
  x2 += k2;
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x1 += x2;
      x2 = rotl(x2, rot[block % 2][q]) ^ x1;
    }
    x1 += ks[(block + 1) % 3];
    x2 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  y1 = x1;
  y2 = x2;
}

__device__ __forceinline__ float uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf(__fsub_rn(f, 1.0f), 0.0f);
}

// truncated_failure_hops (schedule.py:136-151) for one message over h hops
__device__ __forceinline__ void lost_hops(float u, float log_p, int h,
                                          bool& ok, int& sent) {
  const float s = floorf(__fdiv_rn(logf(u), log_p));
  ok = s >= (float)h;
  sent = ok ? h : (int)__fadd_rn(s, 1.0f);
}

struct Args {
  const long long* keys;  // (R, 2) level keys, words in [0, 2^32)
  const int* start;       // (B, C)
  const int* nbr;         // (nflat,)
  const int* hops;        // (nflat,)
  const int* degrees;     // (B, C)
  const int* n_nodes;     // (B,)
  const uint8_t* done;    // (R, B)
  int* out_i;             // (T, R*B)
  int* out_j;
  uint8_t* out_ui;
  uint8_t* out_uj;
  int* usage;  // (R*nflat,)
  int* msgs;   // (R*B,)
  long long t0;
  int T, R, B, C, nflat, half, lossy;
  float p;  // loss_p in f32
};

// One graph's tick from its four uniform words (kf/kr words unused
// without loss).
__device__ __forceinline__ void draw_one(const Args& a, float log_p, int tl,
                                         int r, int b, uint32_t wi, uint32_t wj,
                                         uint32_t wf, uint32_t wr) {
  const int n = a.n_nodes[b];
  int i = min((int)__fmul_rn(uniform(wi), (float)n), n - 1);
  const int row = b * a.C + (i < 0 ? i + a.C : i);
  const int deg = a.degrees[row];
  const int jidx = min((int)__fmul_rn(uniform(wj), (float)deg), max(deg - 1, 0));
  const int pos = a.start[row] + jidx;
  const int j = a.nbr[pos];
  const int h = a.hops[pos];
  bool fwd_ok = true, rep_ok = true;
  int cost = 2 * h;
  if (a.lossy) {
    int fwd_sent, rep_sent;
    lost_hops(uniform(wf), log_p, h, fwd_ok, fwd_sent);
    lost_hops(uniform(wr), log_p, h, rep_ok, rep_sent);
    cost = fwd_sent + (fwd_ok ? rep_sent : 0);
  }
  const bool active = deg > 0 && !a.done[(long long)r * a.B + b];
  const bool upd_j = active && fwd_ok;
  const bool upd_i = upd_j && rep_ok;
  const long long o = ((long long)tl * a.R + r) * a.B + b;
  a.out_i[o] = i;
  a.out_j[o] = j;
  a.out_ui[o] = upd_i;
  a.out_uj[o] = upd_j;
  if (active) {
    atomicAdd(a.usage + (long long)r * a.nflat + pos, 1);
    atomicAdd(a.msgs + (long long)r * a.B + b, cost);
  }
}

__global__ void __launch_bounds__(kThreads)
    sample_chunk_kernel(const Args a) {
  __shared__ uint32_t skey[kMaxPairs][8];
  const long long half = a.half;
  const long long total = (long long)a.T * a.R * half;
  const long long g0 = (long long)blockIdx.x * kThreads;
  const long long g1 = min(total, g0 + kThreads) - 1;
  const long long p0 = g0 / half;  // (t, r) pair p = t * R + r
  const int npairs = (int)(g1 / half - p0 + 1);

  // the tick keys: fold_in(key_r, t0 + t), then split's 4 hashes,
  // counters (q, q + 4) for q = 0..3
  for (int e = threadIdx.x; e < 4 * npairs; e += kThreads) {
    const long long p = p0 + (e >> 2);
    const int q = e & 3;
    const int r = (int)(p % a.R);
    const uint32_t t = (uint32_t)(a.t0 + p / a.R);
    uint32_t kt1, kt2, y1, y2;
    threefry((uint32_t)a.keys[2 * r], (uint32_t)a.keys[2 * r + 1], 0u, t, kt1,
             kt2);
    threefry(kt1, kt2, (uint32_t)q, (uint32_t)(q + 4), y1, y2);
    skey[e >> 2][q] = y1;
    skey[e >> 2][4 + q] = y2;
  }
  __syncthreads();

  const long long g = g0 + threadIdx.x;
  if (g > g1) return;
  const long long p = g / half;
  const uint32_t c = (uint32_t)(g - p * half);
  const int tl = (int)(p / a.R);
  const int r = (int)(p - (long long)tl * a.R);
  const uint32_t* k = skey[p - p0];
  // counter pair (c, c + half); the odd draw's last pair is (c, 0)
  const uint32_t x2 = ((a.B & 1) && c == (uint32_t)half - 1) ? 0u
                                                             : c + (uint32_t)half;
  uint32_t wi0, wi1, wj0, wj1, wf0 = 0, wf1 = 0, wr0 = 0, wr1 = 0;
  threefry(k[0], k[1], c, x2, wi0, wi1);
  threefry(k[2], k[3], c, x2, wj0, wj1);
  float log_p = 0.0f;
  if (a.lossy) {
    threefry(k[4], k[5], c, x2, wf0, wf1);
    threefry(k[6], k[7], c, x2, wr0, wr1);
    // on the device, as torch takes log(clamp_min(p, 1e-12)) there
    log_p = logf(fmaxf(a.p, 1e-12f));
  }
  draw_one(a, log_p, tl, r, (int)c, wi0, wj0, wf0, wr0);
  const long long b1 = (long long)c + half;
  if (b1 < a.B) draw_one(a, log_p, tl, r, (int)b1, wi1, wj1, wf1, wr1);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `lossy` is 0 without loss or for loss_p >= 1 (every hop delivered:
// the same outputs as no loss), else 1 with p = loss_p in f32.
extern "C" int sample_chunk_launch(
    const long long* keys, const int* start, const int* nbr, const int* hops,
    const int* degrees, const int* n_nodes, const uint8_t* done, int* out_i,
    int* out_j, uint8_t* out_ui, uint8_t* out_uj, int* usage, int* msgs,
    long long t0, int T, int R, int B, int C, int nflat, int lossy, float p,
    void* stream) {
  if (T == 0 || R == 0 || B == 0) return 0;
  Args a{keys, start, nbr, hops, degrees, n_nodes, done, out_i, out_j, out_ui,
         out_uj, usage, msgs, t0, T, R, B, C, nflat, (B + 1) / 2, lossy, p};
  const long long total = (long long)T * R * a.half;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  sample_chunk_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
