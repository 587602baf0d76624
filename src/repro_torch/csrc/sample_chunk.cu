// sample_chunk: draw one gossip chunk's exchange schedule and count its
// messages, for R trials and B graphs, in one launch; under a failure
// scenario and a cost model, the same launch perturbs the schedule and
// counts the chunk's retransmissions and concurrency.
//
// Replaces no Pallas kernel: the reference draws a chunk in one jitted,
// vmapped XLA pass (`sample_schedule`, src/repro/core/schedule.py:204)
// and counts it in the same jitted chunk body (`_presampled_chunk`,
// src/repro/core/gossip.py:275-330).  Its plain version is
// `sample_chunk_ref` (kernels/sample_chunk/ref.py), which runs
// `core.schedule.sample_schedule` as eager torch ops, hundreds of
// launches a chunk; this kernel gives the same bits in one.
//
// For tick t = t0 .. t0+T-1, trial r and graph b it computes what
// `sample_tick` draws (src/repro_torch/core/schedule.py:154-195) and the
// chunk accounting of `gossip_core`:
//   i, j           (T, R*B) int32   waking node, contacted node
//   upd_i, upd_j   (T, R*B) uint8   0/1: initiator / partner row updates
//   usage[r*nflat + pos] += attempt (flat per-edge exchange counters)
//   msgs[r*B + b]        += attempt ? cost_t : 0
// Without a scenario attempt = active = valid & !done[r, b], cost_t =
// cost, upd_j = active & fwd_ok and upd_i = upd_j & rep_ok.  With one
// (gossip.py:287-310): a slot's flags are one byte of `fbits` (1
// churned, 2 straggler, 4 Byzantine, 8 regional); churned slots are
// down from tick `churn_tick`, regional ones during [reg_t0, reg_t1),
// both compared with the level's tick t0 + t; a down initiator never
// attempts, a down partner is not delivered and costs the forward leg
// only (cost_t = hops[pos]); an exchange touching a straggler is
// delivered only if its word of the straggler stream is below
// `strag_success`; a Byzantine slot never updates.
// Under a cost model (gossip.py:314-330):
//   retx[r*B + b] += sum over m < hops_t of floor(log u_m / log q)
//   conc[r*T + t] += attempt, and attempt (T, R*B) uint8 is written; the
//   wrapper forms the congestion pairs from these with tensor ops.
// Integer atomics are order-free, so every count stays exact.
//
// Bitwise points, each against src/repro_torch/core/prng.py:
// * Words are uint32; torch holds them in int64 masked to 32 bits, whose
//   add, xor, shift and mask give the same bits (prng.py:24-28).
// * fold_in(key, t) = threefry(key, (0, t)) (prng.py:101-108).
// * split(kt, 4) hashes the counters in halves, (0..3, 4..7), and reads
//   the 8 words as 4 key pairs: ki = (y1[0], y1[1]), kj = (y1[2], y1[3]),
//   kf = (y2[0], y2[1]), kr = (y2[2], y2[3]) (prng.py:78-87, 111-113).
// * A draw of S words hashes counter c with (c, c + half), half =
//   (S+1)/2: word c is y1, word c + half is y2.  For odd S the last
//   pair's second counter is 0, not 2*half - 1 (prng.py:82-84).  The
//   exchange draws are one draw of B words a (tick, trial) key; the two
//   tagged streams are one draw a (trial, chunk) over the flat (T, B)
//   straggler words and (T, B, 2*hop_cap) retransmission words, keyed
//   fold_in(fold_in(k_r, tag), t0).  So a tagged word pairs with a word
//   of another tick or graph: a thread hashes the counter of each tagged
//   word it needs and keeps that word's half.
// * uniform: the float with bits ((w >> 9) | 0x3F800000), minus 1,
//   clamped at 0 (prng.py:123-127).
// * i = min((int)(u * n_nodes), n_nodes - 1) and jidx = min((int)(v *
//   deg_i), max(deg_i - 1, 0)), each product one f32 rounding
//   (__fmul_rn: torch promotes the int32 operand to f32), the cast a
//   truncation (schedule.py:167-171).  A negative i (only for a graph of
//   0 nodes) indexes its row from the end, as torch indexing does.
// * Under loss: s = floor(logf(u) / logf(max(p, 1e-12))), one correctly
//   rounded division, compared as a float against hops; delivered sends
//   hops, else (int)(s + 1) (schedule.py:136-151).  A retransmission
//   word is floor(logf(max(u, 1e-12)) / log_q), log_q the f32 log of
//   f32(1 - retransmit_p) taken on the host (ref.py `log_q`).  Built
//   without --use_fast_math, logf and the division are the library's,
//   as in torch's own kernels.
//
// Shape of the work: draws are independent over ticks, trials and
// graphs.  The top level of a hierarchy has B = 1 and T = 64, so the
// grid covers (t, r, c) with c fastest, one thread per counter pair c,
// which hashes once per key for its two graphs c and c + half.  A block
// first computes the tick keys of the (t, r) pairs it covers into shared
// memory, four threads a pair, each one fold_in and one split hash, and
// each pair's two tagged stream keys.  A block sums its attempts a
// (t, r) pair in shared memory and adds each pair's sum to `conc` once.
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
constexpr uint32_t kTagRetx = 2147483640u;  // medium.py _TAG_RETX
constexpr uint32_t kTagStraggler = 2147483641u;
constexpr uint8_t kChurned = 1, kStraggler = 2, kByz = 4, kRegional = 8;

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

// Word w of a draw of `size` words under key k (prng.py `_halves_bits`):
// counter pair (c, c + half), the last pair of an odd draw (c, 0).
__device__ __forceinline__ uint32_t word(const uint32_t* k, long long w,
                                         long long size) {
  const long long half = (size + 1) / 2;
  uint32_t y1, y2;
  if (w < half) {
    const bool last = (size & 1) && w == half - 1;
    threefry(k[0], k[1], (uint32_t)w, last ? 0u : (uint32_t)(w + half), y1,
             y2);
    return y1;
  }
  threefry(k[0], k[1], (uint32_t)(w - half), (uint32_t)w, y1, y2);
  return y2;
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
  // scenario: fbits == nullptr runs none
  const uint8_t* fbits;  // (B, C) failure flags of each slot
  long long churn_tick, reg_t0, reg_t1;
  int strag;            // 1: draw the straggler stream
  float strag_success;  // straggler_success in f32
  // cost: retx == nullptr samples no retransmissions, conc == nullptr
  // tracks no congestion
  int* retx;          // (R*B,)
  int two_h;          // 2 * hop_cap retransmission words an exchange
  float log_q;        // log of f32(1 - retransmit_p)
  int* conc;          // (R*T,) attempts a tick of each trial
  uint8_t* out_att;   // (T, R*B) attempt
};

// One graph's tick from its four uniform words (kf/kr words unused
// without loss); `tk` holds the pair's straggler and retransmission
// stream keys.  Returns 1 when the exchange was attempted.
__device__ __forceinline__ int draw_one(const Args& a, float log_p, int tl,
                                        int r, int b, uint32_t wi, uint32_t wj,
                                        uint32_t wf, uint32_t wr,
                                        const uint32_t* tk) {
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
  const long long flat = (long long)tl * a.B + b;  // (t, b) in the streams
  const bool active = deg > 0 && !a.done[(long long)r * a.B + b];
  bool attempt = active, delivered = active, keep_i = true, keep_j = true;
  int cost_t = cost;
  if (a.fbits) {
    const uint8_t fi = a.fbits[row], fj = a.fbits[b * a.C + j];
    const long long when = a.t0 + tl;
    const bool churn_now = when >= a.churn_tick;
    const bool reg_now = when >= a.reg_t0 && when < a.reg_t1;
    const bool down_i = ((fi & kChurned) && churn_now) ||
                        ((fi & kRegional) && reg_now);
    const bool down_j = ((fj & kChurned) && churn_now) ||
                        ((fj & kRegional) && reg_now);
    attempt = active && !down_i;
    delivered = attempt && !down_j;
    if (a.strag && delivered && ((fi | fj) & kStraggler))
      delivered = uniform(word(tk, flat, (long long)a.T * a.B)) <
                  a.strag_success;
    keep_i = !(fi & kByz);
    keep_j = !(fj & kByz);
    cost_t = (attempt && !down_j) ? cost : h;
  }
  const bool upd_j = delivered && fwd_ok && keep_j;
  const bool upd_i = delivered && fwd_ok && rep_ok && keep_i;
  const long long o = ((long long)tl * a.R + r) * a.B + b;
  a.out_i[o] = i;
  a.out_j[o] = j;
  a.out_ui[o] = upd_i;
  a.out_uj[o] = upd_j;
  if (a.out_att) a.out_att[o] = attempt;
  if (!attempt) return 0;
  atomicAdd(a.usage + (long long)r * a.nflat + pos, 1);
  atomicAdd(a.msgs + (long long)r * a.B + b, cost_t);
  if (a.retx) {
    // extra attempts of each hop slot m < hops_t, one word each
    const long long size = (long long)a.T * a.B * a.two_h;
    const int hops_t = min(cost_t, a.two_h);
    int extra = 0;
    for (int m = 0; m < hops_t; ++m) {
      const float u = fmaxf(uniform(word(tk + 2, flat * a.two_h + m, size)),
                            1e-12f);
      extra += (int)floorf(__fdiv_rn(logf(u), a.log_q));
    }
    if (extra) atomicAdd(a.retx + (long long)r * a.B + b, extra);
  }
  return 1;
}

__global__ void __launch_bounds__(kThreads)
    sample_chunk_kernel(const Args a) {
  __shared__ uint32_t skey[kMaxPairs][8];
  __shared__ uint32_t stag[kMaxPairs][4];  // straggler key, retx key
  __shared__ int sconc[kMaxPairs];
  const long long half = a.half;
  const long long total = (long long)a.T * a.R * half;
  const long long g0 = (long long)blockIdx.x * kThreads;
  const long long g1 = min(total, g0 + kThreads) - 1;
  const long long p0 = g0 / half;  // (t, r) pair p = t * R + r
  const int npairs = (int)(g1 / half - p0 + 1);
  const bool tagged = a.strag || a.retx;

  // the tick keys: fold_in(key_r, t0 + t), then split's 4 hashes,
  // counters (q, q + 4) for q = 0..3; then the tagged streams' keys
  // fold_in(fold_in(key_r, tag), t0)
  const int nwork = (tagged ? 6 : 4) * npairs;
  for (int e = threadIdx.x; e < nwork; e += kThreads) {
    if (e < npairs) sconc[e] = 0;
    if (e < 4 * npairs) {
      const long long p = p0 + (e >> 2);
      const int q = e & 3;
      const int r = (int)(p % a.R);
      const uint32_t t = (uint32_t)(a.t0 + p / a.R);
      uint32_t kt1, kt2, y1, y2;
      threefry((uint32_t)a.keys[2 * r], (uint32_t)a.keys[2 * r + 1], 0u, t,
               kt1, kt2);
      threefry(kt1, kt2, (uint32_t)q, (uint32_t)(q + 4), y1, y2);
      skey[e >> 2][q] = y1;
      skey[e >> 2][4 + q] = y2;
    } else {
      const int e2 = e - 4 * npairs;
      const int which = e2 & 1;  // 0: straggler, 1: retransmissions
      const int r = (int)((p0 + (e2 >> 1)) % a.R);
      uint32_t k1, k2;
      threefry((uint32_t)a.keys[2 * r], (uint32_t)a.keys[2 * r + 1], 0u,
               which ? kTagRetx : kTagStraggler, k1, k2);
      threefry(k1, k2, 0u, (uint32_t)a.t0, stag[e2 >> 1][2 * which],
               stag[e2 >> 1][2 * which + 1]);
    }
  }
  __syncthreads();

  const long long g = g0 + threadIdx.x;
  if (g <= g1) {
    const long long p = g / half;
    const uint32_t c = (uint32_t)(g - p * half);
    const int tl = (int)(p / a.R);
    const int r = (int)(p - (long long)tl * a.R);
    const uint32_t* k = skey[p - p0];
    // counter pair (c, c + half); the odd draw's last pair is (c, 0)
    const uint32_t x2 = ((a.B & 1) && c == (uint32_t)half - 1)
                            ? 0u
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
    const uint32_t* tk = stag[p - p0];
    int att = draw_one(a, log_p, tl, r, (int)c, wi0, wj0, wf0, wr0, tk);
    const long long b1 = (long long)c + half;
    if (b1 < a.B)
      att += draw_one(a, log_p, tl, r, (int)b1, wi1, wj1, wf1, wr1, tk);
    if (a.conc && att) atomicAdd(sconc + (p - p0), att);
  }
  if (a.conc) {  // uniform over the block
    __syncthreads();
    for (int e = threadIdx.x; e < npairs; e += kThreads) {
      if (!sconc[e]) continue;
      const long long p = p0 + e;
      const int tl = (int)(p / a.R);
      const int r = (int)(p - (long long)tl * a.R);
      atomicAdd(a.conc + (long long)r * a.T + tl, sconc[e]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `lossy` is 0 without loss or for loss_p >= 1 (every hop delivered:
// the same outputs as no loss), else 1 with p = loss_p in f32.  `fbits`
// null runs no scenario; `strag` draws the straggler stream.  `retx`
// null samples no retransmissions; `conc` and `out_att` null track no
// congestion (conc must be zeroed by the caller).
extern "C" int sample_chunk_launch(
    const long long* keys, const int* start, const int* nbr, const int* hops,
    const int* degrees, const int* n_nodes, const uint8_t* done, int* out_i,
    int* out_j, uint8_t* out_ui, uint8_t* out_uj, int* usage, int* msgs,
    long long t0, int T, int R, int B, int C, int nflat, int lossy, float p,
    const uint8_t* fbits, long long churn_tick, long long reg_t0,
    long long reg_t1, int strag, float strag_success, int* retx, int two_h,
    float log_q, int* conc, uint8_t* out_att, void* stream) {
  if (T == 0 || R == 0 || B == 0) return 0;
  Args a{keys,   start,   nbr,    hops,       degrees, n_nodes, done,
         out_i,  out_j,   out_ui, out_uj,     usage,   msgs,    t0,
         T,      R,       B,      C,          nflat,   (B + 1) / 2,
         lossy,  p,       fbits,  churn_tick, reg_t0,  reg_t1,  strag,
         strag_success,   retx,   two_h,      log_q,   conc,    out_att};
  const long long total = (long long)T * R * a.half;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // the tagged streams' counters are uint32
  if ((strag || retx) && (long long)T * B * (retx ? two_h : 1) >= 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  sample_chunk_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
