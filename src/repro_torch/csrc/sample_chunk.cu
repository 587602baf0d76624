// sample_chunk: draw one gossip chunk's exchange schedule and count its
// messages, for R trials and B graphs, in one launch; under a failure
// scenario and a cost model, the same launch perturbs the schedule and
// counts the chunk's retransmissions and concurrency, and a second small
// kernel forms its congestion pairs.
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
//   conc[r*T + t] += attempt, and the attempt bits are written packed,
//   a word for each graph and each half of a tile of tick slots;
//   congp[r*B + b] += f32(sum over t of attempt * max(conc[r, t] - 1, 0))
//   by the second kernel, the int32 sum rounded once, as the plain
//   version sums in int32 and adds in f32.
// Integer sums are order-free, so every count stays exact.
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
//   exchange draws are one draw of B words a (tick, trial) key, so graphs
//   c and c + half share a hash.  The two tagged streams are one draw a
//   (trial, chunk) over the flat (T, B) straggler words and (T, B,
//   2*hop_cap) retransmission words, keyed fold_in(fold_in(k_r, tag),
//   t0).  At even T both sizes are even and half is T/2 ticks' worth of
//   words, so word (t, b[, m]) pairs with (t + T/2, b[, m]).
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
// Shape of the work.  A block owns one trial r and a run of G counter
// pairs c0 .. c0+G-1, that is graphs [c0, c0+G) and [c0+half,
// c0+G+half), for all T ticks of the chunk.  A slot s holds ticks s and
// s + span, span = ceil(T/2): at even T the tick whose tagged words share
// a hash with tick s.  The block hashes the keys of a tile of up to 32
// slots once into shared memory (one fold_in and split's four hashes a
// tick).  An item is one slot of one pair: both ticks of both graphs,
// its four exchange hashes in lockstep, then its gathers, the scenario,
// the tagged words (each counter hashed once for both ticks at even T),
// the stores and the counts.  The host picks the shape (`launch_shape`,
// kernels/sample_chunk/ops.py): as many blocks as the card has SMs, or
// a multiple, so every SM draws as many pairs.  One template serves
// every mode, in three instances:
// * the main path (no loss, scenario or cost model): thread (lane, p)
//   draws slots lane, lane + lanes, ... of pair p, its pair and its
//   message sums in registers to the end; lanes are as few as the
//   block's turns need, so they differ by one turn at most.  Its two
//   update bits are equal, and it writes only upd_i, which the op
//   returns for both;
// * every mode but loss, and every mode: a draw there needs more
//   registers than a pair kept for the whole chunk leaves (at 832
//   threads it spilled and ran slower), so the threads take the tile's
//   (slot, pair) items in turn, pairs fastest, every thread as many,
//   and add each item's sums to the block's in shared memory.  The loss
//   code has its own instance: the scenario op runs faster without its
//   registers.  The last instance takes 64-bit offsets, for T*R*B past
//   2^31.
// Because a block alone owns its (r, b), its messages and retransmissions
// are added to device memory once, with a plain read-add-write of the
// counts it read when it started.  Usage goes to a shared histogram over
// each run's window of edges [start[first, 0], start[end, 0]) (the plan's
// CSR lays a graph's edges out in one run), flushed by one atomicAdd a
// counter touched: another block may reach the same counter under
// another layout.  A position outside the window (a CSR whose graphs
// are not in order, a run with more edges than the host allotted, or a
// grid too small to fill the card, where the host allots none) takes a
// device atomic in the same pass, so any layout is counted right.  Under
// congestion pricing each graph's attempt bits of a tile are one word a
// half of the tile, ORed in shared memory, counted by column (a lane a
// tick, each warp a share of the words) into the attempts a tick, added
// to `conc` once a block, and
// written for the congestion kernel, which stages each trial's weights
// max(conc - 1, 0) in shared memory.
//
// What bounds it on an H100: the integer work of the hash (20 rounds of
// add, rotate, xor; 72 operations a hash) against the int32 lanes, and
// the bytes of the schedule it writes (10 a draw); chip_smoke.py takes
// the larger of the two.  On the card (PERF.md, PR 21) the main path
// runs about 480 integer instructions an item, 288 of them its four
// hashes, and its stores cost a fifth of its time; so the kernel spends
// none it can avoid: no division or device atomic a draw, no tagged hash
// twice, one update-bit tensor on the main path; the retransmission
// count is estimated from the special function unit's log2, without a
// branch a word, and computed exactly (logf, a correctly rounded
// division) only for the rare word near an integer, after the item's
// estimates (`retries_estimate`, `retries_exact`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// threads a block at most: the main path's instance, the others' (more
// registers a thread: their draw keeps more in flight)
constexpr int kMaxThreads = 1024;
constexpr int kFullThreads = 640;
constexpr int kMaxPairs = 512;    // counter pairs a block at most
constexpr int kTileSlots = 32;    // tick slots a block holds keys for
constexpr int kMaxWindow = 8192;  // usage counters of a graph run on chip
constexpr int kMaxDevices = 64;
constexpr uint32_t kTagRetx = 2147483640u;  // medium.py _TAG_RETX
constexpr uint32_t kTagStraggler = 2147483641u;
constexpr uint8_t kChurned = 1, kStraggler = 2, kByz = 4, kRegional = 8;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The 20-round threefry-2x32 hash of (x1, x2) under key (k1, k2)
// (prng.py:54-69), N hashes in lockstep: their chains of dependent
// adds, rotates and xors interleave.
template <int N>
__device__ __forceinline__ void threefry_n(const uint32_t* k1,
                                           const uint32_t* k2, uint32_t* x1,
                                           uint32_t* x2) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t ks[N][3];
#pragma unroll
  for (int h = 0; h < N; ++h) {
    ks[h][0] = k1[h];
    ks[h][1] = k2[h];
    ks[h][2] = k1[h] ^ k2[h] ^ 0x1BD11BDAu;
    x1[h] += k1[h];
    x2[h] += k2[h];
  }
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < N; ++h) {
        x1[h] += x2[h];
        x2[h] = rotl(x2[h], rot[block % 2][q]) ^ x1[h];
      }
#pragma unroll
    for (int h = 0; h < N; ++h) {
      x1[h] += ks[h][(block + 1) % 3];
      x2[h] += ks[h][(block + 2) % 3] + (uint32_t)(block + 1);
    }
  }
}

__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t x1,
                                         uint32_t x2, uint32_t& y1,
                                         uint32_t& y2) {
  threefry_n<1>(&k1, &k2, &x1, &x2);
  y1 = x1;
  y2 = x2;
}

// f is in [1, 2), so f - 1 is exact and at least +0: prng.py's clamp at
// 0 never binds
__device__ __forceinline__ float uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  return __fsub_rn(f, 1.0f);
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

// extra attempts of one hop slot from its retransmission word:
// floor(logf(u) / log_q), u = max(uniform(w), 1e-12).  The integer is
// first estimated as x' = log2(u) * (ln 2 / log_q) from the special
// function unit (scale = ln 2 / log_q; u is a normal float, so the log2
// needs no denormal scaling); only where x' lies within 2e-5 (|x'| + 1) +
// 2e-6 |scale| of an integer (`near`) is the exact quotient (the
// library's logf, a correctly rounded division) taken.  x' and the exact
// quotient differ by less than 7e-7 |x'| (log2's 2 ulps, logf's 1, three
// roundings) plus 2^-22.6 |scale| (log2's absolute error on [0.5, 2]),
// at least 8 times inside that margin.  Either way the count is the
// exact quotient's floor.  `inner` is 0.5 - 2e-5 - 2e-6 |scale|: x' is
// near an integer where its fraction lies within the margin of 0 or 1.
__device__ __forceinline__ int retries_estimate(uint32_t w, float scale,
                                                float inner, bool& near) {
  const float u = fmaxf(uniform(w), 1e-12f);
  float l2;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l2) : "f"(u));
  const float x = l2 * scale;
  const float k = floorf(x);
  near = fabsf(x - k - 0.5f) >= fmaf(-2e-5f, fabsf(x), inner);
  return (int)k;
}

__device__ __noinline__ int retries_exact(uint32_t w, float log_q) {
  const float u = fmaxf(uniform(w), 1e-12f);
  return (int)floorf(__fdiv_rn(logf(u), log_q));
}

__device__ __forceinline__ int retries(uint32_t w, float log_q, float scale,
                                       float inner) {
  bool near;
  const int k = retries_estimate(w, scale, inner, near);
  return near ? retries_exact(w, log_q) : k;
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
  int T, R, B, C, nflat, lossy;
  float p;  // loss_p in f32
  // scenario: fbits == nullptr runs none
  const uint8_t* fbits;  // (B, C) failure flags of each slot
  long long churn_tick, reg_t0, reg_t1;
  int strag;            // 1: draw the straggler stream
  float strag_success;  // straggler_success in f32
  // cost: retx == nullptr samples no retransmissions, conc == nullptr
  // tracks no congestion
  int* retx;           // (R*B,)
  int two_h;           // 2 * hop_cap retransmission words an exchange
  float log_q;         // log of f32(1 - retransmit_p)
  int* conc;           // (R*T,) attempts a tick of each trial
  uint32_t* out_att;   // (2 * tiles, R*B) attempt bits, one word a graph
                       // for each half of each tile of slots
  // the shape: half = ceil(B/2) counter pairs, span = ceil(T/2) slots;
  // G pairs a block, `lanes` threads a pair, runs blocks a trial, window
  // usage counters of each graph run kept on chip
  int half, span, G, lanes, runs, window;
};

// What shared memory holds.  kFull: the other modes' keys, tick flags,
// retransmission sums, attempt bits and counts a tick.
template <bool kFull>
struct Shared {
  uint32_t key[2 * kTileSlots][kFull ? 8 : 4];  // split(fold_in(k_r, t))
  uint8_t now[2 * kTileSlots];  // 1: churned slots down, 2: regional ones
  int conc[2 * kTileSlots];     // attempts of each tick of the tile
  uint32_t tag[4];              // straggler key, retransmission key
  // of graphs c and c + half: n | done << 31, then the row of i = 0
  // (a graph of 0 nodes: C, so that i = -1 reads its last slot)
  uint4 info[kMaxPairs];
  int sum[kFull ? 4 : 2][kMaxPairs];        // msgs of graph k, then retx
  uint32_t att[kFull ? 4 : 1][kMaxPairs];   // attempt bits, graph k, half
  int win[2][2];                            // each run's window: lo, size
};

// What a block keeps in registers.
struct Run {
  int r, c0, np;       // trial, first counter pair, pairs
  int* usage_r;        // usage counters of trial r
  int* hist;           // window k's counts at hist + k * window
  int lo[2], size[2];  // each run's window
  float log_p, scale;  // log of the loss p; ln 2 / log_q
  float inner;         // `retries_estimate`'s bound on a fraction
};

// A counter pair p of the block's run: graphs c and c + half.
struct Pair {
  int c, b[2];          // graphs (a missing second graph: the first)
  bool has2;            // the odd draw's last pair has one graph
  uint32_t x2;          // the exchange draws' second counter
  uint32_t nfo[2];      // n | done << 31
  int row0[2];          // row of i = 0 (a graph of 0 nodes: C)
};

// What a thread sums (over its ticks on the main path, over an item in
// the other modes): messages and retransmissions of each graph, and its
// attempt bits of the tile (graph k, half u).
struct Sums {
  int msgs[2], retx[2];
  uint32_t att[2][2];
};

// Count one attempted exchange of graph k at edge `pos` into its run's
// window, or into device memory outside it.
__device__ __forceinline__ void count_edge(const Args& a, const Run& run,
                                           int k, int pos) {
  const int off = pos - run.lo[k];
  if ((unsigned)off < (unsigned)run.size[k])
    atomicAdd(run.hist + k * a.window + off, 1);
  else
    atomicAdd(run.usage_r + pos, 1);
}

// One exchange's outcome under loss and a scenario (gossip.py:287-310,
// schedule.py:136-151), up to the straggler's word; fi, fj: the flags of
// its nodes' slots.  cost: the transmissions charged (cost_t); ui, uj:
// the update bits if delivered.
struct Fate {
  int cost;
  bool attempt, delivered, slow, ui, uj;
};

// kMode 0: the main path (no loss, scenario or cost model); 1: every
// mode but loss, each as `a` says; 2: every mode.
template <int kMode>
__device__ __forceinline__ Fate fate(const Args& a, const Run& run,
                                     bool valid, int h, uint32_t wf,
                                     uint32_t wr, uint8_t fi, uint8_t fj,
                                     uint8_t now) {
  Fate f{2 * h, valid, valid, false, true, true};
  if (kMode == 0) return f;
  bool fwd_ok = true, rep_ok = true;
  if (kMode == 2 && a.lossy) {
    int fwd_sent, rep_sent;
    lost_hops(uniform(wf), run.log_p, h, fwd_ok, fwd_sent);
    lost_hops(uniform(wr), run.log_p, h, rep_ok, rep_sent);
    f.cost = fwd_sent + (fwd_ok ? rep_sent : 0);
  }
  bool keep_i = true, keep_j = true;
  if (a.fbits) {
    const bool churn_now = now & 1, reg_now = now & 2;
    const bool down_i = ((fi & kChurned) && churn_now) ||
                        ((fi & kRegional) && reg_now);
    const bool down_j = ((fj & kChurned) && churn_now) ||
                        ((fj & kRegional) && reg_now);
    f.attempt = valid && !down_i;
    f.delivered = f.attempt && !down_j;
    f.slow = a.strag && f.delivered && ((fi | fj) & kStraggler);
    keep_i = !(fi & kByz);
    keep_j = !(fj & kByz);
    if (!f.delivered) f.cost = h;
  }
  f.uj = fwd_ok && keep_j;
  f.ui = fwd_ok && rep_ok && keep_i;
  return f;
}

// Slot s of the tile at s0 for pair pr: ticks s0 + s and s0 + s + span
// of graphs c and c + half, summed into `sum`.  Each value is stored or
// folded as soon as it is drawn, so few stay in registers.
template <int kMode, typename Off>
__device__ __forceinline__ void draw_item(const Args& a, const Run& run,
                                          Shared<(kMode > 0)>& sh,
                                          const Pair& pr, int s0, int ns,
                                          int s, Sums& sum) {
  constexpr bool kFull = kMode > 0;
  const int B = a.B, c = pr.c;
  const bool has2 = pr.has2;
  const int* b = pr.b;
  const uint32_t x2 = pr.x2;
  const uint32_t* nfo = pr.nfo;
  const int* row0 = pr.row0;
  const int e[2] = {s, s + ns};  // the ticks' keys
  const int t[2] = {s0 + s, s0 + s + a.span};
  const bool two = t[1] < a.T;
  bool put[2][2];  // (u, k) exists: tick u drawn, graph k real
  Off o[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      put[u][k] = (u == 0 || two) && (k == 0 || has2);
      o[u][k] = ((Off)t[u] * a.R + run.r) * B + b[k];
    }
  // the i and j words of both ticks in lockstep; w1 graph c, w2 graph
  // c + half; then the f and r words under loss
  uint32_t w1[4], w2[4], v1[4] = {0u, 0u, 0u, 0u}, v2[4] = {0u, 0u, 0u, 0u};
  {
    uint32_t q1[4], q2[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      q1[h] = sh.key[e[h / 2]][2 * (h % 2)];
      q2[h] = sh.key[e[h / 2]][2 * (h % 2) + 1];
      w1[h] = (uint32_t)c;
      w2[h] = x2;
    }
    threefry_n<4>(q1, q2, w1, w2);
    if (kMode == 2 && a.lossy) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        q1[h] = sh.key[e[h / 2]][(kFull ? 4 : 0) + 2 * (h % 2)];
        q2[h] = sh.key[e[h / 2]][(kFull ? 5 : 1) + 2 * (h % 2)];
        v1[h] = (uint32_t)c;
        v2[h] = x2;
      }
      threefry_n<4>(q1, q2, v1, v2);
    }
  }
  int deg[2][2], pos[2][2], hp[2][2];
  uint8_t fi[2][2] = {{0, 0}, {0, 0}}, fj[2][2] = {{0, 0}, {0, 0}};
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int n = (int)(nfo[k] & 0x7FFFFFFFu);
      const uint32_t wi = k ? w2[2 * u] : w1[2 * u];
      const int i = min((int)__fmul_rn(uniform(wi), (float)n), n - 1);
      const int row = row0[k] + i;
      if (put[u][k]) a.out_i[o[u][k]] = i;
      deg[u][k] = __ldg(a.degrees + row);
      pos[u][k] = __ldg(a.start + row);
      if (kFull && a.fbits) fi[u][k] = a.fbits[row];
    }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t wj = k ? w2[2 * u + 1] : w1[2 * u + 1];
      pos[u][k] += min((int)__fmul_rn(uniform(wj), (float)deg[u][k]),
                       max(deg[u][k] - 1, 0));
      const int j = __ldg(a.nbr + pos[u][k]);
      hp[u][k] = __ldg(a.hops + pos[u][k]);
      if (put[u][k]) a.out_j[o[u][k]] = j;
      if (kFull && a.fbits) fj[u][k] = a.fbits[b[k] * a.C + j];
    }
  Fate f[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      f[u][k] = fate<kMode>(a, run, deg[u][k] > 0 && !(nfo[k] >> 31),
                            hp[u][k], k ? v2[2 * u] : v1[2 * u],
                            k ? v2[2 * u + 1] : v1[2 * u + 1], fi[u][k],
                            fj[u][k], kFull ? sh.now[e[u]] : 0);
  const bool even = (a.T & 1) == 0;
  const unsigned TB = (unsigned)a.T * (unsigned)B;
  if (kFull && a.strag) {
    // word (t, b) of the straggler stream; at even T it pairs with
    // (t + T/2, b): one hash for both ticks
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool slow0 = f[0][k].slow, slow1 = two && f[1][k].slow;
      if (!(slow0 || slow1)) continue;
      const unsigned flat = (unsigned)t[0] * B + b[k];
      uint32_t y1, y2;
      if (even) {
        threefry(sh.tag[0], sh.tag[1], flat, flat + TB / 2, y1, y2);
      } else {
        y1 = slow0 ? word(sh.tag, flat, TB) : 0u;
        y2 = slow1 ? word(sh.tag, (unsigned)t[1] * B + b[k], TB) : 0u;
      }
      if (slow0) f[0][k].delivered = uniform(y1) < a.strag_success;
      if (slow1) f[1][k].delivered = uniform(y2) < a.strag_success;
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!put[u][k]) continue;
      const Fate& d = f[u][k];
      a.out_ui[o[u][k]] = d.delivered && d.ui;
      // on the main path upd_j is upd_i: the op returns one tensor for both
      if (kFull) a.out_uj[o[u][k]] = d.delivered && d.uj;
      if (!d.attempt) continue;
      sum.msgs[k] += d.cost;
      count_edge(a, run, k, pos[u][k]);
      if (kFull) sum.att[k][u] |= 1u << s;
    }
  if (kFull && a.retx) {
    // extra attempts of each hop slot m < hops_t, one word each
    int hs[2][2];
    int* rx = sum.retx;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        hs[u][k] = put[u][k] && f[u][k].attempt
                       ? min(f[u][k].cost, a.two_h)
                       : 0;
    if (even) {
      // word (t, b, m) pairs with (t + T/2, b, m): a counter serves both
      // ticks, two hop slots of each graph hashed in lockstep
      const unsigned size2 = TB * (unsigned)a.two_h / 2;
      const unsigned base[2] = {((unsigned)t[0] * B + b[0]) * a.two_h,
                                ((unsigned)t[0] * B + b[1]) * a.two_h};
      const int top = max(max(hs[0][0], hs[1][0]), max(hs[0][1], hs[1][1]));
      for (int m = 0; m < top; m += 2) {
        uint32_t q1[4], q2[4], y1[4], y2[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          q1[q] = sh.tag[2];
          q2[q] = sh.tag[3];
          y1[q] = base[q >> 1] + m + (q & 1);
          y2[q] = y1[q] + size2;
        }
        threefry_n<4>(q1, q2, y1, y2);
        // the eight estimates without a branch; bit 2q + v of `near`: word
        // v of hash q is counted and lies near an integer
        uint32_t near = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = q >> 1, mm = m + (q & 1);
          bool n1, n2;
          const int e1 = retries_estimate(y1[q], run.scale, run.inner, n1);
          const int e2 = retries_estimate(y2[q], run.scale, run.inner, n2);
          const bool g1 = mm < hs[0][k], g2 = mm < hs[1][k];
          rx[k] += (g1 ? e1 : 0) + (g2 ? e2 : 0);
          near |= ((g1 && n1) ? 1u : 0u) << (2 * q);
          near |= ((g2 && n2) ? 2u : 0u) << (2 * q);
        }
        if (near) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              if (!((near >> (2 * q + v)) & 1u)) continue;
              const uint32_t w = v ? y2[q] : y1[q];
              bool n;
              rx[q >> 1] += retries_exact(w, a.log_q) -
                            retries_estimate(w, run.scale, run.inner, n);
            }
        }
      }
    } else {
      const long long size = (long long)TB * a.two_h;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const long long base = ((long long)t[u] * B + b[k]) * a.two_h;
          for (int m = 0; m < hs[u][k]; ++m)
            rx[k] += retries(word(sh.tag + 2, base + m, size), a.log_q,
                             run.scale, run.inner);
        }
    }
  }
}

// The attempts of each tick of the tile: the set bits of each column of
// the block's attempt words (word (k, u) of pair p, row 2k + u: bit s
// for tick s0 + s + u*span).  Each warp takes a share of every row's
// words, and lane s adds bit s of each (a broadcast read), so no warp
// waits on a serial count; lane s then adds its two columns' counts.
template <bool kFull>
__device__ __forceinline__ void count_attempts(const Run& run,
                                               Shared<kFull>& sh, int ns) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int count[2] = {0, 0};
#pragma unroll
  for (int ku = 0; ku < 4; ++ku)
    for (int p = warp; p < run.np; p += warps)
      count[ku & 1] += (sh.att[(kFull ? 1 : 0) * ku][p] >> lane) & 1u;
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (lane < ns && count[u]) atomicAdd(&sh.conc[u * ns + lane], count[u]);
}

// Run k of a block: graphs [c0 + k*half, min(c0 + np + k*half, B)); its
// window runs from its first graph's row start to the next graph's, at
// most a.window edges.
__device__ __forceinline__ void find_window(const Args& a, int c0, int np,
                                            int k, int* win) {
  const int first = c0 + k * a.half, end = min(c0 + np + k * a.half, a.B);
  long long lo = 0, size = 0;
  if (first < end && a.C > 0) {
    lo = a.start[(long long)first * a.C];
    const long long hi =
        end < a.B ? a.start[(long long)end * a.C] : (long long)a.nflat;
    size = max(0LL, min(hi - lo, (long long)a.window));
  }
  win[0] = (int)lo;
  win[1] = (int)size;
}

// Pair p of the block's run, from what the block read of it.
template <bool kFull>
__device__ __forceinline__ Pair pair_of(const Args& a, const Run& run,
                                        const Shared<kFull>& sh, int p) {
  Pair pr;
  pr.c = run.c0 + p;
  pr.has2 = pr.c + a.half < a.B;
  pr.b[0] = pr.c;
  pr.b[1] = pr.has2 ? pr.c + a.half : pr.c;
  pr.x2 = pr.has2 ? (uint32_t)(pr.c + a.half) : 0u;
  const uint4 info = sh.info[p];
  pr.nfo[0] = info.x;
  pr.nfo[1] = info.y;
  pr.row0[0] = (int)info.z;
  pr.row0[1] = (int)info.w;
  return pr;
}

// Add a thread's sums for pair p into the block's, and clear them.
template <bool kFull>
__device__ __forceinline__ void add_sums(Shared<kFull>& sh, int p,
                                         Sums& sum) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (sum.msgs[k]) atomicAdd(&sh.sum[k][p], sum.msgs[k]);
    sum.msgs[k] = 0;
    if (!kFull) continue;
    if (sum.retx[k]) atomicAdd(&sh.sum[(kFull ? 2 : 0) + k][p], sum.retx[k]);
    sum.retx[k] = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (sum.att[k][u])
        atomicOr(&sh.att[(kFull ? 2 : 0) * k + u][p], sum.att[k][u]);
      sum.att[k][u] = 0;
    }
  }
}

// kMode as `fate`; Off: the type of an offset into the (T, R*B) outputs.
// A block has at least G * lanes threads, and at least 64.
template <int kMode, typename Off>
__global__ void __launch_bounds__(kMode ? kFullThreads : kMaxThreads, 1)
    sample_chunk_kernel(const Args a) {
  constexpr bool kFull = kMode > 0;
  __shared__ Shared<kFull> sh;
  extern __shared__ int shist[];  // 2 x a.window usage counters

  const int tid = threadIdx.x, nth = blockDim.x;
  Run run;
  run.r = blockIdx.x / a.runs;
  run.c0 = (blockIdx.x - run.r * a.runs) * a.G;
  run.np = min(a.G, a.half - run.c0);
  run.usage_r = a.usage + (long long)run.r * a.nflat;
  run.hist = shist;
  // on the device, as torch takes log(clamp_min(p, 1e-12)) there
  run.log_p = kMode == 2 && a.lossy ? logf(fmaxf(a.p, 1e-12f)) : 0.0f;
  run.scale = kFull && a.retx ? 0.693147182f / a.log_q : 0.0f;
  run.inner = 0.5f - 2e-5f - 2e-6f * fabsf(run.scale);
  const uint32_t k1 = (uint32_t)__ldg(a.keys + 2 * run.r);
  const uint32_t k2 = (uint32_t)__ldg(a.keys + 2 * run.r + 1);
  const long long rb = (long long)run.r * a.B;
  // Thread p < np reads pair p's graphs and the counts it adds to at the
  // end; threads 0 and 1 find the windows, 2 and 3 the tagged keys; the
  // windows are zeroed; the first tile's keys are hashed meanwhile.
  int before[2][2] = {{0, 0}, {0, 0}};  // msgs, retx of graph k
  if (tid < run.np) {
    const int c = run.c0 + tid;
    const bool has2 = c + a.half < a.B;
    const int c2 = has2 ? c + a.half : c;
    const int n = a.n_nodes[c], n2 = a.n_nodes[c2];
    sh.info[tid] = make_uint4(
        (uint32_t)n | (a.done[rb + c] ? 0x80000000u : 0u),
        (uint32_t)n2 | (a.done[rb + c2] ? 0x80000000u : 0u),
        (uint32_t)(c * a.C + (n > 0 ? 0 : a.C)),
        (uint32_t)(c2 * a.C + (n2 > 0 ? 0 : a.C)));
    before[0][0] = a.msgs[rb + c];
    before[1][0] = has2 ? a.msgs[rb + c2] : 0;
    if (kFull && a.retx) {
      before[0][1] = a.retx[rb + c];
      before[1][1] = has2 ? a.retx[rb + c2] : 0;
    }
#pragma unroll
    for (int k = 0; k < (kFull ? 4 : 2); ++k) sh.sum[k][tid] = 0;
#pragma unroll
    for (int k = 0; k < (kFull ? 4 : 1); ++k) sh.att[k][tid] = 0;
  }
  if (tid < 2) {
    find_window(a, run.c0, run.np, tid, sh.win[tid]);
  } else if (kFull && tid < 4 && (a.strag || a.retx)) {
    // fold_in(fold_in(key_r, tag), t0)
    const int which = tid - 2;  // 0: straggler, 1: retransmissions
    uint32_t y1, y2;
    threefry(k1, k2, 0u, which ? kTagRetx : kTagStraggler, y1, y2);
    threefry(y1, y2, 0u, (uint32_t)a.t0, sh.tag[2 * which],
             sh.tag[2 * which + 1]);
  }
  for (int e = tid; e < 2 * a.window; e += nth) shist[e] = 0;

  // the main path: thread tid draws for pair p = tid % G in lane tid / G
  const int p = tid % a.G, lane = tid / a.G;
  const bool busy = kMode == 0 && p < run.np && lane < a.lanes;
  Pair pr;
  Sums sum{{0, 0}, {0, 0}, {{0u, 0u}, {0u, 0u}}};
  const int span = a.span;
  for (int s0 = 0; s0 < span; s0 += kTileSlots) {
    const int ns = min(kTileSlots, span - s0);
    if (s0) __syncthreads();  // the last tile's keys and counts are read
    // key e: tick s0 + e for e < ns, else s0 + e - ns + span; hashed by
    // thread e + 32, past the threads that start the block
    for (int e = (tid + nth - 32) % nth; e < 2 * ns; e += nth) {
      const int tl = e < ns ? s0 + e : s0 + e - ns + span;
      if (kFull) sh.conc[e] = 0;
      if (tl >= a.T) continue;  // the second tick of odd T's last slot
      // fold_in(key_r, t0 + t), then split's 4 hashes, counters (q, q + 4)
      const long long when = a.t0 + tl;
      uint32_t kt1, kt2;
      threefry(k1, k2, 0u, (uint32_t)when, kt1, kt2);
      const uint32_t q1[4] = {kt1, kt1, kt1, kt1}, q2[4] = {kt2, kt2, kt2, kt2};
      uint32_t y1[4] = {0u, 1u, 2u, 3u}, y2[4] = {4u, 5u, 6u, 7u};
      threefry_n<4>(q1, q2, y1, y2);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sh.key[e][q] = y1[q];
        if (kFull) sh.key[e][(kFull ? 4 : 0) + q] = y2[q];
      }
      if (kFull)
        sh.now[e] = (when >= a.churn_tick ? 1 : 0) |
                    (when >= a.reg_t0 && when < a.reg_t1 ? 2 : 0);
    }
    // the keys, and at the first tile the pairs, the windows and the
    // zeroed counts, visible to the block
    __syncthreads();
    if (s0 == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        run.lo[k] = sh.win[k][0];
        run.size[k] = sh.win[k][1];
      }
      if (busy) pr = pair_of(a, run, sh, p);
    }
    if (kMode == 0) {
      // thread (lane, p) draws slots lane, lane + lanes, ... of pair p,
      // its sums kept in registers to the end
      if (busy)
        for (int s = lane; s < ns; s += a.lanes)
          draw_item<kMode, Off>(a, run, sh, pr, s0, ns, s, sum);
    } else {
      // the other modes want more registers than a pair kept for the
      // whole chunk leaves: threads take the tile's (slot, pair) items in
      // turn, pairs fastest (item q: slot q / np, pair q % np), every
      // thread as many, each item's sums added to the block's at once.
      const int items = ns * run.np;
      const int ds = nth / run.np, dp = nth - ds * run.np;
      int s = tid / run.np, q_p = tid - s * run.np;
      for (int q = tid; q < items; q += nth) {
        const Pair item = pair_of(a, run, sh, q_p);
        draw_item<kMode, Off>(a, run, sh, item, s0, ns, s, sum);
        add_sums(sh, q_p, sum);
        s += ds;
        q_p += dp;
        if (q_p >= run.np) {
          q_p -= run.np;
          ++s;
        }
      }
    }
    if (kFull && a.conc) {
      __syncthreads();
      count_attempts(run, sh, ns);
      __syncthreads();
      for (int e = tid; e < 2 * ns; e += nth) {
        const int tl = e < ns ? s0 + e : s0 + e - ns + span;
        if (tl < a.T && sh.conc[e])
          atomicAdd(a.conc + (long long)run.r * a.T + tl, sh.conc[e]);
      }
      // each graph's attempt bits of this tile: word (2 * tile + u)
      const int tile = s0 / kTileSlots;
      if (tid < run.np)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int bk = run.c0 + tid + k * a.half;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t& w = sh.att[(kFull ? 2 : 0) * k + u][tid];
            if (bk < a.B)
              a.out_att[((Off)(2 * tile + u) * a.R + run.r) * a.B + bk] = w;
            w = 0;
          }
        }
    }
  }

  // the block's sums, each added once: it alone owns its (r, b); then
  // one atomic a usage counter its windows touched
  if (busy) add_sums(sh, p, sum);
  __syncthreads();
  if (tid < run.np)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int bk = run.c0 + tid + k * a.half;
      if (bk >= a.B) continue;
      if (sh.sum[k][tid]) a.msgs[rb + bk] = before[k][0] + sh.sum[k][tid];
      if (kFull && a.retx && sh.sum[(kFull ? 2 : 0) + k][tid])
        a.retx[rb + bk] = before[k][1] + sh.sum[(kFull ? 2 : 0) + k][tid];
    }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int* u = run.usage_r + run.lo[k];
    for (int e = tid; e < run.size[k]; e += nth) {
      const int v = shist[k * a.window + e];
      if (v) atomicAdd(u + e, v);
    }
  }
}

// congp[r*B + b] += f32(sum over t of attempt[t, r, b] * max(conc[r, t]
// - 1, 0)), the sum in int32 as the plain version takes it.  A block
// holds graphs of one trial r (blocks_b blocks a trial), a thread a
// graph; for each tile of slots the block stages the pairs' weights
// max(conc - 1, 0) of the tile's ticks in shared memory, and each thread
// adds the weights of its attempt words' set bits.
__global__ void __launch_bounds__(256)
    sample_chunk_congestion(const uint32_t* __restrict__ att,
                            const int* __restrict__ conc,
                            float* __restrict__ congp, int T, int R, int B,
                            int span, int blocks_b) {
  __shared__ int weight[2][kTileSlots];
  const int r = blockIdx.x / blocks_b;
  const int b = (blockIdx.x - r * blocks_b) * 256 + threadIdx.x;
  const long long RB = (long long)R * B, rb = (long long)r * B + b;
  const int* w = conc + (long long)r * T;
  uint32_t s = 0;
  for (int s0 = 0; s0 < span; s0 += kTileSlots) {
    __syncthreads();  // the last tile's weights are read
    if (threadIdx.x < 2 * kTileSlots) {
      const int u = threadIdx.x / kTileSlots, e = threadIdx.x % kTileSlots;
      const int t = s0 + e + u * span;
      weight[u][e] = s0 + e < span && t < T ? max(__ldg(w + t) - 1, 0) : 0;
    }
    __syncthreads();
    if (b >= B) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t m = __ldg(att + (2 * (s0 / kTileSlots) + u) * RB + rb);
#pragma unroll
      for (int e = 0; e < kTileSlots; ++e)
        if ((m >> e) & 1u) s += (uint32_t)weight[u][e];
    }
  }
  if (b < B) congp[rb] = __fadd_rn(congp[rb], __int2float_rn((int)s));
}

// Launch one instance, letting it take `smem` bytes of dynamic shared
// memory (set once for each device).
template <int kMode, typename Off>
cudaError_t launch_draw(int which, unsigned blocks, int threads, size_t smem,
                        cudaStream_t s, const Args& a) {
  static bool ready[4][kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[which][dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_chunk_kernel<kMode, Off>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(2 * kMaxWindow * sizeof(int)));
    if (err != cudaSuccess) return err;
    ready[which][dev] = true;
  }
  sample_chunk_kernel<kMode, Off><<<blocks, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success).
// `lossy` is 0 without loss or for loss_p >= 1 (every hop delivered:
// the same outputs as no loss), else 1 with p = loss_p in f32.  `fbits`
// null runs no scenario; `strag` draws the straggler stream.  `retx`
// null samples no retransmissions; `conc`, `out_att` and `congp` null
// track no congestion (else conc, (R, T), must be zeroed by the caller,
// out_att holds (2 * ceil(ceil(T/2) / 32), R*B) words, and a second
// kernel adds the congestion pairs into congp).  On the main path (kernel
// 0) upd_j equals upd_i and out_uj is not written.  The shape comes from
// ops.py `launch_shape`: `kernel` 0 the main path (no loss, scenario or
// cost model), 1 every mode but loss, 2 every mode, 3 every mode at
// 64-bit offsets (the others need T*R*B < 2^31); G counter pairs a
// block, `lanes` threads a pair, `threads` a block (at least G * lanes
// and 64, at most kMaxThreads for kernel 0 and kFullThreads for the
// others), and `window` usage counters of each graph run kept on chip.
extern "C" int sample_chunk_launch(
    const long long* keys, const int* start, const int* nbr, const int* hops,
    const int* degrees, const int* n_nodes, const uint8_t* done, int* out_i,
    int* out_j, uint8_t* out_ui, uint8_t* out_uj, int* usage, int* msgs,
    long long t0, int T, int R, int B, int C, int nflat, int lossy, float p,
    const uint8_t* fbits, long long churn_tick, long long reg_t0,
    long long reg_t1, int strag, float strag_success, int* retx, int two_h,
    float log_q, int* conc, uint32_t* out_att, float* congp, int kernel,
    int G, int lanes, int threads, int window, void* stream) {
  if (T == 0 || R == 0 || B == 0) return 0;
  const int half = (B + 1) / 2;
  const bool modes = fbits || retx || conc;
  const bool narrow = (long long)T * R * B <= 0x7FFFFFFFLL;
  if (kernel < 0 || kernel > 3 || (kernel == 0 && (lossy || modes)) ||
      (kernel == 1 && lossy) || (kernel < 3 && !narrow) || G < 1 ||
      G > kMaxPairs || lanes < 1 || threads < 64 ||
      (long long)G * lanes > threads ||
      threads > (kernel ? kFullThreads : kMaxThreads) || threads % 32 != 0 ||
      window < 0 || window > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  const int runs = (half + G - 1) / G;
  const long long blocks = (long long)R * runs;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // the congestion kernel's blocks: blocks_b a trial
  const int blocks_b = (B + 255) / 256;
  if (conc && (long long)R * blocks_b > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  // the tagged streams' counters are uint32
  if ((strag || retx) && (long long)T * B * (retx ? two_h : 1) >= 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  Args a{keys,   start,  nbr,    hops,       degrees, n_nodes, done,
         out_i,  out_j,  out_ui, out_uj,     usage,   msgs,    t0,
         T,      R,      B,      C,          nflat,   lossy,   p,
         fbits,  churn_tick,     reg_t0,     reg_t1,  strag,   strag_success,
         retx,   two_h,  log_q,  conc,       out_att, half,    (T + 1) / 2,
         G,      lanes,  runs,   window};
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)window * sizeof(int);
  const unsigned nb = (unsigned)blocks;
  cudaError_t err;
  if (kernel == 0)
    err = launch_draw<0, unsigned>(0, nb, threads, smem, s, a);
  else if (kernel == 1)
    err = launch_draw<1, unsigned>(1, nb, threads, smem, s, a);
  else if (kernel == 2)
    err = launch_draw<2, unsigned>(2, nb, threads, smem, s, a);
  else
    err = launch_draw<2, long long>(3, nb, threads, smem, s, a);
  if (err != cudaSuccess || conc == nullptr) return (int)err;
  sample_chunk_congestion<<<(unsigned)(R * blocks_b), 256, 0, s>>>(
      out_att, conc, congp, T, R, B, (T + 1) / 2, blocks_b);
  return (int)cudaGetLastError();
}
