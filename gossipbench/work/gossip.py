"""Least bytes and operations of one `execute_plan` call, chunk by chunk.

A call runs every level of the plan in whole chunks of `chk` ticks; each
chunk is one schedule draw and one value pass over the level's B graphs
for all R trials.  A level here is a `LevelShape`: its graphs B, slots C,
flat CSR entries `nflat` (the sentinel included), ticks and ticks a
chunk, and for an overlay its edges E and route-incidence entries.

Counting rules (each input byte read once, each output byte written once,
what these inputs need and no more):

* draw (`draw_chunk`): keys (16 a trial); the CSR row starts and degrees
  (B x C int32 each), neighbours and hops (nflat int32 each), graph sizes
  (B int32); the done flags (R x B); the usage and message counters read
  and written (R x nflat and R x B int32); the pairs written (T x R x B
  int32 twice) and one byte of update bits a pair (two where the bits of
  the initiator and the partner differ: under a scenario or a cost
  model).  Operations: a threefry hash of 72 int32 operations for the
  five keys of each tick of each trial, and one for each counter pair of
  a tick (the node and neighbour words of two graphs).
* the draw under a scenario and a cost model (`draw_chunk` with
  `scenario` / `cost`): the (B, C) flag bytes, the retransmission and
  congestion counters read and written (R x B int32 each), and a hash for
  every two words of the retransmission stream: one word a hop sent, so
  half the level's messages (spread evenly over its chunks, rounded
  down).  The straggler stream's words (one for each
  exchange that touches a straggler) depend on the draw and are not
  counted: the bound errs low.
* value pass (`pair_apply_chunk`): the state read and written (R x B x C
  x V float32) and the pairs and update bits read; 2 x T x R x B x V
  float32 operations (negligible).
* attribution (`attribution_level`): the level's usage counters read
  (R x nflat int32) and its index arrays (int32): for the cells the owner
  and partner of each entry; for an overlay the two directed entries of
  each edge and the incidence's node, edge and count; once a call the
  per-node sends written (R x n int32).
"""
from __future__ import annotations

import dataclasses

# threefry-2x32's own int32 operations a hash: 20 rounds of add, rotate
# and xor, 5 key injections of two adds, two adds of the key at the start
HASH_OPS = 20 * 3 + 5 * 2 + 2


@dataclasses.dataclass(frozen=True)
class LevelShape:
    kind: str      # "cells" or "overlay"
    B: int
    C: int
    nflat: int     # flat CSR entries, the trailing sentinel included
    ticks: int     # the level's fixed budget, whole chunks
    chk: int       # ticks a chunk
    edges: int = 0       # overlay: undirected edges
    incidence: int = 0   # overlay: route-incidence entries

    @property
    def chunks(self) -> int:
        return self.ticks // self.chk


def draw_chunk(lv: LevelShape, R: int, scenario: bool = False,
               cost: bool = False, retx_words: int = 0) -> tuple:
    """(bytes, int32 operations) of one chunk's draw."""
    B, C, T = lv.B, lv.C, lv.chk
    bits = 2 if (scenario or cost) else 1
    nbytes = (16 * R + 2 * B * C * 4 + 2 * lv.nflat * 4 + B * 4 + R * B
              + 2 * R * (lv.nflat * 4 + B * 4) + T * R * B * (4 + 4 + bits))
    hashes = R * (5 * T + 2 * T * ((B + 1) // 2))
    if scenario:
        nbytes += B * C
    if cost:
        nbytes += 2 * 2 * R * B * 4
        hashes += retx_words // 2
    return nbytes, hashes * HASH_OPS


def pair_apply_chunk(lv: LevelShape, R: int, V: int,
                     shared_bits: bool) -> tuple:
    """(bytes, float32 operations) of one chunk's value pass."""
    N = R * lv.B
    bits = 1 if shared_bits else 2
    return (2 * N * lv.C * V * 4 + lv.chk * N * (4 + 4 + bits),
            2 * lv.chk * N * V)


def attribution_level(lv: LevelShape, R: int) -> int:
    """Bytes of one level's send attribution (the per-node sends are
    counted once a call, by `call_work`)."""
    if lv.kind == "cells":
        index = 2 * lv.nflat * 4
    else:
        index = 2 * lv.edges * 4 + 3 * lv.incidence * 4
    return R * lv.nflat * 4 + index


def call_work(levels, R: int, n: int, V: int, scenario: bool = False,
              cost: bool = False, level_messages=None) -> dict:
    """Work of one call of R trials over `levels` (LevelShape list), by
    part: "draw" and "pair_apply" are lists of per-chunk (bytes, ops);
    "attribution" is bytes.  `level_messages`, the call's messages of
    each level summed over its trials, sizes the retransmission stream
    under a cost model."""
    draws, passes = [], []
    attribution = R * n * 4
    for li, lv in enumerate(levels):
        words = 0
        if cost and level_messages is not None:
            words = int(level_messages[li]) // lv.chunks
        draws += [draw_chunk(lv, R, scenario, cost, words)] * lv.chunks
        passes += [pair_apply_chunk(lv, R, V, not (scenario or cost))
                   ] * lv.chunks
        attribution += attribution_level(lv, R)
    return {"draw": draws, "pair_apply": passes, "attribution": attribution}


def least_s(nbytes: float, ops: float, bytes_per_s: float,
            ops_per_s: float) -> float:
    """The least time of a piece of work: the larger of its bytes over
    the memory's rate and its operations over the units' rate."""
    return max(nbytes / bytes_per_s, ops / ops_per_s)
