"""The work formulas against counts made by hand at small shapes."""
from __future__ import annotations

import pytest

from gossipbench.work.gossip import (HASH_OPS, LevelShape, attribution_level,
                                     call_work, draw_chunk, least_s,
                                     pair_apply_chunk)

CELLS = LevelShape("cells", B=3, C=2, nflat=5, ticks=4, chk=2)
OVER = LevelShape("overlay", B=1, C=3, nflat=5, ticks=6, chk=3, edges=2,
                  incidence=7)


def test_hash_ops():
    # 20 rounds of add, rotate, xor; 5 injections of 2 adds; 2 key adds
    assert HASH_OPS == 72


def test_plain_draw_by_hand():
    # keys 16; start + degrees 2*3*2*4; nbr + hops 2*5*4; sizes 3*4;
    # done 3; usage and msgs read and written 2*(5*4 + 3*4); pairs and
    # one bit byte 2*3*(4+4+1)
    assert draw_chunk(CELLS, 1)[0] == 16 + 48 + 40 + 12 + 3 + 64 + 54
    # 5 key hashes a tick, 2 counter pairs (ceil(3/2)) of 2 words a tick
    assert draw_chunk(CELLS, 1)[1] == (5 * 2 + 2 * 2 * 2) * 72
    b2, o2 = draw_chunk(CELLS, 2)
    assert b2 == 32 + 48 + 40 + 12 + 6 + 2 * 2 * (20 + 12) + 2 * 6 * 9
    assert o2 == 2 * (5 * 2 + 2 * 2 * 2) * 72


def test_priced_scenario_draw_by_hand():
    plain_b, plain_o = draw_chunk(CELLS, 1)
    b, o = draw_chunk(CELLS, 1, scenario=True, cost=True, retx_words=7)
    # flags 3*2; retx and congp read and written 2*2*3*4; a second bit
    # byte a pair 2*3
    assert b == plain_b + 6 + 48 + 6
    # 7 retransmission words: 3 whole hashes, rounded down
    assert o == plain_o + 3 * 72


def test_pair_apply_by_hand():
    # state in and out 2*3*2*2*4; pairs 2*3*(4+4) and bits 2*3*1
    assert pair_apply_chunk(CELLS, 1, 2, shared_bits=True) == (
        96 + 48 + 6, 2 * 2 * 3 * 2)
    assert pair_apply_chunk(CELLS, 1, 2, shared_bits=False)[0] == 96 + 48 + 12


def test_attribution_by_hand():
    # usage 5*4 and owner + partner 2*5*4
    assert attribution_level(CELLS, 1) == 20 + 40
    # usage 5*4, two entries an edge 2*2*4, incidence 3*7*4
    assert attribution_level(OVER, 2) == 40 + 16 + 84


def test_call_work_adds_up_chunk_by_chunk():
    w = call_work([CELLS, OVER], R=2, n=10, V=2)
    assert len(w["draw"]) == 2 + 2 and len(w["pair_apply"]) == 4
    assert w["draw"][0] == draw_chunk(CELLS, 2)
    assert w["draw"][3] == draw_chunk(OVER, 2)
    assert w["attribution"] == 2 * 10 * 4 + attribution_level(
        CELLS, 2) + attribution_level(OVER, 2)
    priced = call_work([CELLS, OVER], R=2, n=10, V=2, cost=True,
                       level_messages=[9, 4])
    # 9 messages over 2 chunks: 4 words a chunk, 2 hashes
    assert priced["draw"][0] == draw_chunk(CELLS, 2, cost=True, retx_words=4)


def test_least_is_the_larger_bound():
    assert least_s(3.35e12, 0, 3.35e12, 1e12) == pytest.approx(1.0)
    assert least_s(0, 2e12, 3.35e12, 1e12) == pytest.approx(2.0)
