"""The reference against the port's plain CPU path at small sizes: the
plan array for array, and every output of `execute_plan` (backend "ref")
bitwise, under every scenario, with and without the cost model.  A test
may compare the two; the benchmark itself never runs the port's plain
path."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as P
from gossipbench import check
from gossipbench.reference import execute, plan as ref_plan

N = 900
CFG = dict(n=N, graph_seed=1000 + N, c=3.0, a=2.0 / 3.0, cell_max=8.0,
           plan_seed=0, rep_mode="random")
FI = dict(eps=1e-3, weighted=True, fixed_ticks_scale=0.2)
COST = dict(retransmit_p=0.9, congestion_alpha=0.01)


@pytest.fixture(scope="module")
def plans():
    port, _ = P.setup_plan(N, graph_seed=1000 + N, use_cache=False)
    return port, ref_plan.build(CFG)


def test_plans_agree_array_for_array(plans):
    port, ref = plans
    assert check.plan_mismatch(port, ref) == []
    assert int(ref["levels"]) == len(port.levels) >= 3


def test_a_changed_plan_is_caught(plans):
    port, ref = plans
    bad = dict(ref)
    bad["L1.inc_count"] = ref["L1.inc_count"] + 1
    bad["final_slot"] = ref["final_slot"][::-1].copy()
    assert set(check.plan_mismatch(port, bad)) == {"L1.inc_count",
                                                   "final_slot"}


def test_the_cache_round_trips(plans, tmp_path):
    _, ref = plans
    again = ref_plan.load_or_build(CFG, str(tmp_path))
    assert set(again) == set(ref)
    assert all(np.array_equal(again[k], ref[k]) for k in ref)
    loaded = ref_plan.load_or_build(CFG, str(tmp_path))
    assert all(np.array_equal(loaded[k], ref[k]) for k in ref)


@pytest.mark.parametrize("priced", [False, True])
@pytest.mark.parametrize("scenario", [sc.name for sc in P.scenario_matrix()])
def test_execution_is_bitwise_the_ports(plans, scenario, priced):
    port, ref = plans
    sc = {s.name: s for s in P.scenario_matrix()}[scenario]
    R = 3
    x0 = np.random.default_rng(4).normal(0, 1, (R, N)).astype(np.float32)
    seeds = [7, 2**32 - 1, 123456]
    res = P.execute_plan(port, x0, seeds=seeds, failures=sc.failures,
                         cost=P.CostModel(**COST) if priced else None,
                         options=P.ExecOptions(backend="ref", device="cpu"),
                         **FI)
    fm = None if sc.failures is None else dataclasses.asdict(sc.failures)
    want = execute.run_blocks(ref, torch.as_tensor(x0), seeds, eps=1e-3,
                              scale=0.2, weighted=True, failures=fm,
                              cost=COST if priced else None)
    assert np.array_equal(res.x_final.view(np.int32),
                          want["x_final"].view(np.int32))
    for k in ("messages", "node_sends", "level_messages"):
        assert np.array_equal(getattr(res, k), want[k]), k
    if priced:
        assert np.array_equal(res.cost.retransmissions,
                              want["retransmissions"])
        assert np.array_equal(res.cost.congestion, want["congestion"])
    got = dict(x_final=res.x_final, messages=res.messages,
               node_sends=res.node_sends, level_messages=res.level_messages)
    if priced:
        got.update(retransmissions=res.cost.retransmissions,
                   congestion=res.cost.congestion)
    readings = check.compare(got, want, x0)
    assert readings["accounting_mismatch"] == 0
    assert readings["x_final_gap"] == 0.0
    assert readings.get("cost_mismatch", 0) == 0


def test_bfloat16_moves_the_estimates_far_past_float32(plans):
    _, ref = plans
    x0 = torch.as_tensor(
        np.random.default_rng(5).normal(0, 1, (2, N)).astype(np.float32))
    kw = dict(eps=1e-3, scale=0.2, weighted=True)
    f32 = execute.run_blocks(ref, x0, [1, 2], **kw)
    bf16 = execute.run_blocks(ref, x0, [1, 2], dtype=torch.bfloat16, **kw)
    gap = check.compare(bf16, f32, x0.numpy())
    assert gap["accounting_mismatch"] == 0
    assert gap["x_final_gap"] > 1e-3


def test_blocks_join_to_one_run(plans):
    _, ref = plans
    x0 = torch.randn(5, N, generator=torch.Generator().manual_seed(1))
    kw = dict(eps=1e-3, scale=0.2, weighted=True)
    whole = execute.run(ref, x0, [1, 2, 3, 4, 5], **kw)
    one = execute.run(ref, x0[3:4], [4], **kw)
    assert np.array_equal(whole["x_final"][3], one["x_final"][0])
    assert np.array_equal(whole["node_sends"][3], one["node_sends"][0])
