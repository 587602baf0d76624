"""The comparison that decides `correct` has to fail: the control (the
reference in bfloat16 in the program's place) and each fault a cell can
have, planted in the program or in its outputs, come out not correct on
the CPU at a tiny size; the sound run comes out correct.  On the card
the same control runs at the cell's own size (`gossipbench.limits`)."""
from __future__ import annotations

import time

import pytest

import repro_torch.core as P
from gossipbench import limits, registry, run
from gossipbench.reference import plan as ref_plan

SEED = 2**31 + 5


def _run(root, cell, **kw):
    return run.run_cell(cell, SEED, 0.2, False, device="cpu", root=root,
                        start=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", ["tiny.mc", "tiny.faults"])
def test_the_control_is_not_correct(tiny_root, cell):
    c = registry.cell(cell, tiny_root)
    cfg = registry.config(c["config"], tiny_root)
    mix = registry.traffic(c["traffic"], tiny_root)
    rplan = ref_plan.build(cfg)
    out = _run(tiny_root, cell, program=limits.control(
        rplan, cfg, mix["cost"], "cpu"))
    assert not out["correct"]
    gap = out["checks"]["x_final_gap"]
    assert gap["value"] > 100 * gap["limit"]
    assert out["checks"]["accounting_mismatch"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(limits.FAULTS))
def test_a_fault_in_the_outputs_is_not_correct(tiny_root, fault):
    out = _run(tiny_root, "tiny.mc", program=limits.FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_a_value_pass_that_leaves_the_state_is_not_correct(tiny_root,
                                                           monkeypatch):
    from repro_torch.core import gossip

    monkeypatch.setattr(gossip, "_value_pass", lambda backend, x, *a: x)
    out = _run(tiny_root, "tiny.faults")
    assert not out["correct"]
    assert out["checks"]["x_final_gap"]["value"] > 1e-3


def test_a_miscounted_draw_is_not_correct(tiny_root, monkeypatch):
    import repro_torch.kernels.sample_chunk as sc

    real = sc.sample_chunk_ref

    def draw(*a, **kw):
        out = real(*a, **kw)
        a[7][:, :1] += 1          # msgs: one more for the first graph
        return out

    monkeypatch.setattr(sc, "sample_chunk_ref", draw)
    out = _run(tiny_root, "tiny.mc")
    assert not out["correct"]
    assert out["checks"]["accounting_mismatch"]["value"] > 0


def test_half_the_batch_left_out_is_not_correct(tiny_root, monkeypatch):
    import numpy as np

    real = P.execute_plan

    def half(plan, x0, seeds, **kw):
        h = len(seeds) // 2
        res = real(plan, x0[:h], seeds=seeds[:h], **kw)
        idx = np.arange(len(seeds)) % h
        for k in ("x_final", "messages", "node_sends", "level_messages"):
            setattr(res, k, getattr(res, k)[idx])
        return res

    monkeypatch.setattr(P, "execute_plan", half)
    out = _run(tiny_root, "tiny.mc")
    assert not out["correct"]


def test_the_sound_run_is_correct(tiny_root):
    assert _run(tiny_root, "tiny.mc")["correct"]


@pytest.mark.cuda
def test_the_control_on_the_card_at_the_cells_size(card):
    cell = registry.cell("msg-rgg-1e5.mc10")
    cfg = registry.config(cell["config"])
    rplan = ref_plan.load_or_build(cfg, str(run.HERE / ".cache" /
                                            "reference"))
    out = run.run_cell("msg-rgg-1e5.mc10", SEED, 1.0, False,
                       program=limits.control(rplan, cfg, None, "cuda"),
                       start=time.perf_counter())
    assert not out["correct"]
