"""The harness on the CPU at a tiny size: it finds cells,
configurations, traffic mixes and metric readers added as new files,
runs a cell whole, and agrees with BENCHMARK.json."""
from __future__ import annotations

import json
import time

import pytest
from conftest import ROOT

from gossipbench import registry, run


def _run(root, cell, trace=False, **kw):
    return run.run_cell(cell, 2**31 + 99, 0.2, trace, device="cpu",
                        root=root, start=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", ["tiny.mc", "tiny.faults"])
def test_a_cell_added_as_files_runs_and_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 4 and out["failed"] == 0
    want = {"plan_mismatch", "accounting_mismatch", "x_final_gap"}
    if cell == "tiny.faults":
        want.add("cost_mismatch")
    assert set(out["checks"]) == want
    spec = registry.spec(tiny_root)
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["setup"]["plan_cache"] in ("hit", "miss")
    assert out["setup"]["kernels"] == "found"


def test_a_metric_added_as_a_file_is_read(tiny_root):
    spec_path = tiny_root.parent / "BENCHMARK.json"
    spec = spec_path.read_text()
    added = json.loads(spec)
    for name, cells in (("calls_traced", None), ("nothing_here", None),
                        ("elsewhere", ["tiny.faults"])):
        (tiny_root / "metrics" / f"{name}.py").write_text(
            "def read(ctx):\n    return float(ctx.calls)\n"
            if name != "nothing_here" else
            "def read(ctx):\n    return None\n")
        m = {"name": name, "unit": "calls", "better": "lower",
             "source": "program_counter", "layer": "test",
             "moves": "trials_per_s"}
        if cells:
            m["workloads"] = cells
        added["per_layer"].append(m)
    spec_path.write_text(json.dumps(added))
    try:
        out = _run(tiny_root, "tiny.mc", trace=True)
    finally:
        spec_path.write_text(spec)
        for name in ("calls_traced", "nothing_here", "elsewhere"):
            (tiny_root / "metrics" / f"{name}.py").unlink()
    cell = registry.cell("tiny.mc", tiny_root)
    assert out["metrics"]["calls_traced"]["value"] == cell["trace_calls"]
    assert out["metrics"]["calls_traced"]["unit"] == "calls"
    assert "nothing_here" not in out["metrics"]
    assert "elsewhere" not in out["metrics"]
    assert "draw_roofline.faults" not in out["metrics"]
    assert out["metrics"]["plan_setup_s"]["value"] > 0
    assert out["correct"]


@pytest.mark.parametrize("R,trials", [(128, 4), (10, 3), (10, 10),
                                      (10, 12), (2, 4), (1, 2)])
def test_the_sample_holds_the_first_and_last_rows(R, trials):
    s = run.Sampler(5, 1, calls=2, trials=trials, R=R)
    for _ in range(20):
        rows = s.rows()
        assert rows == sorted(set(rows))
        assert len(rows) == min(trials, R)
        assert rows[0] == 0 and rows[-1] == R - 1
        assert all(0 <= r < R for r in rows)


def test_the_reservoir_keeps_calls_drawn_from_the_seed():
    import numpy as np

    def kept(seed):
        s = run.Sampler(seed, 2, calls=2, trials=2, R=4)
        for c in range(40):
            s.offer(run.Call(c, c % 2, [0] * 4, 0.0),
                    {"x": np.arange(4) + c})
        return [[e[0].index for e in k] for k in s.kept]

    assert kept(3) == kept(3)
    assert all(len(k) == 2 for k in kept(3))
    assert kept(3) != kept(4) or kept(3) != kept(5)


def test_p95_is_over_every_call():
    lat = [float(i) for i in range(1, 101)]
    assert run._p95(lat) == pytest.approx(95.05)
    assert run._p95([2.0]) == 2.0


def test_benchmark_json_and_the_files_agree():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["command"][:3] == ["python3", "-m", "gossipbench.run"]
    assert spec["paths"] == ["gossipbench"]
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"gossipbench/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"] == []
    for w in spec["workloads"]:
        cell = registry.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        registry.traffic(w["traffic"])
        assert set(cell["limits"]) >= {"plan_mismatch",
                                       "accounting_mismatch", "x_final_gap"}
    for m in spec["per_layer"]:
        assert callable(registry.reader(m["name"]))
    names = {m["name"] for m in spec["end_to_end"]}
    assert names == {"trials_per_s", "call_p95_ms", "setup_s"}
    for w in spec["workloads"]:
        mix = registry.traffic(w["traffic"])
        assert "backend" not in mix and mix["trials_per_call"] == 10


def test_the_faults_mix_is_the_scenario_matrix():
    import dataclasses

    import repro_torch.core as P

    mix = registry.traffic("faults10")
    got = [(s["name"], s["failures"]) for s in mix["scenarios"]]
    want = [(sc.name, None if sc.failures is None else {
        k: v for k, v in dataclasses.asdict(sc.failures).items()
        if v != getattr(P.FailureModel(), k) or k == "seed"})
        for sc in P.scenario_matrix()]
    for (gn, gf), (wn, wf) in zip(got, want):
        assert gn == wn
        if wf is None:
            assert gf is None
        else:
            fm = P.FailureModel(**gf)
            assert fm == P.FailureModel(**wf)
    assert len(got) == len(want)
    assert mix["cost"] == {"retransmit_p": 0.9, "congestion_alpha": 0.01}


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "msg-rgg-1e5.mc10", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_are_named(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax", "repro"]
    monkeypatch.delitem(sys.modules, "repro")
    monkeypatch.delitem(sys.modules, "jax.numpy")
    assert "repro_torch" not in run.FORBIDDEN

