"""Reading a profiler trace, and the per-layer readers on a made-up
one: busy time is the union of device intervals, gaps are named by the
innermost host operation, and no share can pass 100%."""
from __future__ import annotations

import json

import pytest

from gossipbench import registry, run, trace
from gossipbench.work.gossip import LevelShape, call_work


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.CALL, "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void sample_chunk_kernel<0>",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "pair_apply_kernel",
         "ts": 25, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void index_add_kernel",
         "ts": 70, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index_add_", "ts": 38,
         "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 45,
         "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 80, "dur": 2},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.load(str(path))


def test_busy_gaps_and_breakdown(tmp_path):
    t = _trace(tmp_path)
    assert t.window == (0.0, 100.0)
    assert t.busy() == [[10.0, 40.0], [60.0, 75.0]]
    assert t.busy_s == pytest.approx(45e-6)
    assert t.gaps() == [(0.0, 10.0), (40.0, 60.0), (75.0, 100.0)]
    assert t.device_time_s(lambda n: True) == pytest.approx(50e-6)
    assert t.device_time_s(lambda n: True, cats=("kernel",)) == (
        pytest.approx(40e-6))
    b = t.breakdown()
    assert b["device_ops"][0] == ["void sample_chunk_kernel<0>", 20e-6]
    idle = dict(b["idle_gaps"])
    assert idle["aten::copy_"] == pytest.approx(20e-6)   # mid 50: innermost
    assert idle["host: no torch op (python, numpy)"] == pytest.approx(35e-6)


def test_readers_on_a_made_up_trace(tmp_path):
    t = _trace(tmp_path)
    lv = LevelShape("cells", B=3, C=2, nflat=5, ticks=4, chk=2)
    ctx = run.Context(trace=t, calls=1, trials=2,
                      work=[call_work([lv], 2, 10, 2)], priced=False,
                      peaks={"bytes_per_s": 3.35e12, "int32_per_s": 1.6e13,
                             "f32_per_s": 6.7e13, "name": "x",
                             "power_limit_w": 700.0},
                      plan_setup_s=0.5)
    read = {n: registry.reader(n)(ctx) for n in registry.metric_names(
        "msg-rgg-1e5.mc10", "per_layer")}
    assert read["launches_per_call"] == 4
    assert read["device_idle_share"] == pytest.approx(55.0)
    assert read["aux_device_ms_per_trial"] == pytest.approx(5e-3 / 2)
    assert read["copy_device_ms_per_trial"] == pytest.approx(10e-3 / 2)
    assert read["plan_setup_s"] == 0.5
    for k in ("draw_roofline", "pair_apply_roofline", "gossip_mfu"):
        assert 0 < read[k] <= 100, k
    assert registry.reader("draw_roofline.faults")(ctx) is None


def test_readers_without_a_trace_read_nothing():
    ctx = run.Context(trace=None, calls=1, trials=1, work=[], priced=True,
                      peaks=None, plan_setup_s=1.0)
    for n in ("launches_per_call", "draw_roofline", "draw_roofline.faults",
              "pair_apply_roofline", "aux_device_ms_per_trial",
              "copy_device_ms_per_trial", "gossip_mfu", "device_idle_share"):
        assert registry.reader(n)(ctx) is None, n
