"""Shared fixtures of the benchmark's own tests: a copy of the harness's
data in a temporary directory with a tiny deployment added as new files
(a configuration, traffic mixes and cells), so the harness can run
whole on the CPU.  Run them with

    python -m pytest -q gossipbench/tests
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

TINY_N = 600


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of ``gossipbench/``'s data (no code) with tiny cells added:
    ``tiny.mc`` (4 trials a call, reliable) and ``tiny.faults`` (4 trials
    a call over the five scenarios, priced), and beside it a
    BENCHMARK.json that names them as the real one names the n=1e5
    cells."""
    root = tmp_path_factory.mktemp("bench") / "gossipbench"
    src = ROOT / "gossipbench"
    for kind in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(src / kind, root / kind)
    cfg = json.loads((root / "configs" / "msg-rgg-1e5.json").read_text())
    cfg.update(n=TINY_N, graph_seed=1000 + TINY_N)
    _dump(root / "configs" / "tiny.json", cfg)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    like = {"tiny.mc": "msg-rgg-1e5.mc10",
            "tiny.faults": "msg-rgg-1e5.faults10"}
    for cell, real in like.items():
        name = cell.replace(".", "")
        base = json.loads((root / "cells" / f"{real}.json").read_text())
        mix = json.loads((root / "traffic" / f"{base['traffic']}.json")
                         .read_text())
        mix.update(trials_per_call=4)
        _dump(root / "traffic" / f"{name}.json", mix)
        lim = dict(base["limits"], x_final_gap=1e-6)
        _dump(root / "cells" / f"{cell}.json",
              {"config": "tiny", "traffic": name, "chips": 1,
               "check": {"calls": 1, "trials": 4}, "trace_calls": 2,
               "limits": lim})
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": name, "chips": 1, "why": "tiny"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    spec["configs"].append({"name": "tiny", "source": "tiny",
                            "file": "gossipbench/configs/tiny.json",
                            "reduced": ["n"], "why": "tiny"})
    _dump(root.parent / "BENCHMARK.json", spec)
    return root


@pytest.fixture
def card():
    """Skips a test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
