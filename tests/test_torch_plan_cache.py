"""The port's plan cache (`repro_torch.core.plan_cache`) against the
reference's: the same specs hash to the same keys, a hit is bitwise a
fresh build, a version bump misses, and an entry of the JAX package is
never loaded."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.plan_cache as ref_cache  # noqa: E402
from repro.core import build_plan as ref_build_plan  # noqa: E402
from repro.core import random_geometric_graph as ref_rgg  # noqa: E402
from repro_torch.core import (  # noqa: E402
    PLAN_CACHE_VERSION,
    build_plan,
    graph_digest_spec,
    graph_spec,
    load_plan,
    plan_key,
    random_geometric_graph,
    setup_plan,
    store_plan,
)
from repro_torch.core import plan_cache  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

# every array field a LevelPlan carries
_LP_ARRAY_FIELDS = (
    "degrees", "n_nodes", "node_mask", "slot_node",
    "nbr_start", "nbr_flat", "hop_flat", "row_node", "partner_flat",
    "edge_b", "edge_i", "edge_si", "edge_j", "edge_sj",
    "edge_pos_i", "edge_pos_j",
    "inc_node", "inc_edge", "inc_count",
    "rep_slot", "rep_node", "line16", "next_graph", "next_slot",
)


def _assert_plans_bitwise_equal(p1, p2):
    assert len(p1.levels) == len(p2.levels)
    for lp1, lp2 in zip(p1.levels, p2.levels):
        assert (lp1.level, lp1.kind, lp1.max_hops, lp1.max_deg) == (
            lp2.level, lp2.kind, lp2.max_hops, lp2.max_deg)
        for f in _LP_ARRAY_FIELDS:
            a, b = getattr(lp1, f), getattr(lp2, f)
            if a is None or b is None:
                assert a is None and b is None, f
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("rep_counts", "final_graph", "final_slot"):
        np.testing.assert_array_equal(getattr(p1, f), getattr(p2, f))
    assert p1.disconnected_cells == p2.disconnected_cells
    assert p1.disseminate == p2.disseminate
    for f in ("coords", "nbr_start", "nbr_flat", "degrees"):
        np.testing.assert_array_equal(getattr(p1.graph, f),
                                      getattr(p2.graph, f))


@pytest.mark.parametrize("spec", [
    dict(n=600, seed=11),
    dict(n=1000, c=2.5, seed=0, radius=0.08),
    dict(n=100000, seed=101000),
])
@pytest.mark.parametrize("plan_kw", [
    {}, dict(k=3, seed=5), dict(a=0.5, cell_max=6.0, rep_mode="central"),
])
def test_seeded_keys_match_reference(spec, plan_kw):
    spec = dict(spec)
    n = spec.pop("n")
    mine = plan_key(graph_spec(n, **spec), **plan_kw)
    ref = ref_cache.plan_key(ref_cache.graph_spec(n, **spec), **plan_kw)
    assert mine == ref and len(mine) == 64
    assert PLAN_CACHE_VERSION == ref_cache.PLAN_CACHE_VERSION


@pytest.mark.parametrize("n,seed", [(300, 2), (512, 9)])
def test_digest_keys_match_reference(n, seed):
    mine = graph_digest_spec(random_geometric_graph(n, seed=seed))
    ref = ref_cache.graph_digest_spec(ref_rgg(n, seed=seed))
    assert mine == ref
    assert plan_key(mine, seed=3) == ref_cache.plan_key(ref, seed=3)


def test_cold_then_warm_equal_fresh_build(tmp_path):
    d = str(tmp_path)
    p1, i1 = setup_plan(600, graph_seed=11, seed=5, cache_dir=d)
    assert i1["cache"] == "miss" and i1["graph_gen_s"] > 0
    assert os.path.exists(os.path.join(d, f"{i1['key']}.plan.pkl"))
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    p2, i2 = setup_plan(600, graph_seed=11, seed=5, cache_dir=d)
    assert i2["cache"] == "hit" and i2["graph_gen_s"] == 0.0
    assert i2["key"] == i1["key"]
    fresh = build_plan(random_geometric_graph(600, seed=11), seed=5)
    _assert_plans_bitwise_equal(p1, fresh)
    _assert_plans_bitwise_equal(p2, fresh)
    # a prebuilt graph is keyed by content, and hits its own entry
    g = random_geometric_graph(600, seed=11)
    p3, i3 = setup_plan(g=g, seed=5, cache_dir=d)
    assert i3["cache"] == "miss" and i3["key"] != i1["key"]
    _, i4 = setup_plan(g=g, seed=5, cache_dir=d)
    assert i4["cache"] == "hit"
    _assert_plans_bitwise_equal(p3, fresh)
    _, i5 = setup_plan(600, graph_seed=11, seed=5, cache_dir=d, refresh=True)
    assert i5["cache"] == "miss"
    _, i6 = setup_plan(600, graph_seed=11, seed=5, cache_dir=d,
                       use_cache=False)
    assert i6["cache"] == "off"
    with pytest.raises(ValueError, match="exactly one"):
        setup_plan(600, g=g, cache_dir=d)


def test_default_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE", raising=False)
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "ref"))
    d = plan_cache.default_cache_dir()
    assert d.endswith(os.path.join("repro_torch", "plan_cache"))
    assert d != ref_cache.default_cache_dir()
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "mine"))
    assert plan_cache.default_cache_dir() == str(tmp_path / "mine")


def test_version_bump_misses(tmp_path, monkeypatch):
    d = str(tmp_path)
    _, i1 = setup_plan(300, graph_seed=1, cache_dir=d)
    monkeypatch.setattr(plan_cache, "PLAN_CACHE_VERSION",
                        PLAN_CACHE_VERSION + 1)
    assert plan_cache.plan_key(graph_spec(300, seed=1)) != i1["key"]
    _, i2 = plan_cache.setup_plan(300, graph_seed=1, cache_dir=d)
    assert i2["cache"] == "miss"
    # an entry stored under one version is a miss under another, even
    # when found at its key
    assert plan_cache.load_plan(i1["key"], cache_dir=d) is None


def test_foreign_or_damaged_payloads_miss(tmp_path):
    d = str(tmp_path)
    plan = build_plan(random_geometric_graph(200, seed=4))
    key = plan_key(graph_spec(200, seed=4))
    path = store_plan(key, plan, cache_dir=d)
    assert load_plan(key, cache_dir=d) is not None
    assert load_plan("0" * 64, cache_dir=d) is None        # absent
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])                     # truncated
    assert load_plan(key, cache_dir=d) is None
    # the reference's payload layout around the port's own plan
    with open(path, "wb") as f:
        pickle.dump({"key": key, "version": PLAN_CACHE_VERSION,
                     "plan": plan}, f)
    assert load_plan(key, cache_dir=d) is None


def test_reference_entry_is_never_loaded(tmp_path):
    """A reference entry, under the same key and file name in the
    port's directory, is a miss, and loading it imports nothing of the
    reference or of jax (checked in a fresh interpreter)."""
    d = str(tmp_path)
    ref_plan = ref_build_plan(ref_rgg(200, seed=4))
    key = ref_cache.plan_key(ref_cache.graph_spec(200, seed=4))
    ref_cache.store_plan(key, ref_plan, cache_dir=d)
    assert key == plan_key(graph_spec(200, seed=4))
    assert load_plan(key, cache_dir=d) is None
    code = (
        "import sys; from repro_torch.core.plan_cache import load_plan, "
        "setup_plan; "
        f"assert load_plan({key!r}, cache_dir={d!r}) is None; "
        f"plan, info = setup_plan(200, graph_seed=4, cache_dir={d!r}); "
        "assert info['cache'] == 'miss', info; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
    # the port's store replaced the entry; now it hits
    _, info = setup_plan(200, graph_seed=4, cache_dir=d)
    assert info["cache"] == "hit"
