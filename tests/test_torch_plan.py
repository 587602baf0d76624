"""The port's host stack (graph builder, planner) against the reference's,
bitwise, and `plan_from_reference` round trips."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402


def _assert_same(a, b, path="plan"):
    """Every dataclass field, array and scalar of `a` equals `b`'s,
    arrays bitwise and in the same dtype."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        names_b = {f.name for f in dataclasses.fields(b)}
        for f in dataclasses.fields(a):
            if f.name in ("exec_cache", "build_seconds"):
                continue
            assert f.name in names_b, f"{path}.{f.name}"
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{k}]")
    else:
        assert a == b, path


@pytest.fixture(scope="module", params=[500, 2000])
def graphs(request):
    n = request.param
    seed = 7 if n == 500 else 1000 + n
    return R.random_geometric_graph(n, seed=seed), \
        P.random_geometric_graph(n, seed=seed)


def test_random_geometric_graph_bitwise(graphs):
    ref, port = graphs
    _assert_same(ref, port, "graph")
    np.testing.assert_array_equal(ref.neighbors, port.neighbors)


@pytest.mark.parametrize("seed,rep_mode", [(0, "random"), (3, "first")])
def test_build_plan_bitwise(graphs, seed, rep_mode):
    ref, port = graphs
    want = R.build_plan(ref, seed=seed, rep_mode=rep_mode)
    got = P.build_plan(port, seed=seed, rep_mode=rep_mode)
    _assert_same(want, got)
    assert len(got.levels) >= 3


def test_plan_from_reference_round_trip(graphs):
    ref, port = graphs
    want = R.build_plan(ref, seed=0)
    got = P.plan_from_reference(want)
    assert isinstance(got, P.HierarchyPlan)
    assert not hasattr(got, "exec_cache")
    assert all(isinstance(lp, P.LevelPlan) for lp in got.levels)
    assert isinstance(got.graph, P.Graph)
    _assert_same(want, got)
    _assert_same(P.build_plan(port, seed=0), got)
    # copies, not views: the port's plan owns its arrays
    assert not np.shares_memory(got.levels[0].nbr_flat,
                                want.levels[0].nbr_flat)


def test_plan_from_reference_rejects_unknown_fields():
    @dataclasses.dataclass
    class Odd:
        surprise: int = 0

    with pytest.raises(ValueError):
        P.plan_from_reference(Odd())
