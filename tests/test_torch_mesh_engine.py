"""The port's executor on a process mesh (`ExecOptions(mesh=)`) against
its unsharded run and the reference's `execute_plan`, on the CPU.

Four ranks of one gloo process group, started once for the module
(`dist.ranks.run_ranks`), run every case; they import only the port
(the reference is imported in the test functions, in the pytest
process, under ``jax.threefry_partitionable(False)``).  The plans are
the reference's, carried into the port with `plan_from_reference`.

- the 1-dim trial mesh at n=90, 6 trials on 4 ranks (padded to 8),
  weighted, eps mode and FI: bitwise to the port's unsharded run; FI
  also bitwise to the reference, eps mode allclose to it as
  `test_torch_engine.test_eps_mode_allclose` holds it;
- a priced failure scenario (churn and a cost model) on the trial mesh,
  bitwise to unsharded, cost included;
- the ("trials", "nodes") 2 x 2 mesh at n=200, 3 trials, eps mode and
  FI, backends "ref" and "matmul": bitwise to the trial mesh and to the
  unsharded run;
- the guards: per_tick, collect_usage, a scenario and a cost model on
  the node mesh, and a 2-dim mesh with other dim names, raise ValueError.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.dist.ranks import run_ranks  # noqa: E402

RANKS = 4
TIMEOUT = 240  # seconds for the whole group (and each collective)
FI = dict(eps=1e-3, fixed_ticks_scale=1.0)
EPS = dict(eps=1e-4)
MODES = {"eps": EPS, "fi": FI}
CHURN = dict(churn_fraction=0.2, churn_time=0.5, seed=3)
COST = dict(retransmit_p=0.9, congestion_alpha=0.01)
FIELDS = ("x_final", "messages", "node_sends", "level_messages",
          "level_ticks", "level_converged")


def _fields(res) -> dict:
    out = {k: getattr(res, k) for k in FIELDS}
    if res.cost is not None:
        out.update(retransmissions=res.cost.retransmissions,
                   congestion=res.cost.congestion, energy=res.cost.energy)
    return out


def _guards(plan, x0, mesh2d, mesh_other) -> list:
    """Each refused combination: the error text, or None if it ran."""
    cases = [
        lambda: P.ExecOptions(backend="ref", device="cpu", mesh=mesh2d,
                              schedule="per_tick"),
        lambda: P.ExecOptions(backend="ref", device="cpu", mesh=mesh2d,
                              collect_usage=True),
        lambda: P.execute_plan(
            plan, x0, seeds=(0,), options=P.ExecOptions(
                backend="ref", device="cpu", mesh=mesh2d),
            failures=P.FailureModel(**CHURN), **FI),
        lambda: P.execute_plan(
            plan, x0, seeds=(0,), options=P.ExecOptions(
                backend="ref", device="cpu", mesh=mesh2d),
            cost=P.CostModel(**COST), **FI),
        lambda: P.ExecOptions(backend="ref", device="cpu", mesh=mesh_other),
    ]
    out = []
    for case in cases:
        try:
            case()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _rank(rank, world, plan90, x90, plan200, x200):
    """Every case on this rank: {case: result fields}."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(world)
    mesh1d = DeviceMesh("cpu", ranks, mesh_dim_names=("trials",))
    mesh2d = DeviceMesh("cpu", ranks.reshape(2, 2),
                        mesh_dim_names=("trials", "nodes"))
    other = DeviceMesh("cpu", ranks.reshape(2, 2),
                       mesh_dim_names=("data", "model"))
    out = {}
    for mode, kw in MODES.items():
        opts = P.ExecOptions(backend="ref", device="cpu", mesh=mesh1d)
        out["trial", mode] = _fields(P.execute_plan(
            plan90, x90, seeds=tuple(range(6)), weighted=True,
            options=opts, **kw))
    out["scenario"] = _fields(P.execute_plan(
        plan90, x90, seeds=tuple(range(6)), weighted=True,
        options=P.ExecOptions(backend="ref", device="cpu", mesh=mesh1d),
        failures=P.FailureModel(**CHURN), cost=P.CostModel(**COST), **FI))
    for backend in ("ref", "matmul"):
        for mode, kw in MODES.items():
            for name, mesh in (("node", mesh2d), ("trial200", mesh1d)):
                opts = P.ExecOptions(backend=backend, device="cpu",
                                     mesh=mesh)
                out[name, backend, mode] = _fields(P.execute_plan(
                    plan200, x200, seeds=(0, 1, 2), weighted=True,
                    options=opts, **kw))
    out["guards"] = _guards(plan200, x200, mesh2d, other)
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import repro.core as R

    with jax.threefry_partitionable(False):
        g90 = R.random_geometric_graph(90, seed=7)
        g200 = R.random_geometric_graph(200, seed=11)
        ref90, ref200 = R.build_plan(g90, seed=0), R.build_plan(g200, seed=0)
    x90 = np.random.default_rng(4).normal(0, 1, 90)
    x200 = np.random.default_rng(6).normal(0, 1, 200)
    plan90 = P.plan_from_reference(ref90)
    plan200 = P.plan_from_reference(ref200)
    results = run_ranks(_rank, RANKS, plan90, x90, plan200, x200,
                        backend="gloo", timeout=TIMEOUT, threads=1)
    return dict(ref90=ref90, plan90=plan90, x90=x90, plan200=plan200,
                x200=x200, results=results)


def _bitwise(want: dict, got: dict):
    assert set(want) == set(got)
    for k, a in want.items():
        a, b = np.asarray(a), np.asarray(got[k])
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=k)


def _unsharded(plan, x0, seeds, backend="ref", **kw):
    return _fields(P.execute_plan(
        plan, x0, seeds=seeds, weighted=True,
        options=P.ExecOptions(backend=backend, device="cpu"), **kw))


def test_ranks_agree(setup):
    """Every rank returns the same whole result in every case."""
    first = setup["results"][0]
    for other in setup["results"][1:]:
        assert set(other) == set(first)
        for case, fields in first.items():
            if case == "guards":
                assert other[case] == fields
            else:
                _bitwise(fields, other[case])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trial_mesh_bitwise_to_unsharded(setup, mode):
    got = setup["results"][0]["trial", mode]
    assert got["x_final"].shape == (6, 90)
    _bitwise(_unsharded(setup["plan90"], setup["x90"], tuple(range(6)),
                         **MODES[mode]), got)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trial_mesh_against_reference(setup, mode):
    import jax
    import repro.core as R

    with jax.threefry_partitionable(False):
        want = R.execute_plan(setup["ref90"], setup["x90"],
                              seeds=tuple(range(6)), weighted=True,
                              **MODES[mode])
    got = setup["results"][0]["trial", mode]
    if mode == "fi":
        _bitwise(_fields(want), got)
        return
    np.testing.assert_allclose(got["x_final"], want.x_final, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(got["level_ticks"] - want.level_ticks).max() <= 64
    assert np.abs(got["messages"] - want.messages).max() <= (
        0.05 * want.messages.max())


def test_priced_scenario_on_trial_mesh(setup):
    want = _unsharded(setup["plan90"], setup["x90"], tuple(range(6)),
                      failures=P.FailureModel(**CHURN),
                      cost=P.CostModel(**COST), **FI)
    assert "energy" in want
    _bitwise(want, setup["results"][0]["scenario"])


@pytest.mark.parametrize("backend", ["ref", "matmul"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_node_mesh_bitwise(setup, backend, mode):
    res = setup["results"][0]
    node = res["node", backend, mode]
    _bitwise(res["trial200", backend, mode], node)
    _bitwise(_unsharded(setup["plan200"], setup["x200"], (0, 1, 2),
                        backend=backend, **MODES[mode]), node)


@pytest.mark.parametrize("case", ["per_tick", "collect_usage", "scenario",
                                  "cost", "other_dims"])
def test_node_mesh_guards(setup, case):
    names = ["per_tick", "collect_usage", "scenario", "cost", "other_dims"]
    text = setup["results"][0]["guards"][names.index(case)]
    assert text is not None, f"{case} on the node mesh did not raise"
    want = {"per_tick": "presampled", "collect_usage": "collect_usage",
            "scenario": "not supported", "cost": "not supported",
            "other_dims": "('trials', 'nodes')"}[case]
    assert want in text
