"""The port's failure scenarios and medium pricing (`repro_torch.core`:
`medium`, `failures`, `scenarios`, the scenario and cost paths of
`execute_plan`) against the reference, on the CPU with the plain value
pass.

The reference runs inside ``jax.threefry_partitionable(False)``, the
threefry layout the port draws with.  Fixed-iterations scenario and
priced runs are bitwise: x_final, messages, node_sends, the level
counters, the sampled retransmissions and the congestion; energies are
f64 host sums, held to 1e-12 relative.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.medium import failure_sets  # noqa: E402

CPU = dict(device="cpu")
FI = dict(eps=1e-3, fixed_ticks_scale=0.2)
ARTIFACTS = Path(__file__).resolve().parents[1] / "benchmarks" / "artifacts"


@pytest.fixture(autouse=True)
def _port_layout():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(scope="module")
def plans(rgg500):
    ref = R.build_plan(rgg500, seed=0)
    return ref, P.plan_from_reference(ref)


def _scenario(pkg, name, loss_p):
    return {s.name: s for s in pkg.scenario_matrix(loss_p=loss_p)}[name]


def _assert_priced_equal(want, got):
    np.testing.assert_array_equal(want.x_final.view(np.int32),
                                  got.x_final.view(np.int32))
    for f in ("messages", "node_sends", "level_messages", "level_ticks",
              "level_converged"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f), f)
    if want.cost is None:
        assert got.cost is None
        return
    for f in ("transmissions", "retransmissions", "congestion"):
        np.testing.assert_array_equal(getattr(want.cost, f),
                                      getattr(got.cost, f), f)
    for f in ("energy", "level_energy"):
        np.testing.assert_allclose(getattr(got.cost, f),
                                   getattr(want.cost, f), rtol=1e-12,
                                   atol=0, err_msg=f)


# every scenario with and without loss; across them, weighted and not,
# R 1 and 3, the retransmissions sampled and closed-form, congestion
# priced and not
SCENARIOS = ("baseline", "churn", "stragglers", "regional", "byzantine")
CASES = [(name, loss_p, bool((k + (loss_p is None)) % 2), (1, 3)[k % 2],
          bool(k < 3) != bool(loss_p), (0.0, 0.01)[(k + 1) % 3 > 0])
         for loss_p in (None, 0.9) for k, name in enumerate(SCENARIOS)]


@pytest.mark.parametrize("name,loss_p,weighted,trials,sample,alpha", CASES)
def test_execute_plan_scenario_priced_bitwise(plans, x0_500, name, loss_p,
                                              weighted, trials, sample,
                                              alpha):
    ref, port = plans
    seeds = tuple(range(3, 3 + trials))
    kw = dict(seeds=seeds, weighted=weighted, **FI)
    want = R.execute_plan(
        ref, x0_500, failures=_scenario(R, name, loss_p).failures,
        cost=R.CostModel(retransmit_p=0.9, congestion_alpha=alpha,
                         sample=sample), **kw)
    got = P.execute_plan(
        port, x0_500, failures=_scenario(P, name, loss_p).failures,
        cost=P.CostModel(retransmit_p=0.9, congestion_alpha=alpha,
                         sample=sample),
        options=P.ExecOptions(backend="ref", **CPU), **kw)
    _assert_priced_equal(want, got)


def test_case_table_covers_every_setting():
    seen = {k: {c[i] for c in CASES} for i, k in enumerate(
        ("name", "loss_p", "weighted", "trials", "sample", "alpha"))}
    assert seen == {"name": set(SCENARIOS), "loss_p": {None, 0.9},
                    "weighted": {False, True}, "trials": {1, 3},
                    "sample": {False, True}, "alpha": {0.0, 0.01}}
    for loss_p in (None, 0.9):
        assert {c[0] for c in CASES if c[1] == loss_p} == set(SCENARIOS)


@pytest.mark.parametrize("name", ["churn", "byzantine"])
def test_scenario_without_cost_bitwise(plans, x0_500, name):
    ref, port = plans
    want = R.execute_plan(ref, x0_500, seeds=(0,),
                          failures=_scenario(R, name, None).failures, **FI)
    got = P.execute_plan(port, x0_500, seeds=(0,),
                         failures=_scenario(P, name, None).failures,
                         options=P.ExecOptions(backend="ref", **CPU), **FI)
    _assert_priced_equal(want, got)


@pytest.mark.parametrize("name", ["baseline", "churn", "stragglers"])
def test_pricing_leaves_the_trajectory_alone(plans, x0_500, name):
    """The cost model's streams are disjoint from the exchange streams:
    x_final and every counter are bitwise those of the unpriced run."""
    _, port = plans
    kw = dict(seeds=(0, 1), weighted=True,
              failures=_scenario(P, name, None).failures,
              options=P.ExecOptions(backend="ref", **CPU), **FI)
    plain = P.execute_plan(port, x0_500, **kw)
    priced = P.execute_plan(
        port, x0_500, cost=P.CostModel(retransmit_p=0.5,
                                       congestion_alpha=0.1), **kw)
    np.testing.assert_array_equal(plain.x_final.view(np.int32),
                                  priced.x_final.view(np.int32))
    for f in ("messages", "node_sends", "level_messages"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(priced, f))
    assert plain.cost is None
    np.testing.assert_array_equal(priced.cost.transmissions, plain.messages)
    assert (priced.cost.retransmissions > 0).all()
    assert (priced.cost.congestion > 0).all()


@pytest.mark.parametrize("name", ["churn", "byzantine"])
def test_matmul_backend_under_scenario(plans, x0_500, name):
    """The matmul backend: integer accounting exact, values at
    `test_matmul_backend`'s tolerance (matrix composition reassociates
    the f32 sums)."""
    ref, port = plans
    cost = dict(retransmit_p=0.9, congestion_alpha=0.01)
    want = R.execute_plan(ref, x0_500, seeds=(0,), weighted=True,
                          failures=_scenario(R, name, None).failures,
                          cost=R.CostModel(**cost),
                          options=R.ExecOptions(backend="matmul"), **FI)
    got = P.execute_plan(port, x0_500, seeds=(0,), weighted=True,
                         failures=_scenario(P, name, None).failures,
                         cost=P.CostModel(**cost),
                         options=P.ExecOptions(backend="matmul", **CPU), **FI)
    for f in ("messages", "node_sends", "level_messages"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f), f)
    for f in ("retransmissions", "congestion"):
        np.testing.assert_array_equal(getattr(want.cost, f),
                                      getattr(got.cost, f), f)
    np.testing.assert_allclose(got.x_final, want.x_final, atol=2e-4,
                               rtol=1e-4)


def test_multiscale_gossip_carries_cost(rgg500, x0_500):
    kw = dict(seed=2, weighted=True,
              failures=_scenario(P, "regional", None).failures, **FI)
    cost = P.CostModel(retransmit_p=0.8, congestion_alpha=0.01)
    want = R.multiscale_gossip(
        rgg500, x0_500, trials=2, cost=R.CostModel(
            retransmit_p=0.8, congestion_alpha=0.01),
        failures=_scenario(R, "regional", None).failures,
        **{k: v for k, v in kw.items() if k != "failures"})
    got = P.multiscale_gossip(rgg500, x0_500, trials=2, cost=cost,
                              options=P.ExecOptions(backend="ref", **CPU),
                              **kw)
    np.testing.assert_array_equal(want.messages, got.messages)
    np.testing.assert_array_equal(want.cost.retransmissions,
                                  got.cost.retransmissions)
    np.testing.assert_array_equal(want.cost.congestion, got.cost.congestion)
    one = P.multiscale_gossip(rgg500, x0_500, cost=cost,
                              options=P.ExecOptions(backend="ref", **CPU),
                              **kw)
    assert one.cost.energy.shape == (1,)
    assert one.cost.energy[0] == got.cost.energy[0]


# ---------------------------------------------------------------- guards


@pytest.mark.parametrize("pkg", [R, P], ids=["reference", "port"])
def test_engine_guards_match_reference(plans, x0_500, pkg):
    plan = plans[0] if pkg is R else plans[1]
    opts = ({} if pkg is R
            else dict(options=P.ExecOptions(backend="ref", **CPU)))
    with pytest.raises(ValueError, match="fixed_ticks_scale > 0"):
        pkg.execute_plan(plan, x0_500, eps=1e-3,
                         failures=pkg.FailureModel(churn_fraction=0.1),
                         **opts)
    with pytest.raises(ValueError, match="per-edge loss_p"):
        pkg.execute_plan(plan, x0_500, failures=pkg.FailureModel(
            loss_p=(0.9, 0.8)), **FI, **opts)
    with pytest.raises(ValueError, match="per-edge hop_energy"):
        pkg.execute_plan(plan, x0_500, cost=pkg.CostModel(
            hop_energy=(1.0, 2.0)), **FI, **opts)
    with pytest.raises(ValueError, match="run_scenario_matrix requires"):
        pkg.run_scenario_matrix(plan.graph, x0_500, fixed_ticks_scale=0.0,
                                plan=plan)


def test_price_messages_needs_rng():
    for pkg in (R, P):
        with pytest.raises(ValueError, match="explicit rng"):
            pkg.price_messages(100, pkg.CostModel(retransmit_p=0.9))
        with pytest.raises(ValueError, match="bare message count"):
            pkg.price_messages(100, pkg.CostModel(hop_energy=(1.0,)))


# --------------------------------------------------------- host functions


def _cost_equal(want, got):
    for f in ("transmissions", "retransmissions", "congestion", "energy",
              "level_energy"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f), f)


@pytest.mark.parametrize("messages", [0, 1234, [10, 0, 99999]])
@pytest.mark.parametrize("retransmit_p,sample", [(1.0, True), (0.7, True),
                                                 (0.7, False)])
def test_price_messages(messages, retransmit_p, sample):
    kw = dict(hop_energy=1.5, retransmit_p=retransmit_p, sample=sample)
    want = R.price_messages(messages, R.CostModel(**kw),
                            np.random.default_rng(4))
    got = P.price_messages(messages, P.CostModel(**kw),
                           np.random.default_rng(4))
    _cost_equal(want, got)


@pytest.mark.parametrize("transmissions,p,rng", [
    (0, 0.5, None), (1000, 1.0, None), (1000, 0.6, None), (1000, 0.6, 7),
    (37, 0.05, 3)])
def test_handshake_cost(transmissions, p, rng):
    def call(pkg):
        r = None if rng is None else np.random.default_rng(rng)
        return pkg.handshake_cost(transmissions, p, r)

    assert call(P) == call(R)
    for pkg in (R, P):
        with pytest.raises(ValueError, match="success probability"):
            pkg.handshake_cost(10, 0.0)


@pytest.fixture(scope="module")
def overlay_usage(plans, x0_500):
    """Per-level flat usage of one FI run (the reference's), for the
    per-edge pricing functions."""
    ref, port = plans
    res = R.execute_plan(ref, x0_500, seeds=(0, 1),
                         options=R.ExecOptions(collect_usage=True), **FI)
    return [np.asarray(u) for u in res.edge_usage]


@pytest.mark.parametrize("level", [1, 2, 3])
def test_route_and_level_edge_messages(plans, overlay_usage, level):
    ref, port = plans
    np.testing.assert_array_equal(
        R.route_edge_transmissions(ref.levels[level]),
        P.route_edge_transmissions(port.levels[level]))
    usage = overlay_usage[level]
    for u in (usage, usage[0]):
        np.testing.assert_array_equal(
            R.level_edge_messages(ref.levels[level], u),
            P.level_edge_messages(port.levels[level], u))


def test_route_edge_transmissions_rejects_cell_levels(plans):
    for pkg, plan in zip((R, P), plans):
        with pytest.raises(ValueError, match="route-incidence"):
            pkg.route_edge_transmissions(plan.levels[0])


@pytest.mark.parametrize("per_edge", ["hop_energy", "loss_p", "both"])
def test_price_edge_messages(plans, overlay_usage, per_edge):
    ref, port = plans
    em = R.level_edge_messages(ref.levels[1], overlay_usage[1])
    E = em.shape[1]
    rng = np.random.default_rng(E)
    he = tuple(rng.uniform(0.5, 2.0, E)) if per_edge != "loss_p" else 1.3
    lp = tuple(rng.uniform(0.6, 1.0, E)) if per_edge != "hop_energy" else 0.8
    outs = []
    for pkg in (R, P):
        model = pkg.CostModel(hop_energy=he, retransmit_p=0.9, sample=False)
        outs.append(pkg.price_edge_messages(em, model,
                                            pkg.FailureModel(loss_p=lp)))
        with pytest.raises(ValueError, match="closed-form only"):
            pkg.price_edge_messages(em, pkg.CostModel(retransmit_p=0.9))
        with pytest.raises(ValueError, match="entries"):
            pkg.price_edge_messages(em[:, :-1], model,
                                    pkg.FailureModel(loss_p=lp))
    _cost_equal(*outs)


@pytest.mark.parametrize("model", [
    dict(),
    dict(churn_fraction=0.2, seed=3),
    dict(straggler_fraction=0.3, drop_fraction=0.1, seed=1),
    dict(regional_radius=0.25, seed=5),
    dict(churn_fraction=0.5, straggler_fraction=0.5, drop_fraction=0.5,
         regional_radius=0.4, seed=9),
])
def test_failure_sets(rgg500, model):
    want = failure_sets(R.FailureModel(**model), rgg500.n, rgg500.coords)
    got = P.failure_sets(P.FailureModel(**model), rgg500.n, rgg500.coords)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], k)


def test_failure_ctx_packs_and_unpacks():
    rng = np.random.default_rng(0)
    masks = [rng.uniform(size=(5, 7)) < 0.4 for _ in range(4)]
    ctx = P.FailureCtx.from_masks(*masks, 3, 1, 9, 0.25)
    assert ctx.bits.dtype == torch.uint8 and ctx.bits.shape == (5, 7)
    for name, m in zip(("churned", "straggler", "byz", "regional"), masks):
        np.testing.assert_array_equal(getattr(ctx, name).numpy(), m)
    assert (ctx.churn_tick, ctx.reg_t0, ctx.reg_t1,
            ctx.straggler_success) == (3, 1, 9, 0.25)


# ----------------------------------------------------- run_scenario_matrix


@pytest.fixture(scope="module")
def fig5_smoke():
    """fig5_smoke's scenario matrix (benchmarks/fig5_failures.py:121-128
    at n=300, trials 2, fixed_ticks_scale 0.25), run by the reference
    and by the port."""
    n = 300
    kw = dict(eps=1e-4, trials=2, seed=0, weighted=True,
              fixed_ticks_scale=0.25)
    x0 = np.random.default_rng(3).normal(0, 1, n)
    with jax.threefry_partitionable(False):
        g = R.random_geometric_graph(n, seed=21)
        want = R.run_scenario_matrix(
            g, x0, R.scenario_matrix(), plan=R.build_plan(g, seed=0),
            cost=R.CostModel(retransmit_p=0.9, congestion_alpha=0.01), **kw)
    got = P.run_scenario_matrix(
        P.random_geometric_graph(n, seed=21), x0, P.scenario_matrix(),
        cost=P.CostModel(retransmit_p=0.9, congestion_alpha=0.01),
        options=P.ExecOptions(backend="ref", **CPU), **kw)
    return want, got


def test_run_scenario_matrix_matches_reference(fig5_smoke):
    want, got = fig5_smoke
    assert [r.scenario.name for r in got] == list(SCENARIOS)
    for a, b in zip(want, got):
        assert a.scenario.name == b.scenario.name
        assert a.scenario.description == b.scenario.description
        assert a.seeds == b.seeds
        np.testing.assert_array_equal(a.messages, b.messages)
        np.testing.assert_array_equal(a.errors, b.errors)
        np.testing.assert_array_equal(a.survivor_errors, b.survivor_errors)
        for f in ("retransmissions", "congestion"):
            np.testing.assert_array_equal(getattr(a.cost, f),
                                          getattr(b.cost, f))
        np.testing.assert_allclose(b.cost.energy, a.cost.energy,
                                   rtol=1e-12, atol=0)
        assert a.energy_mean == pytest.approx(b.energy_mean, rel=1e-12)


def test_run_scenario_matrix_reproduces_recorded_fig5_smoke(fig5_smoke):
    """benchmarks/artifacts/fig5_smoke.json was drawn with the older
    threefry layout, the port's: its scenario counts reproduce exactly."""
    _, got = fig5_smoke
    rec = json.loads((ARTIFACTS / "fig5_smoke.json").read_text())
    rec = rec["scenario_matrix"]["scenarios"]
    for r in got:
        row = rec[r.scenario.name]
        assert float(r.messages.mean()) == row["messages_mean"]
        assert float(r.cost.retransmissions.mean()) == row[
            "retransmissions_mean"]
        assert float(r.cost.congestion.mean()) == pytest.approx(
            row["congestion_mean"], rel=1e-12)
        assert r.err_mean == pytest.approx(row["err_mean"], rel=1e-12)
        assert float(r.survivor_errors.mean()) == pytest.approx(
            row["survivor_err_mean"], rel=1e-12)
