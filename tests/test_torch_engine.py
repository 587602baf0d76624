"""The port's executor (`repro_torch.core`) against the reference engine on
the rgg500 plan, on the CPU with the plain value pass.

The reference runs inside ``jax.threefry_partitionable(False)``, the
threefry counter layout the port draws with.  Fixed-iterations runs are
bitwise: x_final, messages, node_sends and the
per-level counters.  (The reference's vmapped T=3 run is bitwise equal to
its single runs here, so no tolerance is needed at T=3 either.)  Eps-mode
runs compare x_final with allclose, since the convergence check is an
f32 reduction whose order differs, and ticks within one chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402

CPU = dict(device="cpu")
FI = dict(eps=1e-3, fixed_ticks_scale=0.2)


@pytest.fixture(autouse=True)
def _port_layout():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(scope="module")
def plans(rgg500):
    ref = R.build_plan(rgg500, seed=0)
    return ref, P.plan_from_reference(ref)


def _assert_run_equal(want, got):
    np.testing.assert_array_equal(want.messages, got.messages)
    np.testing.assert_array_equal(want.node_sends, got.node_sends)
    np.testing.assert_array_equal(want.level_messages, got.level_messages)
    np.testing.assert_array_equal(want.level_ticks, got.level_ticks)
    np.testing.assert_array_equal(want.level_converged, got.level_converged)
    np.testing.assert_array_equal(want.x_final.view(np.int32),
                                  got.x_final.view(np.int32))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("trials", [1, 3])
def test_execute_plan_fi_bitwise(plans, x0_500, weighted, trials):
    ref, port = plans
    seeds = tuple(range(2, 2 + trials))
    want = R.execute_plan(
        ref, x0_500, seeds=seeds, weighted=weighted,
        options=R.ExecOptions(backend="lax", collect_usage=True), **FI)
    got = P.execute_plan(
        port, x0_500, seeds=seeds, weighted=weighted,
        options=P.ExecOptions(backend="ref", collect_usage=True, **CPU), **FI)
    _assert_run_equal(want, got)
    for u_ref, u_port in zip(want.edge_usage, got.edge_usage):
        np.testing.assert_array_equal(u_ref, u_port)


def test_multiscale_gossip_fi_bitwise(rgg500, x0_500):
    want = R.multiscale_gossip(rgg500, x0_500, seed=4, weighted=True, **FI)
    got = P.multiscale_gossip(rgg500, x0_500, seed=4, weighted=True,
                              options=P.ExecOptions(backend="ref", **CPU),
                              **FI)
    assert got.messages == want.messages
    np.testing.assert_array_equal(got.node_sends, want.node_sends)
    np.testing.assert_array_equal(got.x_final, want.x_final)
    np.testing.assert_array_equal(got.rep_counts, want.rep_counts)
    assert got.disconnected_cells == want.disconnected_cells
    for a, b in zip(want.levels, got.levels):
        assert (a.level, a.num_graphs, a.messages, a.max_ticks, a.max_hops,
                a.graph_sizes) == (b.level, b.num_graphs, b.messages,
                                   b.max_ticks, b.max_hops, b.graph_sizes)


def test_fi_with_message_loss_bitwise(plans, x0_500):
    ref, port = plans
    want = R.execute_plan(ref, x0_500, seeds=(0, 1),
                          failures=R.FailureModel(loss_p=0.9), **FI)
    got = P.execute_plan(port, x0_500, seeds=(0, 1),
                         failures=P.FailureModel(loss_p=0.9),
                         options=P.ExecOptions(backend="ref", **CPU), **FI)
    _assert_run_equal(want, got)


def test_older_threefry_layout_bitwise(plans, x0_500):
    """The large-n configuration's seed and defaults: weighted, seed 0,
    the reference's default backend."""
    ref, port = plans
    want = R.execute_plan(ref, x0_500, seeds=(0,), weighted=True, **FI)
    got = P.execute_plan(port, x0_500, seeds=(0,), weighted=True,
                         options=P.ExecOptions(backend="ref", **CPU), **FI)
    _assert_run_equal(want, got)


def test_eps_mode_allclose(plans, x0_500):
    ref, port = plans
    want = R.execute_plan(ref, x0_500, eps=1e-4, seeds=(0, 1), weighted=True)
    got = P.execute_plan(port, x0_500, eps=1e-4, seeds=(0, 1), weighted=True,
                         options=P.ExecOptions(backend="ref", **CPU))
    np.testing.assert_allclose(got.x_final, want.x_final, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(got.level_ticks - want.level_ticks).max() <= 64
    assert np.abs(got.messages - want.messages).max() <= (
        0.05 * want.messages.max())


def test_matmul_backend(plans, x0_500):
    ref, port = plans
    want = R.execute_plan(ref, x0_500, seeds=(0,), weighted=True,
                          options=R.ExecOptions(backend="matmul"), **FI)
    got = P.execute_plan(port, x0_500, seeds=(0,), weighted=True,
                         options=P.ExecOptions(backend="matmul", **CPU), **FI)
    np.testing.assert_array_equal(got.messages, want.messages)
    np.testing.assert_array_equal(got.node_sends, want.node_sends)
    np.testing.assert_allclose(got.x_final, want.x_final, atol=2e-4,
                               rtol=1e-4)


def test_gossip_until_fixed_ticks_bitwise(rgg500):
    nbr, deg, n_nodes, _ = R.batched_graphs([rgg500])
    x0 = np.random.default_rng(1).normal(size=(1, 500)).astype(np.float32)
    want = R.gossip_until(x0, nbr, deg, n_nodes, eps=1e-3, seed=9,
                          fixed_ticks=300, loss_p=0.95)
    got = P.gossip_until(x0, nbr, deg, n_nodes, eps=1e-3, seed=9,
                         fixed_ticks=300, loss_p=0.95, backend="ref", **CPU)
    for f in ("x", "ticks", "converged", "edge_usage", "messages"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f), f)


def test_synchronous_multiscale(rgg500, x0_500):
    want = R.synchronous_multiscale(rgg500, x0_500, eps=1e-4)
    got = P.synchronous_multiscale(rgg500, x0_500, eps=1e-4, **CPU)
    assert got.messages == want.messages
    assert got.rounds_per_level == want.rounds_per_level
    np.testing.assert_allclose(got.x_final, want.x_final, rtol=1e-5,
                               atol=1e-5)


def test_recorded_large_n_count_without_jax():
    """The repository's recorded n=20000 fixed-iterations run
    (benchmarks/artifacts/large_n_smoke.json: 1008706 messages) was drawn
    with the older threefry layout, the port's; the port reproduces it
    exactly."""
    n = 20000
    g = P.random_geometric_graph(n, seed=1000 + n)
    x0 = np.random.default_rng(n).normal(0, 1, n)
    res = P.multiscale_gossip(g, x0, seed=0, weighted=True,
                              options=P.ExecOptions(backend="ref", **CPU),
                              **FI)
    assert res.messages == 1008706
    assert abs(res.error(x0) - 0.0017078202335822647) <= 1e-6
