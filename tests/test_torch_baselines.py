"""The port's baselines (`repro_torch.core.baselines`) against the
reference's, on the same graphs and seeds.

`path_averaging` and `geographic_gossip` are host numpy in both
packages, so they are bitwise: x, messages, iterations, convergence and
per-node sends.  `standard_gossip` goes through each package's
`gossip_until` (the port's on backend ``"ref"`` on the CPU here), inside
``jax.threefry_partitionable(False)``, the threefry layout the port
draws with.  Its counts are exact; its stopping chunk is an eps-oracle
decision on an f32 reduction summed in another order, so x is held to
1e-6 and the test asserts that the reference's error at the stopping
check, and at the check before it, are not ties with the tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402

CPU = dict(backend="ref", device="cpu")


@pytest.fixture(autouse=True)
def _port_layout():
    with jax.threefry_partitionable(False):
        yield


def _assert_same(want, got):
    assert got.messages == want.messages
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    np.testing.assert_array_equal(got.node_sends, want.node_sends)
    np.testing.assert_array_equal(got.x.view(np.int64), want.x.view(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("loss_p", [None, 0.9])
def test_path_averaging_bitwise(rgg500, x0_500, loss_p, seed):
    kw = dict(eps=1e-3, seed=seed, loss_p=loss_p, max_iters=20_000)
    want = R.path_averaging(rgg500, x0_500, **kw)
    got = P.path_averaging(rgg500, x0_500, **kw)
    _assert_same(want, got)
    assert got.error(x0_500) == want.error(x0_500)


@pytest.mark.parametrize("seed", [0, 3])
def test_geographic_gossip_bitwise(rgg500, x0_500, seed):
    kw = dict(eps=1e-2, seed=seed, max_iters=200_000)
    want = R.geographic_gossip(rgg500, x0_500, **kw)
    got = P.geographic_gossip(rgg500, x0_500, **kw)
    _assert_same(want, got)


def test_path_averaging_runs_out_of_budget_like_reference(rgg500, x0_500):
    kw = dict(eps=1e-9, seed=2, max_iters=100, check_every=32)
    want = R.path_averaging(rgg500, x0_500, **kw)
    got = P.path_averaging(rgg500, x0_500, **kw)
    assert not got.converged and got.iterations == 128
    _assert_same(want, got)


def test_recorded_fig5_path_averaging_without_jax():
    """benchmarks/artifacts/fig5_failures.json records the reliable
    path-averaging messages of fig5 (n=2000, graph seed 21, x0 from
    default_rng(3), eps 1e-4, seeds 0-2): the port reproduces them."""
    n = 2000
    g = P.random_geometric_graph(n, seed=21)
    x0 = np.random.default_rng(3).normal(0, 1, n)
    got = [P.path_averaging(g, x0, eps=1e-4, seed=s).messages
           for s in range(3)]
    assert got == [180806, 170008, 182362]


def _error(x, x0):
    """The oracle's error, as gossip_core forms it in f32."""
    x = np.asarray(x, np.float32)
    return float(np.sqrt(((x - np.float32(x0.mean())) ** 2).sum()))


@pytest.mark.parametrize("seed", [0, 5])
def test_standard_gossip(rgg500, seed):
    x0 = np.random.default_rng(seed).normal(size=rgg500.n).astype(np.float32)
    eps = 1e-2
    want = R.standard_gossip(rgg500, x0, eps=eps, seed=seed)
    got = P.standard_gossip(rgg500, x0, eps=eps, seed=seed, **CPU)
    assert got.converged and want.converged
    assert got.messages == want.messages
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.node_sends, want.node_sends)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-6)
    # neither the stopping check nor the one before it is a tie
    tol = eps * float(np.sqrt((x0.astype(np.float32) ** 2).sum()))
    nbr, deg, n_nodes, _ = R.batched_graphs([rgg500])
    before = R.gossip_until(x0[None], nbr, deg, n_nodes, eps=eps, seed=seed,
                            fixed_ticks=want.iterations - 64)
    assert abs(_error(want.x, x0) / tol - 1) > 1e-4
    assert _error(before.x[0, :, 0], x0) / tol - 1 > 1e-4


def test_standard_gossip_on_the_card_by_default(rgg500, x0_500):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-CUDA guard does not apply")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.standard_gossip(rgg500, x0_500, eps=1e-2)
    with pytest.raises(ValueError, match="needs device='cuda'"):
        P.standard_gossip(rgg500, x0_500, eps=1e-2, backend="cuda",
                          device="cpu")
