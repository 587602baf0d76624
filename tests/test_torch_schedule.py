"""The port's exchange schedule (`repro_torch.core.schedule`) against the
reference's, on the levels of the rgg500 plan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.schedule as R  # noqa: E402
import repro_torch.core.schedule as P  # noqa: E402
from repro.core import build_plan  # noqa: E402
from repro.kernels.pair_apply import pair_apply_ref  # noqa: E402
from repro_torch.core import prng  # noqa: E402


@pytest.fixture(autouse=True)
def _port_layout():
    """The port draws with jax's older threefry counter layout."""
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(scope="module")
def plan500(rgg500):
    return build_plan(rgg500, seed=0)


def _adjs(lp):
    arrays = (lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees, lp.n_nodes)
    ref = R.CsrGraphs(*(jnp.asarray(a, jnp.int32) for a in arrays))
    return ref, P.CsrGraphs(*arrays).to_device("cpu")


def _fields_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("loss_p", [None, 0.9])
@pytest.mark.parametrize("seed,t0", [(0, 0), (3, 128), (11, 4096)])
def test_sample_schedule_bitwise(plan500, seed, t0, loss_p):
    """Every field on every level.  With loss_p the hop outcomes go
    through floor(log u / log p); XLA's and torch's f32 log differ by one
    ulp on some inputs (see test_loss_outcomes_agree), yet no outcome
    flips on these draws, and equality is asserted."""
    for li, lp in enumerate(plan500.levels):
        ref_adj, adj = _adjs(lp)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), li)
        want = R.sample_schedule(jnp.arange(64) + t0, key, ref_adj, loss_p)
        got = P.sample_schedule(torch.arange(64) + t0,
                                prng.fold_in(prng.PRNGKey(seed), li), adj,
                                loss_p)
        _fields_equal(want, got)


def test_sample_tick_matches_and_batches(plan500):
    lp = plan500.levels[0]
    ref_adj, adj = _adjs(lp)
    keys = torch.stack([prng.PRNGKey(5), prng.PRNGKey(6)])
    batched = P.sample_tick(17, keys, adj, 0.8)       # trials batch (2, B)
    for r, seed in enumerate((5, 6)):
        want = R.sample_tick(17, jax.random.PRNGKey(seed), ref_adj, 0.8)
        got = P.sample_tick(17, prng.PRNGKey(seed), adj, 0.8)
        _fields_equal(want, got)
        _fields_equal(want, type(got)(*(f[r] for f in batched)))


@pytest.mark.parametrize("p", [0.3, 0.5, 0.9, 0.99])
def test_loss_outcomes_agree(p):
    """Flip rate of the loss model between XLA and torch: 0 of 400000
    draws (u = 0 and subnormals included), though the two f32 logs
    differ by one ulp on about 14% of inputs.  Any flip fails here."""
    rng = np.random.default_rng(int(p * 100))
    u = rng.uniform(size=400_000).astype(np.float32)
    u[:4] = [0.0, 1e-45, 1e-38, 0.99999994]
    h = rng.integers(1, 8, size=u.size).astype(np.int32)
    want = R.truncated_failure_hops(jnp.asarray(u), jnp.float32(p),
                                    jnp.asarray(h))
    got = P.truncated_failure_hops(torch.from_numpy(u), p, torch.from_numpy(h))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_compose_schedule_matches_reference():
    rng = np.random.default_rng(0)
    T, B, C, V = 48, 5, 11, 2
    i = rng.integers(0, C, (T, B)).astype(np.int32)
    j = rng.integers(0, C, (T, B)).astype(np.int32)
    ui = rng.uniform(size=(T, B)) < 0.8
    uj = rng.uniform(size=(T, B)) < 0.9
    want = np.asarray(R.compose_schedule(C, *map(jnp.asarray, (i, j, ui, uj))))
    got = P.compose_schedule(C, *map(torch.from_numpy, (i, j, ui, uj))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    # the composed matrix applies the chunk like the sequential recursion
    x = rng.normal(size=(B, C, V)).astype(np.float32)
    seq = np.asarray(pair_apply_ref(*map(jnp.asarray, (x, i, j, ui, uj))))
    np.testing.assert_allclose(np.einsum("bij,bjv->biv", got, x), seq,
                               rtol=2e-5, atol=2e-6)


def test_csr_helpers_match_reference(plan500):
    lp = plan500.levels[1]
    nbr, deg, hops = lp.neighbors, lp.degrees, lp.edge_hops
    for a, b in zip(R.dense_to_csr(nbr, deg, lp.n_nodes, hops),
                    P.dense_to_csr(nbr, deg, lp.n_nodes, hops)):
        np.testing.assert_array_equal(np.asarray(a), b)
    usage = np.arange(lp.nnz + 1, dtype=np.int32)
    np.testing.assert_array_equal(R.flat_usage_to_dense(usage, deg),
                                  P.flat_usage_to_dense(usage, deg))
