"""The port's chunk draw (`repro_torch.kernels.sample_chunk`) against the
reference's `sample_schedule` and the chunk accounting of its
`_presampled_chunk` (src/repro/core/gossip.py:281-286,311-313), on the
levels of the rgg500 plan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.schedule as R  # noqa: E402
from repro.core import build_plan  # noqa: E402
from repro_torch.core import CsrGraphs, prng  # noqa: E402
from repro_torch.kernels.sample_chunk import (  # noqa: E402
    sample_chunk,
    sample_chunk_ref,
)


@pytest.fixture(autouse=True)
def _port_layout():
    """The port draws with jax's older threefry counter layout."""
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(scope="module")
def plan500(rgg500):
    return build_plan(rgg500, seed=0)


def _reference_chunk(lp, keys, t0, T, loss_p, done):
    """The reference's draw of each trial, with the chunk accounting
    folded in numpy: (T, R, B) fields, (R, nflat) usage, (R, B) msgs."""
    arrays = (lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees, lp.n_nodes)
    adj = R.CsrGraphs(*(jnp.asarray(a, jnp.int32) for a in arrays))
    nflat = lp.nbr_flat.shape[0]
    fields = {k: [] for k in ("i", "j", "upd_i", "upd_j")}
    usage = np.zeros((len(keys), nflat), np.int32)
    msgs = np.zeros((len(keys), lp.num_graphs), np.int32)
    for r, key in enumerate(keys):
        s = R.sample_schedule(jnp.arange(T) + t0, key, adj, loss_p)
        s = type(s)(*map(np.asarray, s))
        active = s.valid & ~done[r][None, :]
        upd_j = active & s.fwd_ok
        upd_i = upd_j & s.rep_ok
        np.add.at(usage[r], s.pos.ravel(), active.ravel().astype(np.int32))
        msgs[r] = np.where(active, s.cost, 0).sum(0)
        for name, a in (("i", s.i), ("j", s.j), ("upd_i", upd_i),
                        ("upd_j", upd_j)):
            fields[name].append(a)
    return ({k: np.stack(v, 1) for k, v in fields.items()}, usage, msgs)


@pytest.mark.parametrize("trials", [1, 3])
@pytest.mark.parametrize("loss_p", [None, 0.9])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_sample_chunk_ref_bitwise_vs_reference(plan500, level, loss_p,
                                               trials):
    """Every level of plan500 (B = 142, 36, 9, 1: two odd), with and
    without loss, R trials of their own keys, a random `done` freeze;
    the counters start from nonzero values and gain exactly the
    reference's counts.  The op on CPU tensors gives the same."""
    lp = plan500.levels[level]
    B = lp.num_graphs
    rng = np.random.default_rng(level * 10 + trials)
    seeds = [int(s) for s in rng.integers(0, 2**31, trials)]
    done = rng.uniform(size=(trials, B)) < 0.3
    t0, T = 64 * (level + 1), 64
    want, want_usage, want_msgs = _reference_chunk(
        lp, [jax.random.fold_in(jax.random.PRNGKey(s), level) for s in seeds],
        t0, T, loss_p, done)

    adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees,
                    lp.n_nodes).to_device("cpu")
    keys = prng.fold_in(torch.stack([prng.PRNGKey(s) for s in seeds]), level)
    nflat = lp.nbr_flat.shape[0]
    usage0 = rng.integers(0, 100, trials * nflat).astype(np.int32)
    msgs0 = rng.integers(0, 100, (trials, B)).astype(np.int32)
    for fn in (sample_chunk_ref, sample_chunk):
        usage, msgs = torch.from_numpy(usage0.copy()), torch.from_numpy(
            msgs0.copy())
        got = fn(t0, T, keys, adj, loss_p, torch.from_numpy(done), usage,
                 msgs)
        for name, a in zip(("i", "j", "upd_i", "upd_j"), got):
            assert a.shape == (T, trials * B), name
            assert a.dtype == (torch.int32 if name in "ij" else torch.bool)
            np.testing.assert_array_equal(
                a.numpy().reshape(T, trials, B), want[name], err_msg=name)
        np.testing.assert_array_equal(usage.numpy(),
                                      usage0 + want_usage.ravel())
        np.testing.assert_array_equal(msgs.numpy(), msgs0 + want_msgs)


def test_sample_chunk_rejects_other_devices(plan500):
    lp = plan500.levels[0]
    adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees,
                    lp.n_nodes).to_device("meta")
    done = torch.zeros((1, lp.num_graphs), dtype=torch.bool, device="meta")
    usage = torch.zeros(lp.nbr_flat.shape[0], dtype=torch.int32,
                        device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sample_chunk(0, 8, prng.PRNGKey(0, "meta")[None], adj, None, done,
                     usage, torch.zeros((1, lp.num_graphs), dtype=torch.int32,
                                        device="meta"))
    assert sample_chunk.launches == 0
