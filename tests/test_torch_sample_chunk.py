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


# (T, R, B, C, nflat, sms, mode) -> (kernel, G, lanes, runs, threads,
# window): the n=1e5 finest level without and with a scenario or loss;
# its top level; one chunk of the R=1024 control round's finest level;
# an odd T; a draw past 2^31 words
_SHAPES = [
    ((50, 1, 43250, 9, 199457, 132, 0), (0, 164, 5, 132, 832, 1664)),
    ((50, 1, 43250, 9, 199457, 132, 1), (1, 164, 1, 132, 608, 1664)),
    ((50, 1, 43250, 9, 199457, 132, 2), (2, 164, 1, 132, 608, 1664)),
    ((64, 1, 1, 49, 169, 132, 0), (0, 1, 32, 1, 64, 0)),
    ((64, 1, 1, 49, 169, 132, 1), (1, 1, 1, 1, 64, 0)),
    ((64, 1028, 485, 7, 6311, 132, 0), (0, 243, 4, 1, 992, 6816)),
    ((49, 4, 12539, 4, 75279, 132, 0), (0, 190, 5, 33, 960, 2688)),
    ((64, 1028, 43250, 9, 199457, 132, 1), (3, 503, 1, 43, 640, 5056)),
]


@pytest.mark.parametrize("args,want", _SHAPES)
def test_launch_shape(args, want):
    """The host's choice of the kernel's launch at the shapes the card
    draws (`ops.launch_shape`)."""
    from repro_torch.kernels.sample_chunk.ops import launch_shape

    assert tuple(launch_shape(*args)) == want


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("T", [1, 2, 49, 50, 64, 130])
@pytest.mark.parametrize("R,B", [(1, 1), (1, 2), (3, 7), (1, 43250),
                                 (2, 43250), (4, 12539), (260, 485),
                                 (1028, 485), (300, 3136)])
def test_launch_shape_limits(mode, T, R, B):
    """Every launch stays inside what csrc/sample_chunk.cu accepts: the
    runs cover the pairs, a block's pairs and threads within the caps, a
    lane a pair's threads, and the grid at least the card."""
    from repro_torch.kernels.sample_chunk.ops import launch_shape

    C, nflat, sms = 9, 5 * B + 1, 132
    kernel, G, lanes, runs, threads, window = launch_shape(
        T, R, B, C, nflat, sms, mode)
    half = (B + 1) // 2
    assert kernel == (3 if T * R * B > 2**31 - 1 else mode)
    assert 1 <= G <= 512 and runs * G >= half > (runs - 1) * G
    assert threads % 32 == 0 and max(64, G * lanes) <= threads
    assert threads <= (1024 if mode == 0 else 640)
    assert lanes >= 1 and (mode == 0 or lanes == 1)
    if mode == 0:  # the lanes' turns over a tile differ by one at most
        slots = min(32, (T + 1) // 2)
        assert -(-slots // lanes) == -(-slots // (1024 // G))
    assert R * runs >= min(sms, R * half)
    assert 0 <= window <= 8192 and window % 32 == 0
    assert (window == 0) == (R * runs < sms)


def test_launch_shape_matches_the_kernel_source():
    """ops.py mirrors the kernel's caps (csrc/sample_chunk.cu)."""
    import re
    from pathlib import Path

    from repro_torch.kernels.sample_chunk import ops

    src = (Path(ops.__file__).resolve().parents[2] / "csrc"
           / "sample_chunk.cu").read_text()
    got = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (got["kMaxThreads"], got["kFullThreads"], got["kMaxPairs"],
            got["kTileSlots"], got["kMaxWindow"]) == (
        ops._MAX_THREADS, ops._FULL_THREADS, ops._MAX_PAIRS, ops._TILE,
        ops._MAX_WINDOW)


@pytest.fixture(scope="module")
def port_plan500():
    import repro_torch.core as P

    return P.build_plan(P.random_geometric_graph(500, seed=7), seed=0)


@pytest.mark.parametrize("which", ["port", "reference"])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_plan_lays_each_graphs_edges_out_in_one_run(plan500, port_plan500,
                                                    level, which):
    """What the kernel's shared-memory usage window relies on: graph b's
    edges are exactly [nbr_start[b, 0], nbr_start[b+1, 0]) (the last
    graph's run ends at the flat arrays' sentinel), each row's edges
    following the one before, so a block owning graphs [b0, b1) finds
    every edge it draws in [nbr_start[b0, 0], nbr_start[b1, 0])."""
    lp = (port_plan500 if which == "port" else plan500).levels[level]
    start = np.asarray(lp.nbr_start, np.int64)
    deg = np.asarray(lp.degrees, np.int64)
    B = lp.num_graphs
    assert start.shape == deg.shape == (B, lp.degrees.shape[1])
    nnz = lp.nbr_flat.shape[0] - 1  # one trailing sentinel entry
    assert nnz == int(deg.sum())
    ends = np.append(start[1:, 0], nnz)
    for b in range(B):
        # each row starts where the one before ends
        np.testing.assert_array_equal(start[b, 1:], start[b, :-1]
                                      + deg[b, :-1])
        assert start[b, 0] + deg[b].sum() == ends[b]
    assert start[0, 0] == 0


def _random_ctx(rng, lp, T, t0):
    """Random failure flags on the level's slots (a fifth of each), with
    the churn tick and the regional window inside the chunk."""
    B, C = lp.node_mask.shape
    masks = [rng.uniform(size=(B, C)) < 0.2 for _ in range(4)]
    windows = (t0 + T // 2, t0 + T // 4, t0 + 3 * T // 4)
    return masks, windows


def _reference_scenario_chunk(lp, keys, t0, T, loss_p, done, masks, windows,
                              success, cost, hop_cap):
    """The reference's chunk body with a scenario and a cost model
    (src/repro/core/gossip.py:281-330), one trial at a time in jax:
    (T, R, B) update bits, (R, nflat) usage, (R, B) msgs, retx and
    congestion pairs."""
    from repro.core.medium import _TAG_RETX, _TAG_STRAGGLER

    arrays = (lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees, lp.n_nodes)
    adj = R.CsrGraphs(*(jnp.asarray(a, jnp.int32) for a in arrays))
    churned, straggler, byz, regional = (jnp.asarray(m) for m in masks)
    churn_tick, reg_t0, reg_t1 = windows
    out = {k: [] for k in ("i", "j", "upd_i", "upd_j", "usage", "msgs",
                           "retx", "congp")}
    for r, key in enumerate(keys):
        ts = jnp.arange(T) + t0
        s = R.sample_schedule(ts, key, adj, loss_p)
        active = s.valid & ~jnp.asarray(done[r])[None, :]
        bcols = jnp.arange(active.shape[1])[None, :]
        when = ts[:, None]
        churn_now = when >= churn_tick
        reg_now = (when >= reg_t0) & (when < reg_t1)
        down_i = (churned[bcols, s.i] & churn_now) | (
            regional[bcols, s.i] & reg_now)
        down_j = (churned[bcols, s.j] & churn_now) | (
            regional[bcols, s.j] & reg_now)
        attempt = active & ~down_i
        delivered = attempt & ~down_j
        slow = straggler[bcols, s.i] | straggler[bcols, s.j]
        if success < 1.0:
            ku = jax.random.fold_in(jax.random.fold_in(key, _TAG_STRAGGLER),
                                    t0)
            u = jax.random.uniform(ku, active.shape)
            delivered = delivered & (~slow | (u < success))
        upd_j = delivered & s.fwd_ok & ~byz[bcols, s.j]
        upd_i = delivered & s.fwd_ok & s.rep_ok & ~byz[bcols, s.i]
        cost_t = jnp.where(attempt & ~down_j, s.cost, adj.hops[s.pos])
        usage = jnp.zeros(lp.nbr_flat.shape, jnp.int32).at[s.pos].add(
            attempt.astype(jnp.int32))
        hops_t = jnp.where(attempt, cost_t, 0)
        kr = jax.random.fold_in(jax.random.fold_in(key, _TAG_RETX), t0)
        q = 1.0 - cost.retransmit_p
        u = jnp.maximum(
            jax.random.uniform(kr, (*hops_t.shape, 2 * hop_cap)), 1e-12)
        g = jnp.floor(jnp.log(u) / jnp.log(q)).astype(jnp.int32)
        m = jnp.arange(2 * hop_cap)[None, None, :] < hops_t[..., None]
        conc = attempt.sum(1)
        pairs = (attempt * jnp.maximum(conc - 1, 0)[:, None]).sum(0)
        for name, a in (("i", s.i), ("j", s.j), ("upd_i", upd_i),
                        ("upd_j", upd_j), ("usage", usage),
                        ("msgs", hops_t.sum(0)),
                        ("retx", jnp.where(m, g, 0).sum((0, 2))),
                        ("congp", pairs.astype(jnp.float32))):
            out[name].append(np.asarray(a))
    return {k: np.stack(v, 1 if k in ("i", "j", "upd_i", "upd_j") else 0)
            for k, v in out.items()}


@pytest.mark.parametrize("success", [0.25, 1.0])
@pytest.mark.parametrize("loss_p", [None, 0.9])
@pytest.mark.parametrize("T", [63, 64])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_sample_chunk_ref_scenario_bitwise_vs_reference(plan500, level, T,
                                                        loss_p, success):
    """With a scenario (a fifth of the slots churned, straggling,
    Byzantine and regional, the churn tick and the regional window inside
    the chunk) and a sampling cost model with congestion, at every
    plan500 level (T=63 makes T*B odd at the odd-B levels, so the
    straggler stream's last counter pair hashes (c, 0)), two trials: the
    plain version gives the reference's chunk bit for bit, its counters
    growing from nonzero values.  The op on CPU tensors gives the same."""
    from repro_torch.core import CostModel, FailureCtx

    lp = plan500.levels[level]
    B = lp.num_graphs
    hop_cap = max(1, int(lp.max_hops))
    rng = np.random.default_rng(100 + level * 10 + T)
    trials = 2
    seeds = [int(s) for s in rng.integers(0, 2**31, trials)]
    done = rng.uniform(size=(trials, B)) < 0.2
    t0 = 64 * (level + 1)
    masks, windows = _random_ctx(rng, lp, T, t0)
    cost = CostModel(retransmit_p=0.9, congestion_alpha=0.01)
    want = _reference_scenario_chunk(
        lp, [jax.random.fold_in(jax.random.PRNGKey(s), level) for s in seeds],
        t0, T, loss_p, done, masks, windows, success, cost, hop_cap)

    adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees,
                    lp.n_nodes).to_device("cpu")
    keys = prng.fold_in(torch.stack([prng.PRNGKey(s) for s in seeds]), level)
    ctx = FailureCtx.from_masks(*masks, *windows, success)
    nflat = lp.nbr_flat.shape[0]
    start = {name: rng.integers(0, 100, shape).astype(dtype) for name, shape,
             dtype in (("usage", trials * nflat, np.int32),
                       ("msgs", (trials, B), np.int32),
                       ("retx", (trials, B), np.int32),
                       ("congp", (trials, B), np.float32))}
    for fn in (sample_chunk_ref, sample_chunk):
        counts = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
        got = fn(t0, T, keys, adj, loss_p, torch.from_numpy(done),
                 counts["usage"], counts["msgs"], failure_ctx=ctx, cost=cost,
                 hop_cap=hop_cap, retx=counts["retx"], congp=counts["congp"])
        for name, a in zip(("i", "j", "upd_i", "upd_j"), got):
            np.testing.assert_array_equal(
                a.numpy().reshape(T, trials, B), want[name], err_msg=name)
        np.testing.assert_array_equal(
            counts["usage"].numpy(), start["usage"] + want["usage"].ravel())
        for name in ("msgs", "retx"):
            np.testing.assert_array_equal(
                counts[name].numpy(), start[name] + want[name], err_msg=name)
        np.testing.assert_array_equal(
            counts["congp"].numpy().view(np.int32),
            (start["congp"] + want["congp"]).view(np.int32))


def test_sample_chunk_ref_without_scenario_or_cost_is_unchanged(plan500):
    """A cost model that neither samples nor prices congestion, and a
    scenario with no flag set, leave the draw exactly as without them."""
    from repro_torch.core import CostModel, FailureCtx

    lp = plan500.levels[0]
    B, C = lp.node_mask.shape
    adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees,
                    lp.n_nodes).to_device("cpu")
    keys = prng.fold_in(prng.PRNGKey(5)[None], 0)
    done = torch.zeros((1, B), dtype=torch.bool)
    none = np.zeros((B, C), bool)
    outs = []
    for kw in ({}, dict(failure_ctx=FailureCtx.from_masks(
            none, none, none, none, 0, 0, 99, 0.25),
            cost=CostModel(retransmit_p=0.9, sample=False),
            retx=torch.zeros((1, B), dtype=torch.int32))):
        usage = torch.zeros(lp.nbr_flat.shape[0], dtype=torch.int32)
        msgs = torch.zeros((1, B), dtype=torch.int32)
        got = sample_chunk_ref(0, 64, keys, adj, 0.9, done, usage, msgs, **kw)
        outs.append((*got, usage, msgs))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
