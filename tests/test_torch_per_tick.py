"""The port's legacy per-tick schedule (`ExecOptions(schedule="per_tick")`,
`gossip_until(schedule="per_tick")`) against the reference's, on the
CPU.

Backend "ref" per tick is the reference's "lax" per-tick scan: bitwise
in x, usage, messages and ticks, under the reference's own
``jax.threefry_partitionable(False)`` layout, in fixed-iterations mode
with per-hop loss and in eps-oracle mode.  Per tick and presampled are
bitwise equal in the port too (one exchange sequence).  The per-tick
"cuda" branch (the identity's rows mixed tick by tick, then one
`cell_mixing` call a chunk) runs here on CPU tensors through the
kernel's plain version: integer accounting bitwise, values within the
reference test's matrix tolerance (rtol 1e-4, atol 1e-5), since the
chunk's matrix product reassociates the sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.schedule import dense_to_csr  # noqa: E402

CPU = dict(device="cpu")
FI = dict(eps=1e-3, fixed_ticks_scale=0.2)


@pytest.fixture(autouse=True)
def _port_layout():
    with jax.threefry_partitionable(False):
        yield


def _ring(n):
    nbr = np.stack([(np.arange(n) - 1) % n, (np.arange(n) + 1) % n],
                   axis=1).astype(np.int32)
    return nbr, np.full(n, 2, np.int32)


def _ring_args(n=16, seed=0):
    nbr, deg = _ring(n)
    x0 = np.random.default_rng(seed).normal(0, 1, n).astype(np.float32)[None]
    return x0, nbr[None], deg[None], np.array([n], np.int32)


def _batched_weighted():
    rings = [_ring(n) for n in (6, 10, 16)]
    C = 16
    nbr = np.full((3, C, 2), -1, np.int32)
    deg = np.zeros((3, C), np.int32)
    for b, (nb, dg) in enumerate(rings):
        nbr[b, :len(dg)] = nb
        deg[b, :len(dg)] = dg
    n_nodes = np.array([6, 10, 16], np.int32)
    mask = np.arange(C)[None] < n_nodes[:, None]
    rng = np.random.default_rng(5)
    x = np.where(mask, rng.normal(0, 1, mask.shape), 0.0)
    w = np.where(mask, rng.uniform(0.5, 2.0, mask.shape), 0.0)
    x0 = np.stack([x * w, w], axis=-1).astype(np.float32)
    return x0, nbr, deg, n_nodes


def _assert_gossip_equal(want, got):
    np.testing.assert_array_equal(want.x.view(np.int32), got.x.view(np.int32))
    for f in ("edge_usage", "messages", "ticks", "converged"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)


@pytest.mark.parametrize("case", [
    ("ring eps oracle", _ring_args(seed=1), dict(eps=1e-3, seed=3)),
    ("ring FI loss 0.8", _ring_args(seed=2),
     dict(eps=-1.0, seed=7, fixed_ticks=384, loss_p=0.8)),
    ("batched weighted eps oracle", _batched_weighted(),
     dict(eps=1e-3, seed=9)),
], ids=lambda c: c[0])
def test_gossip_until_per_tick_bitwise_to_reference(case):
    _, args, kw = case
    want = R.gossip_until(*args, schedule="per_tick", backend="lax", **kw)
    got = P.gossip_until(*args, schedule="per_tick", backend="ref", **CPU,
                         **kw)
    _assert_gossip_equal(want, got)
    presampled = P.gossip_until(*args, backend="ref", **CPU, **kw)
    _assert_gossip_equal(got, presampled)


@pytest.fixture(scope="module")
def plans(rgg500):
    ref = R.build_plan(rgg500, seed=0)
    return ref, P.plan_from_reference(ref)


def _assert_run_equal(want, got):
    for f in ("messages", "node_sends", "level_messages", "level_ticks",
              "level_converged"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    np.testing.assert_array_equal(want.x_final.view(np.int32),
                                  got.x_final.view(np.int32))
    for u_ref, u_port in zip(want.edge_usage, got.edge_usage):
        np.testing.assert_array_equal(u_ref, u_port)


@pytest.mark.parametrize("mode", ["fi loss 0.8", "eps oracle"])
@pytest.mark.parametrize("trials", [1, 2])
def test_execute_plan_per_tick_bitwise_to_reference(plans, x0_500, mode,
                                                    trials):
    ref, port = plans
    seeds = tuple(range(3, 3 + trials))
    if mode == "eps oracle":
        kw = dict(eps=1e-3, weighted=True)
        fails = (None, None)
    else:
        kw = dict(FI)
        fails = (R.FailureModel(loss_p=0.8), P.FailureModel(loss_p=0.8))
    want = R.execute_plan(
        ref, x0_500, seeds=seeds, failures=fails[0],
        options=R.ExecOptions(backend="lax", schedule="per_tick",
                              collect_usage=True), **kw)
    got = P.execute_plan(
        port, x0_500, seeds=seeds, failures=fails[1],
        options=P.ExecOptions(backend="ref", schedule="per_tick",
                              collect_usage=True, **CPU), **kw)
    _assert_run_equal(want, got)
    presampled = P.execute_plan(
        port, x0_500, seeds=seeds, failures=fails[1],
        options=P.ExecOptions(backend="ref", collect_usage=True, **CPU), **kw)
    _assert_run_equal(got, presampled)


@pytest.mark.parametrize("loss_p", [None, 0.8])
def test_per_tick_cuda_branch_on_plain_versions(plans, loss_p):
    """The per-tick "cuda" branch's arithmetic, on CPU tensors (the
    `cell_mixing` wrapper takes its plain version here): the chunk's
    mixing matrix from the identity's rows, one product a chunk."""
    from repro_torch.core.engine import _level_consts
    from repro_torch.kernels.cell_mixing import cell_mixing

    _, port = plans
    lp = port.levels[0]
    c = _level_consts(lp, torch.device("cpu"))
    B, C = lp.node_mask.shape
    rng = np.random.default_rng(11)
    x0 = torch.as_tensor(np.where(lp.node_mask, rng.normal(0, 1, (2, B, C)),
                                  0.0)[..., None].astype(np.float32))
    keys = torch.stack([prng.PRNGKey(s, "cpu") for s in (4, 5)])
    kw = dict(max_ticks=192, check_every=64, loss_p=loss_p)
    before = cell_mixing.launches
    want = P.gossip_core(x0, c["adj"], c["node_mask"], -1.0, keys,
                         backend="ref", schedule="per_tick", **kw)
    got = P.gossip_core(x0, c["adj"], c["node_mask"], -1.0, keys,
                        backend="cuda", schedule="per_tick", **kw)
    assert cell_mixing.launches == before   # CPU tensors: no kernel
    for a, b in zip(want[1:], got[1:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    assert not torch.equal(got[0], x0)


def test_per_tick_refusals(plans, x0_500):
    _, port = plans
    args = _ring_args()
    with pytest.raises(ValueError, match="requires schedule='presampled'"):
        P.gossip_until(*args, eps=1e-3, schedule="per_tick",
                       backend="matmul", **CPU)
    with pytest.raises(ValueError, match="unknown schedule"):
        P.gossip_until(*args, eps=1e-3, schedule="clairvoyant",
                       backend="ref", **CPU)
    with pytest.raises(ValueError, match="unknown schedule"):
        P.ExecOptions(schedule="clairvoyant", backend="ref", **CPU)
    opts = P.ExecOptions(backend="ref", schedule="per_tick", **CPU)
    with pytest.raises(ValueError, match="requires schedule='presampled'"):
        P.execute_plan(port, x0_500, options=P.ExecOptions(
            backend="matmul", schedule="per_tick", **CPU), **FI)
    with pytest.raises(ValueError, match="presampled"):
        P.execute_plan(port, x0_500, options=opts, cost=P.CostModel(), **FI)
    with pytest.raises(ValueError, match="presampled"):
        P.execute_plan(port, x0_500, options=opts,
                       failures=P.FailureModel(churn_fraction=0.1), **FI)
    # the scenarios' own refusals come first where both apply, as in the
    # reference; loss alone is no scenario and runs per tick
    res = P.execute_plan(port, x0_500, options=opts,
                         failures=P.FailureModel(loss_p=0.9), **FI)
    assert res.messages.shape == (1,)
    # gossip_core refuses on its own, as the reference's does
    x0, nbr, deg, n_nodes = args
    adj = dense_to_csr(nbr, deg, n_nodes).to_device("cpu")
    core = (torch.as_tensor(x0)[None, ..., None], adj,
            torch.ones((1, 16), dtype=torch.bool), -1.0,
            prng.PRNGKey(0, "cpu")[None])
    with pytest.raises(ValueError, match="presampled"):
        P.gossip_core(*core, max_ticks=64, check_every=64, loss_p=None,
                      backend="ref", schedule="per_tick",
                      cost_model=P.CostModel())
    with pytest.raises(ValueError, match="requires schedule='presampled'"):
        P.gossip_core(*core, max_ticks=64, check_every=64, loss_p=None,
                      backend="matmul", schedule="per_tick")
