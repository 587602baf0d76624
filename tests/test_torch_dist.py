"""The port's decentralized gradient sync (`repro_torch.dist`) against the
reference's `repro.dist` on the same inputs.

Bitwise: `prng.permutation` and `replica_fault_masks` (jax's threefry
in its older layout, so the reference runs inside
`jax.threefry_partitionable(False)`) over seeds x steps x R in {1, 2, 7,
8, 16, 64}; the topology helpers, every `SyncPlan` field, the fault
counts, trims, wire fractions and modeled wire bytes.  f32 allclose at
1e-6: `execute_sync` for every strategy x rotation x compression (none /
topk / int8) x failures x aggregation, `async_execute_sync`, `compress`.
Within the port: the executor run in pieces of columns and in place is
bitwise the whole-leaf functional run, and compression conserves the
accumulator bitwise.  `collectives.reduce_scatter` on 4 gloo CPU ranks
is bitwise `psum` then the rank's block, in f32 and bf16 summed in f32,
over one mesh dim and two, and its account counts each dim's call.
"""
import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.dist as RD  # noqa: E402
import repro_torch.dist as TD  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.dist import gossip_sync  # noqa: E402

TOL = 1e-6
R_VALUES = (1, 2, 7, 8, 16, 64)
FAILURES = [
    None,
    dict(churn_fraction=0.25, seed=1),
    dict(straggler_fraction=0.125, byzantine_fraction=0.125, seed=2),
    dict(byzantine_fraction=0.25, byzantine_scale=4.0, seed=3),
]


@pytest.fixture(autouse=True)
def _older_threefry():
    with jax.threefry_partitionable(False):
        yield


def _port_sync(cfg: RD.SyncConfig) -> TD.SyncConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["compression"] = TD.CompressionConfig(
        **dataclasses.asdict(cfg.compression))
    if cfg.failures is not None:
        fields["failures"] = TD.SyncFailureModel(
            **dataclasses.asdict(cfg.failures))
    return TD.SyncConfig(**fields)


def _grads(R, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(R, 5, 3)).astype(dtype),
            "b": rng.normal(size=(R, 7)).astype(dtype)}


def _torch(tree):
    return None if tree is None else {k: torch.tensor(v)
                                      for k, v in tree.items()}


def _jax(tree):
    return None if tree is None else {k: jnp.asarray(v)
                                      for k, v in tree.items()}


# ------------------------------ draws --------------------------------


@pytest.mark.parametrize("R", R_VALUES)
def test_permutation_bitwise(R):
    for seed, step in itertools.product((0, 3, 2**31 - 1), (0, 1, 5, -1, 977)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                 jnp.asarray(step, jnp.int32))
        want = np.asarray(jax.random.permutation(key, R))
        got = prng.permutation(prng.fold_in(prng.PRNGKey(seed), step), R)
        np.testing.assert_array_equal(got.numpy(), want)


def test_permutation_two_rounds_bitwise():
    """Past 1625 values jax sorts twice; the port follows."""
    key = jax.random.PRNGKey(4)
    for n in (1625, 1626, 3000):
        want = np.asarray(jax.random.permutation(key, n))
        got = prng.permutation(prng.PRNGKey(4), n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R", R_VALUES)
def test_replica_fault_masks_bitwise(R):
    for fm, step in itertools.product(FAILURES[1:], (0, 1, 2, 7, -1)):
        ref = RD.replica_fault_masks(RD.SyncFailureModel(**fm), R, step)
        port = TD.replica_fault_masks(TD.SyncFailureModel(**fm), R, step)
        for name in ref._fields:
            np.testing.assert_array_equal(
                getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                err_msg=f"{name} R={R} step={step} {fm}")
        assert TD.fault_counts(TD.SyncFailureModel(**fm), R) == \
            RD.fault_counts(RD.SyncFailureModel(**fm), R)


# ------------------------- topology and plan -------------------------


def test_topology_bitwise():
    for R in range(1, 600):
        assert TD.suggest_levels(R) == RD.suggest_levels(R)
        assert TD.default_rounds(R) == RD.default_rounds(R)
    for R, period, seed in ((8, 4, 0), (7, 3, 5), (64, 2, 1)):
        for a, b in zip(TD.rotation_schedule(R, period, seed),
                        RD.rotation_schedule(R, period, seed)):
            np.testing.assert_array_equal(a, b)
    for m in (1, 2, 5):
        np.testing.assert_array_equal(TD.ring_matrix(m), RD.ring_matrix(m))
        np.testing.assert_array_equal(TD.complete_matrix(m),
                                      RD.complete_matrix(m))
    np.testing.assert_array_equal(TD.hierarchy_matrix((2, 4)),
                                  RD.hierarchy_matrix((2, 4)))
    assert TD.is_doubly_stochastic(TD.hierarchy_matrix((4, 2)))


PLAN_CONFIGS = [
    dict(strategy="allreduce"),
    dict(strategy="hierarchical"),
    dict(strategy="ring"),
    dict(strategy="ring", rounds=(5,), rotation_period=3, rotation_seed=2),
    dict(strategy="multiscale"),
    dict(strategy="multiscale", levels=(2, 4), rounds=(3, 2),
         rotation_period=4, compression="topk"),
    dict(strategy="multiscale", exact_fusion=True, compression="int8",
         overlap="one_step"),
    dict(strategy="multiscale", aggregation="trimmed_mean",
         failures=dict(churn_fraction=0.125, byzantine_fraction=0.125)),
    dict(strategy="ring", aggregation="survivor_weighted",
         failures=dict(straggler_fraction=0.25)),
]


def _both(kw):
    kw = dict(kw)
    fm = kw.pop("failures", None)
    return (RD.SyncConfig(failures=fm and RD.SyncFailureModel(**fm), **kw),
            TD.SyncConfig(failures=fm and TD.SyncFailureModel(**fm), **kw))


@pytest.mark.parametrize("kw", PLAN_CONFIGS)
def test_plan_fields_bitwise(kw):
    rcfg, tcfg = _both(kw)
    g = _grads(8)
    for R in (1, 2, 8, 16):
        if kw.get("levels") and R != 8:
            continue
        try:
            ref = RD.build_sync_plan(rcfg, R)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:30]):
                TD.build_sync_plan(tcfg, R)
            continue
        port = TD.build_sync_plan(tcfg, R)
        for f in dataclasses.fields(ref):
            a, b = getattr(ref, f.name), getattr(port, f.name)
            if f.name in ("compression", "failures"):
                a, b = (None if x is None else dataclasses.asdict(x)
                        for x in (a, b))
            assert a == b, f.name
        for prop in ("rotated", "faulty", "robust_consensus", "overlapped",
                     "transmissions"):
            assert getattr(ref, prop) == getattr(port, prop), prop
        assert TD.wire_fraction(port.compression) == \
            RD.wire_fraction(ref.compression)
        if R == 8:
            for dtype in (np.float32, np.float16):
                assert TD.plan_wire_bytes(port, _torch(_grads(8, dtype=dtype))) \
                    == RD.plan_wire_bytes(ref, _jax(_grads(8, dtype=dtype)))
        if rcfg.failures is not None:
            assert TD.resolve_trim(port.failures, R) == \
                RD.resolve_trim(ref.failures, R)
    assert TD.tree_payload_bytes(_torch(g)) == RD.tree_payload_bytes(_jax(g))


@pytest.mark.parametrize("kw", [
    dict(strategy="gossip"), dict(levels=(0, 2)), dict(rounds=(-1,)),
    dict(strategy="ring", rounds=(1, 2)), dict(levels=(2, 2), rounds=(1, 2, 3)),
    dict(rotation_period=-1), dict(overlap="two_step"),
    dict(aggregation="max"), dict(compression="fp4")])
def test_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ref:
        RD.SyncConfig(**kw)
    with pytest.raises(ValueError) as port:
        TD.SyncConfig(**kw)
    assert str(port.value) == str(ref.value)


def test_infeasible_plans_raise_as_reference():
    for kw, R in ((dict(failures=dict(churn_fraction=0.5,
                                      byzantine_fraction=0.5)), 4),
                  (dict(aggregation="trimmed_mean",
                        failures=dict(churn_fraction=0.25,
                                      byzantine_fraction=0.5)), 4),
                  (dict(strategy="multiscale", levels=(2, 3)), 8)):
        rcfg, tcfg = _both(kw)
        with pytest.raises(ValueError) as ref:
            RD.build_sync_plan(rcfg, R)
        with pytest.raises(ValueError) as port:
            TD.build_sync_plan(tcfg, R)
        assert str(port.value) == str(ref.value)


# ----------------------------- executor ------------------------------


@pytest.mark.parametrize("compression", ["none", "topk", "int8"])
@pytest.mark.parametrize("strategy", ["allreduce", "hierarchical", "ring",
                                      "multiscale"])
def test_execute_sync_matches_reference(strategy, compression):
    """Every rotation x failures x aggregation x sync index of one
    strategy and compression, f32 allclose at 1e-6."""
    R = 8
    g = _grads(R, seed=1)
    res = {k: (0.1 * v).astype(np.float32)
           for k, v in _grads(R, seed=2).items()}
    done = 0
    for rot, fm, agg in itertools.product(
            (0, 3), FAILURES,
            ("mean", "trimmed_mean", "coordinate_median",
             "survivor_weighted")):
        kw = dict(strategy=strategy, rotation_period=rot,
                  compression=compression, aggregation=agg,
                  rounds=(3,) if strategy == "ring" else ())
        if fm is not None:
            kw["failures"] = fm
        rcfg, tcfg = _both(kw)
        try:
            rplan = RD.build_sync_plan(rcfg, R)
        except ValueError:
            continue
        tplan = TD.build_sync_plan(tcfg, R)
        r_in = res if compression != "none" else None
        for step in (0, 6):
            with jax.disable_jit():  # op by op: no compile per call
                rm, rr = RD.execute_sync(rplan, _jax(g), _jax(r_in), step)
            tm, tr = TD.execute_sync(tplan, _torch(g), _torch(r_in), step)
            for k in g:
                np.testing.assert_allclose(
                    tm[k].numpy(), np.asarray(rm[k]), rtol=TOL, atol=TOL,
                    err_msg=f"{kw} step {step} {k}")
                if r_in is not None:
                    np.testing.assert_allclose(
                        tr[k].numpy(), np.asarray(rr[k]), rtol=TOL,
                        atol=TOL, err_msg=f"residual {kw} step {step} {k}")
            done += 1
    assert done >= 20


@pytest.mark.parametrize("kw", [
    dict(strategy="multiscale", rotation_period=3, compression="topk"),
    dict(strategy="ring", rounds=(4,), compression="int8",
         failures=dict(churn_fraction=0.25, seed=1),
         aggregation="survivor_weighted"),
    dict(strategy="hierarchical", aggregation="trimmed_mean",
         failures=dict(byzantine_fraction=0.125, straggler_fraction=0.125)),
])
def test_execute_sync_in_pieces_and_in_place_bitwise(monkeypatch, kw):
    """A leaf run in pieces of a few columns, and in place, gives the
    whole-leaf functional result bit for bit."""
    _, tcfg = _both(kw)
    plan = TD.build_sync_plan(tcfg, 8)
    g = _torch(_grads(8, seed=3))
    res = _torch({k: 0.1 * v for k, v in _grads(8, seed=4).items()})
    whole, whole_r = TD.execute_sync(plan, g, res, 2)
    monkeypatch.setattr(gossip_sync, "_PIECE", 8 * 2)
    pieces, pieces_r = TD.execute_sync(plan, g, res, 2)
    g2 = {k: v.clone() for k, v in g.items()}
    r2 = {k: v.clone() for k, v in res.items()}
    inplace, inplace_r = TD.execute_sync(plan, g2, r2, 2, inplace=True)
    for k in g:
        assert torch.equal(whole[k], pieces[k]) and torch.equal(
            whole[k], inplace[k]), k
        assert inplace[k].data_ptr() == g2[k].data_ptr()
        if plan.compression.scheme != "none":
            assert torch.equal(whole_r[k], pieces_r[k])
            assert torch.equal(whole_r[k], inplace_r[k])


@pytest.mark.parametrize("scheme,frac", [("topk", 0.25), ("topk", 0.01),
                                         ("int8", 0.25)])
def test_compress_matches_reference_and_conserves_bitwise(scheme, frac):
    rng = np.random.default_rng(5)
    g = {"w": rng.normal(size=(4, 50, 3)).astype(np.float32)}
    g["w"][0, :5] = 0.5  # ties at the threshold are all kept
    res = {"w": (0.3 * rng.normal(size=(4, 50, 3))).astype(np.float32)}
    rp, rr = RD.compress(_jax(g), _jax(res),
                         RD.CompressionConfig(scheme, frac))
    cfg = TD.CompressionConfig(scheme, frac)
    tp, tr = TD.compress(_torch(g), _torch(res), cfg)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(rp["w"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tr["w"].numpy(), np.asarray(rr["w"]),
                               rtol=TOL, atol=TOL)
    acc = _torch(g)["w"] + _torch(res)["w"]
    assert torch.equal(tp["w"] + tr["w"], acc)
    for dt in (torch.bfloat16, torch.float32):
        gd = {k: v.to(dt) for k, v in _torch(g).items()}
        rd = {k: v.to(dt) for k, v in _torch(res).items()}
        p, r = TD.compress(gd, rd, cfg)
        assert torch.equal(p["w"] + r["w"], gd["w"] + rd["w"])
    assert TD.decompress(tp, cfg) is tp
    none_p, none_r = TD.compress(_torch(g), _torch(res),
                                 TD.CompressionConfig())
    assert torch.equal(none_p["w"], _torch(g)["w"])


@pytest.mark.parametrize("kw", [
    dict(strategy="multiscale", overlap="one_step", rotation_period=3),
    dict(strategy="ring", rounds=(2,), overlap="one_step", compression="int8",
         failures=dict(churn_fraction=0.25, seed=3)),
])
def test_async_execute_sync_matches_reference(kw):
    rcfg, tcfg = _both(kw)
    rplan, tplan = RD.build_sync_plan(rcfg, 8), TD.build_sync_plan(tcfg, 8)
    g, prev = _grads(8, seed=6), _grads(8, seed=7)
    res = ({k: 0.1 * v for k, v in _grads(8, seed=8).items()}
           if rplan.compression.scheme != "none" else None)
    for step in (0, 1, 4):
        ra, rn, rr = RD.async_execute_sync(rplan, _jax(g), _jax(prev),
                                           _jax(res), step)
        ta, tn, tr = TD.async_execute_sync(tplan, _torch(g), _torch(prev),
                                           _torch(res), step)
        for k in g:
            np.testing.assert_allclose(ta[k].numpy(), np.asarray(ra[k]),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(tn[k].numpy(), np.asarray(rn[k]))
            if res is not None:
                np.testing.assert_allclose(tr[k].numpy(), np.asarray(rr[k]),
                                           rtol=TOL, atol=TOL)
    # a mesh without a "replica" dim is refused, as the reference does
    no_replica = SimpleNamespace(mesh_dim_names=("data",), shape=(8,))
    with pytest.raises(ValueError, match="no dim 'replica'"):
        TD.async_execute_sync(tplan, _torch(g), _torch(prev),
                              mesh=no_replica)


@pytest.mark.parametrize("strategy", ["allreduce", "hierarchical", "ring",
                                      "multiscale"])
def test_sync_gradients_matches_reference(strategy):
    g = _grads(16, seed=9)
    cfg = dict(strategy=strategy)
    ref = RD.sync_gradients(_jax(g), RD.SyncConfig(**cfg), 16)
    port = TD.sync_gradients(_torch(g), TD.SyncConfig(**cfg), 16)
    for k in g:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=TOL, atol=TOL)
        if strategy in ("allreduce", "hierarchical"):
            rows = port[k].reshape(16, -1)
            assert torch.equal(rows, rows[:1].expand_as(rows))


def test_execute_sync_rejects_wrong_replica_axis():
    plan = TD.build_sync_plan(TD.SyncConfig(), 4)
    with pytest.raises(ValueError, match="leading replica axis 4"):
        TD.execute_sync(plan, {"w": torch.zeros(3, 2)})
    one = TD.build_sync_plan(TD.SyncConfig(), 1)
    g = {"w": torch.ones(1, 2)}
    assert TD.execute_sync(one, g)[0] is g


def test_robust_helpers_match_reference():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    dropped = np.zeros(8, bool)
    dropped[[1, 5]] = True
    for k_trim in (0, 1, 2):
        np.testing.assert_allclose(
            TD.masked_trimmed_mean(torch.tensor(x), torch.tensor(dropped), 2,
                                   k_trim).numpy(),
            np.asarray(RD.masked_trimmed_mean(jnp.asarray(x),
                                              jnp.asarray(dropped), 2,
                                              k_trim)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        TD.masked_coordinate_median(torch.tensor(x), torch.tensor(dropped),
                                    2).numpy(),
        np.asarray(RD.masked_coordinate_median(jnp.asarray(x),
                                               jnp.asarray(dropped), 2)),
        rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="at least one value"):
        TD.masked_trimmed_mean(torch.tensor(x), torch.tensor(dropped), 2, 3)


# ------------------------- collectives on gloo -------------------------

# (dims, dim) of the reduce-scatters on the (2, 2) ("data", "model") mesh
SCATTERS = ((("model",), -1), (("model",), 0), (("data", "model"), 0),
            (("data", "model"), -1), (("data",), 1))


def _scatter_rank(rank, world):
    """Each `SCATTERS` case on this rank's own x: the reduce-scatter
    against psum then the rank's block, in f32 and in bf16 summed in f32
    (`sharded.reduce_scatter`), and the account of the f32 call."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.models import sharded as SH

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = torch.randn((8, 6, 12), generator=torch.Generator().manual_seed(
        rank))
    out = {}
    for dims, dim in SCATTERS:
        n, i = C.axis_size(mesh, dims), C.axis_index(mesh, dims)
        size = x.shape[dim] // n
        want = C.psum(x, mesh, dims).narrow(dim, i * size, size)
        C.reset_account()
        got = C.reduce_scatter(x, mesh, dims, dim)
        account = C.account()
        xb = x.to(torch.bfloat16)
        want_b = C.psum(xb.float(), mesh, dims).narrow(
            dim, i * size, size).to(torch.bfloat16)
        got_b = SH.reduce_scatter(xb, mesh, dim, dims)
        out[(dims, dim)] = {
            "f32": torch.equal(got, want), "shape": tuple(got.shape),
            "bf16": got_b.dtype == torch.bfloat16 and torch.equal(got_b,
                                                                  want_b),
            "account": account}
    # NCCL's route (one `reduce_scatter_tensor` a dim, the finest first,
    # on the row-major blocks), each call emulated on gloo by an
    # all-reduce and the group rank's share of the flat input
    def emulated(res, src, group):
        full = src.clone()
        C.dist.all_reduce(full, group=group)
        k, r = C.dist.get_world_size(group), C.dist.get_rank(group)
        res.copy_(full.reshape(k, -1)[r].reshape(res.shape))

    real = (C.dist.get_backend, C.dist.reduce_scatter_tensor)
    C.dist.get_backend = lambda group=None: "nccl"
    C.dist.reduce_scatter_tensor = emulated
    try:
        for dims, dim in SCATTERS:
            n, i = C.axis_size(mesh, dims), C.axis_index(mesh, dims)
            size = x.shape[dim] // n
            got = C.reduce_scatter(x, mesh, dims, dim)
            out[(dims, dim)]["nccl_route"] = torch.equal(
                got, C.psum(x, mesh, dims).narrow(dim, i * size, size))
    finally:
        C.dist.get_backend, C.dist.reduce_scatter_tensor = real
    try:
        C.reduce_scatter(x, mesh, ("data", "model"), 1)
        out["refused"] = "no error"
    except ValueError as e:
        out["refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def scatters():
    from repro_torch.dist.ranks import run_ranks

    return run_ranks(_scatter_rank, 4, backend="gloo", timeout=120,
                     threads=1)


@pytest.mark.parametrize(("dims", "dim"), SCATTERS)
def test_reduce_scatter_is_psum_then_the_ranks_block(scatters, dims, dim):
    """`collectives.reduce_scatter` on gloo equals `psum` then the rank's
    block of the row-major split, bitwise, in f32 and in bf16 summed in
    f32 and rounded once, and so does its NCCL route (each call
    emulated); the account counts one call a dim of the group, the
    finest first, putting in what is left and giving its half."""
    shape = [8, 6, 12]
    shape[dim] //= 2 ** len(dims)
    nbytes = 8 * 6 * 12 * 4
    want = {}
    for d in reversed(dims):
        want[d] = (1, nbytes, nbytes // 2)
        nbytes //= 2
    for rank, r in enumerate(scatters):
        got = r[(dims, dim)]
        assert got["f32"] and got["bf16"] and got["nccl_route"], (rank, got)
        assert got["shape"] == tuple(shape)
        rows = {g["dims"][0]: (g["calls"], g["bytes"], g["result_bytes"])
                for g in got["account"]["reduce_scatter"]["groups"]}
        assert rows == want, (rank, rows)
        # gloo's all-reduce runs on the tensor itself: nothing else
        assert set(got["account"]) == {"reduce_scatter"}


def test_reduce_scatter_refuses_an_uneven_split(scatters):
    for r in scatters:
        assert "does not split over 4 ranks" in r["refused"], r["refused"]
