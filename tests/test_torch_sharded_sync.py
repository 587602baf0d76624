"""`execute_sync_sharded` on an 8-rank replica mesh against the dense
executors, on the CPU.

Eight ranks of one gloo process group, started once for the module
(`dist.ranks.run_ranks`), each hold one replica's row and run every
case; they import only the port (the reference is imported in the test
functions, in the pytest process, under
``jax.threefry_partitionable(False)``).  The cases are the reference's
`test_sharded_executor_matches_dense_and_overlaps` (7, steps 0 and 2)
and `test_sharded_executor_failure_parity_with_dense` (6, steps 0 and
3).  Each case is held against the reference's dense `execute_sync` at
2e-6 and against the port's dense `execute_sync`: bitwise where no
`pmean` enters, at 2e-6 where one does (it sums in another order).
Dropped rows are 0, three of them at each step; the collective account
is not empty in any case; the inert failure model is bitwise the
failure-free plan; `async_execute_sync(mesh=)` at warmup and at step 1;
and `_level_mesh`'s three refusals.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.dist as TD  # noqa: E402
from repro_torch.dist import collectives as C  # noqa: E402
from repro_torch.dist.ranks import run_ranks  # noqa: E402

R = 8
TIMEOUT = 240
TOL = 2e-6
FM = dict(churn_fraction=0.25, straggler_fraction=0.125,
          byzantine_fraction=0.125, seed=11)
# (config kwargs, steps, bitwise to the port's dense executor)
CASES = {
    "allreduce": (dict(strategy="allreduce"), (0, 2), False),
    "hierarchical": (dict(strategy="hierarchical"), (0, 2), False),
    "ring": (dict(strategy="ring", rounds=(16,)), (0, 2), True),
    "multiscale": (dict(strategy="multiscale"), (0, 2), True),
    "ms_exact": (dict(strategy="multiscale", exact_fusion=True), (0, 2),
                 False),
    "ms_rotated": (dict(strategy="multiscale", rotation_period=3,
                        rotation_seed=5), (0, 2), True),
    "ms_topk": (dict(strategy="multiscale", compression=("topk", 0.25)),
                (0, 2), False),
    "mean": (dict(strategy="multiscale", failures=FM), (0, 3), True),
    "survivor": (dict(strategy="multiscale", aggregation="survivor_weighted",
                      failures=FM), (0, 3), True),
    "trimmed": (dict(strategy="allreduce", aggregation="trimmed_mean",
                     failures=FM), (0, 3), True),
    "median": (dict(strategy="allreduce", aggregation="coordinate_median",
                    failures=FM), (0, 3), True),
    "topk_churn": (dict(strategy="multiscale", compression=("topk", 0.25),
                        failures=FM), (0, 3), False),
    "rotated_churn": (dict(strategy="multiscale", rotation_period=3,
                           rotation_seed=5, failures=FM), (0, 3), True),
}
RUNS = [(name, step) for name, (_, steps, _) in CASES.items()
        for step in steps]


def _cfg(mod, kw):
    """A SyncConfig of module `mod` (the port's or the reference's)."""
    kw = dict(kw)
    if "compression" in kw:
        kw["compression"] = mod.CompressionConfig(*kw["compression"])
    if "failures" in kw:
        kw["failures"] = mod.SyncFailureModel(**kw["failures"])
    return mod.SyncConfig(**kw)


def _grads():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(R, 96)).astype(np.float32),
            "v": rng.normal(size=(R, 4, 6)).astype(np.float32)}


def _numpy(tree):
    return None if tree is None else {k: v.numpy() for k, v in tree.items()}


def _rank(rank, world, grads):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("replica",))
    g = {k: torch.tensor(v[rank:rank + 1]) for k, v in grads.items()}
    out = {}
    for name, step in RUNS:
        plan = TD.build_sync_plan(_cfg(TD, CASES[name][0]), R)
        res = (TD.init_residual(g) if plan.compression.scheme != "none"
               else None)
        C.reset_account()
        mixed, new_res = TD.execute_sync_sharded(plan, g, res, step,
                                                 mesh=mesh)
        out[name, step] = (_numpy(mixed), _numpy(new_res), C.account())
    # the inert failure model against the failure-free plan, step 1
    clean = TD.build_sync_plan(TD.SyncConfig("multiscale"), R)
    inert = TD.build_sync_plan(
        TD.SyncConfig("multiscale", failures=TD.SyncFailureModel()), R)
    out["inert"] = tuple(
        _numpy(TD.execute_sync_sharded(p, g, None, 1, mesh=mesh)[0])
        for p in (clean, inert))
    # the overlapped stage: warmup (zeros in flight), then step 1
    plan = TD.build_sync_plan(TD.SyncConfig(
        "multiscale", exact_fusion=True, overlap="one_step"), R)
    applied, inflight, _ = TD.async_execute_sync(
        plan, g, TD.init_inflight(g), None, 0, mesh=mesh)
    warm = (_numpy(applied), _numpy(inflight))
    applied, _, _ = TD.async_execute_sync(plan, g, inflight, None, 1,
                                          mesh=mesh)
    out["async"] = (warm, _numpy(applied))
    # _level_mesh's refusals: no replica dim, a size other than R, a
    # second dim
    errors = []
    meshes = [
        (DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",)),
         clean),
        (mesh, TD.build_sync_plan(TD.SyncConfig("multiscale"), 4)),
        (DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                    mesh_dim_names=("replica", "model")), clean),
    ]
    for m, p in meshes:
        try:
            TD.execute_sync_sharded(p, g, None, 0, mesh=m)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def results():
    return run_ranks(_rank, R, _grads(), backend="gloo", timeout=TIMEOUT,
                     threads=1)


def _rows(results, key, part=0):
    """The ranks' rows of one run stacked back into (R, ...) leaves."""
    rows = [r[key][part] for r in results]
    return {k: np.concatenate([row[k] for row in rows]) for k in rows[0]}


def _dense_port(name, step):
    plan = TD.build_sync_plan(_cfg(TD, CASES[name][0]), R)
    g = {k: torch.tensor(v) for k, v in _grads().items()}
    res = (TD.init_residual(g) if plan.compression.scheme != "none"
           else None)
    mixed, new_res = TD.execute_sync(plan, g, res, step)
    return plan, _numpy(mixed), _numpy(new_res)


def _dense_reference(name, step):
    import jax
    import jax.numpy as jnp
    import repro.dist as RD

    with jax.threefry_partitionable(False):
        plan = RD.build_sync_plan(_cfg(RD, CASES[name][0]), R)
        g = {k: jnp.asarray(v) for k, v in _grads().items()}
        res = (RD.init_residual(g) if plan.compression.scheme != "none"
               else None)
        mixed, new_res = RD.execute_sync(plan, g, res, step)
        dropped = (np.asarray(RD.replica_fault_masks(
            plan.failures, R, step).dropped) if plan.faulty else None)
    tree = lambda t: None if t is None else {k: np.asarray(v)
                                             for k, v in t.items()}
    return tree(mixed), tree(new_res), dropped


def _close(want, got, bitwise):
    for k in want:
        if bitwise:
            np.testing.assert_array_equal(want[k].view(np.int32),
                                          got[k].view(np.int32), err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


@pytest.mark.parametrize("name,step", RUNS)
def test_sharded_matches_dense(results, name, step):
    plan, want, want_res = _dense_port(name, step)
    got, got_res = _rows(results, (name, step), 0), None
    if want_res is not None:
        got_res = _rows(results, (name, step), 1)
    bitwise = CASES[name][2]
    _close(want, got, bitwise)
    if want_res is not None:
        _close(want_res, got_res, bitwise)
    ref, ref_res, dropped = _dense_reference(name, step)
    _close(ref, got, False)
    if ref_res is not None:
        _close(ref_res, got_res, False)
    if dropped is not None:
        assert dropped.sum() == 3
        for k in got:
            assert np.all(got[k][dropped] == 0.0), (name, step, k)
    for r in results:
        account = r[name, step][2]
        assert sum(e["calls"] for e in account.values()) > 0, (name, step)


def test_inert_failure_model_bitwise(results):
    for r in results:
        clean, inert = r["inert"]
        for k in clean:
            np.testing.assert_array_equal(clean[k].view(np.int32),
                                          inert[k].view(np.int32))


def test_async_sharded_stage(results):
    g = _grads()
    warm = [r["async"][0] for r in results]
    for rank, (applied, inflight) in enumerate(warm):
        for k in g:
            assert np.abs(applied[k]).max() == 0.0
            np.testing.assert_array_equal(inflight[k], g[k][rank:rank + 1])
    applied = {k: np.concatenate([r["async"][1][k] for r in results])
               for k in g}
    plan = TD.build_sync_plan(TD.SyncConfig(
        "multiscale", exact_fusion=True, overlap="one_step"), R)
    t = {k: torch.tensor(v) for k, v in g.items()}
    dense, _, _ = TD.async_execute_sync(plan, t, t, None, 1)
    for k in g:
        np.testing.assert_allclose(applied[k], dense[k].numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(applied[k].mean(0), g[k].mean(0),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which,text", [
    (0, "no dim 'replica'"), (1, "plan serves R=4"),
    (2, "dedicated 1-dim replica mesh")])
def test_level_mesh_refusals(results, which, text):
    for r in results:
        assert r["errors"][which] is not None
        assert text in r["errors"][which]


def test_port_sync_config_fields_match_reference():
    """The case table builds the same SyncConfig fields on both sides."""
    import repro.dist as RD

    for kw, _, _ in CASES.values():
        a, b = _cfg(RD, kw), _cfg(TD, kw)
        assert {f.name for f in dataclasses.fields(a)} == {
            f.name for f in dataclasses.fields(b)}
