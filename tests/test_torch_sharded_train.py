"""`make_decentralized_step(mesh=)` on a 4-rank replica mesh against the
dense step, on the CPU.

Four ranks of one gloo process group, started once for the module
(`dist.ranks.run_ranks`), each hold one replica's rows
(`init_decentralized_state(..., mesh=)`) and their block of every batch
(`data.shard_batch`), and take 3 steps in each of five sync modes; they import
only the port.  The model is llama3.2-3b at `reduce_config` (2 layers,
d 64) in f32 with vocab 256, `sgdm`, SyntheticLM batches of 16 tokens,
2 a replica.  Each rank's own losses and parameters are held against
the matching rows of the port's dense `make_decentralized_step(R=4)` at
1e-6 relative (the losses elementwise, the parameters as the norm of
the difference over the norm, a leaf at a time: the sharded step sums
the clip norm and the means in another order), and against the
reference's dense step at the tolerances of `test_torch_decentralized`.
`shard_batch` is held against numpy slicing of the reference's
SyntheticLM batch, and a rank's state against the sliced dense state.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.dist as TD  # noqa: E402
import repro_torch.optim as TO  # noqa: E402
import repro_torch.train as TT  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.data import SyntheticLM, shard_batch  # noqa: E402
from repro_torch.dist.ranks import run_ranks  # noqa: E402

R = 4
STEPS = 3
TIMEOUT = 240
VOCAB = 256
REL = 1e-6
F32_TOL = 1e-5
LOSS_TOL = 1e-4  # the top-k run's, as test_torch_decentralized holds it
LR = 1e-2
MODES = {
    "allreduce": dict(strategy="allreduce"),
    "multiscale_rotated": dict(strategy="multiscale", rotation_period=3),
    "multiscale_topk": dict(strategy="multiscale",
                            compression=("topk", 0.25)),
    "overlap": dict(strategy="multiscale", overlap="one_step",
                    rotation_period=2),
    "churn_survivor": dict(strategy="multiscale",
                           aggregation="survivor_weighted",
                           failures=dict(churn_fraction=0.25, seed=3)),
}


def _cfg(mod, kw):
    kw = dict(kw)
    if "compression" in kw:
        kw["compression"] = mod.CompressionConfig(*kw["compression"])
    if "failures" in kw:
        kw["failures"] = mod.SyncFailureModel(**kw["failures"])
    return mod.SyncConfig(**kw)


def _pcfg():
    return dataclasses.replace(reduce_config(get_config("llama3.2-3b")),
                               dtype="float32", vocab_size=VOCAB)


def _data():
    return SyntheticLM(VOCAB, seq_len=16, global_batch=R * 2, seed=5)


def _batch(data, s):
    return {k: v.reshape(R, -1, *v.shape[1:])
            for k, v in data.batch_at(s).items()}


def _rank(rank, world, flat):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("replica",))
    mesh22 = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
    cfg, data, opt = _pcfg(), _data(), TO.sgdm()
    base = {k: torch.tensor(v) for k, v in flat.items()}
    out = {"batches": [shard_batch(data.batch_at(s), mesh22, dims)
                       for s in range(2)
                       for dims in (("data",), ("data", "model"))]}
    for name, kw in MODES.items():
        sync = _cfg(TD, kw)
        dense = TT.init_decentralized_state(TT.replicate(base, R), opt,
                                            sync=sync)
        state = TT.init_decentralized_state(TT.replicate(base, R), opt,
                                            sync=sync, mesh=mesh)
        same = all(torch.equal(state[part][k], dense[part][k][rank:rank + 1])
                   for part in ("params", "residuals", "prev_grads")
                   if part in dense for k in dense[part])
        same &= all(torch.equal(v, dense["opt"]["m"][k][rank:rank + 1])
                    for k, v in state["opt"]["m"].items())
        same &= torch.equal(state["opt"]["count"],
                            dense["opt"]["count"][rank:rank + 1])
        step = TT.make_decentralized_step(
            cfg, opt, TO.cosine_schedule(LR, 1, 10), sync, R, mesh=mesh,
            device="cpu")
        losses, metrics = [], []
        for s in range(STEPS):
            state, m = step(state, shard_batch(_batch(data, s), mesh,
                                               ("replica",)))
            losses.append(float(m["replica_loss"]))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = dict(
            state_sliced=same, losses=losses, metrics=metrics,
            params={k: v.numpy() for k, v in state["params"].items()})
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import repro.configs as RC
    import repro.models as RM
    import repro.optim as RO
    import repro.train as RT

    from repro_torch.models import state_from_reference

    rcfg = dataclasses.replace(RC.reduce_config(RC.get_config("llama3.2-3b")),
                               dtype="float32", vocab_size=VOCAB)
    with jax.threefry_partitionable(False):
        params = RM.Transformer(rcfg, model_axis=1).init(jax.random.PRNGKey(0))
    flat = state_from_reference(
        jax.tree.map(np.asarray, RT.init_train_state(params, RO.sgdm())),
        _pcfg(), device="cpu")["params"]
    flat = {k: v.numpy() for k, v in flat.items()}
    results = run_ranks(_rank, R, flat, backend="gloo", timeout=TIMEOUT,
                        threads=1)
    return dict(rcfg=rcfg, params=params, flat=flat, results=results)


def _dense_port(flat, name):
    """The port's dense step at R=4: each replica's losses (from its own
    forward before each step) and the final parameters."""
    cfg, data, opt = _pcfg(), _data(), TO.sgdm()
    sync = _cfg(TD, MODES[name])
    base = {k: torch.tensor(v) for k, v in flat.items()}
    state = TT.init_decentralized_state(TT.replicate(base, R), opt,
                                        sync=sync)
    step = TT.make_decentralized_step(cfg, opt, TO.cosine_schedule(LR, 1, 10),
                                      sync, R, device="cpu")
    losses, metrics = [], []
    for s in range(STEPS):
        b = _batch(data, s)
        losses.append(TT.replica_grads(cfg, state["params"], {
            k: torch.as_tensor(v) for k, v in b.items()})[0].numpy())
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return np.stack(losses, 1), metrics, state["params"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(MODES))
def test_sharded_step_matches_dense_port(setup, name):
    losses, metrics, params = _dense_port(setup["flat"], name)
    for rank, res in enumerate(setup["results"]):
        got = res[name]
        assert got["state_sliced"], f"rank {rank}'s state is not its rows"
        np.testing.assert_allclose(got["losses"], losses[rank], rtol=REL,
                                   atol=0)
        for k, p in params.items():
            assert _rel(got["params"][k], p[rank:rank + 1].numpy()) <= REL, k
        for gm, dm in zip(got["metrics"], metrics):
            np.testing.assert_allclose(gm["loss"], dm["loss"], rtol=REL)
            np.testing.assert_allclose(gm["grad_norm"], dm["grad_norm"],
                                       rtol=REL)
            assert gm["wire_bytes"] == dm["wire_bytes"]
            assert gm["sync_overlap_fraction"] == dm["sync_overlap_fraction"]
            for k in ("consensus_distance", "survivor_consensus_error"):
                np.testing.assert_allclose(gm[k], dm[k], rtol=1e-4,
                                           atol=1e-7, err_msg=k)
            assert (gm["effective_replica_fraction"]
                    == dm["effective_replica_fraction"])
    if name == "allreduce":
        first = setup["results"][0][name]["params"]
        for res in setup["results"][1:]:
            for k, v in res[name]["params"].items():
                np.testing.assert_array_equal(v, first[k])


@pytest.mark.parametrize("name", list(MODES))
def test_sharded_step_matches_reference(setup, name):
    import jax
    import jax.numpy as jnp
    import repro.data as RDATA
    import repro.dist as RD
    import repro.optim as RO
    import repro.train as RT

    sync = _cfg(RD, MODES[name])
    ropt = RO.sgdm()
    with jax.threefry_partitionable(False):
        params_r = jax.tree.map(
            lambda p: jnp.broadcast_to(p[None], (R,) + p.shape),
            setup["params"])
        rs = RT.init_decentralized_state(params_r, ropt, sync=sync)
        rstep = jax.jit(RT.make_decentralized_step(
            setup["rcfg"], ropt, RO.cosine_schedule(LR, 1, 10), sync, R))
        data = RDATA.SyntheticLM(VOCAB, seq_len=16, global_batch=R * 2,
                                 seed=5)
        rms = []
        for s in range(STEPS):
            rs, m = rstep(rs, {k: jnp.asarray(v)
                               for k, v in _batch(data, s).items()})
            rms.append({k: float(v) for k, v in m.items()})
    loss_tol = LOSS_TOL if "topk" in name else F32_TOL
    from repro_torch.models import state_from_reference

    want = state_from_reference(jax.tree.map(np.asarray, rs), _pcfg(),
                                device="cpu")["params"]
    for rank, res in enumerate(setup["results"]):
        got = res[name]
        for gm, rm in zip(got["metrics"], rms):
            np.testing.assert_allclose(gm["loss"], rm["loss"], rtol=loss_tol)
        if "topk" in name:
            continue  # top-k flips entries at its threshold: losses only
        for k, p in want.items():
            np.testing.assert_allclose(got["params"][k],
                                       p[rank:rank + 1].numpy(),
                                       rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def test_shard_batch_matches_numpy_slicing(setup):
    import repro.data as RDATA

    data = RDATA.SyntheticLM(VOCAB, seq_len=16, global_batch=R * 2, seed=5)
    for rank, res in enumerate(setup["results"]):
        coord = divmod(rank, 2)  # (data, model) on the (2, 2) mesh
        got = iter(res["batches"])
        for s in range(2):
            full = data.batch_at(s)
            for block, i in ((full["tokens"].shape[0] // 2, coord[0]),
                             (full["tokens"].shape[0] // 4, rank)):
                b = next(got)
                for k, v in full.items():
                    np.testing.assert_array_equal(
                        b[k], v[i * block:(i + 1) * block])


def test_decentralized_step_mesh_refusals():
    """A mesh without the replica dim, or of another size, is refused
    when the step is built (the reference refuses on its first call)."""
    from types import SimpleNamespace

    opt = TO.sgdm()
    for mesh, text in (
            (SimpleNamespace(mesh_dim_names=("data",), shape=(R,)),
             "no dim 'replica'"),
            (SimpleNamespace(mesh_dim_names=("replica",), shape=(2,)),
             "plan serves R=4")):
        with pytest.raises(ValueError, match=text):
            TT.make_decentralized_step(_pcfg(), opt, lambda s: LR,
                                       TD.SyncConfig(), R, mesh=mesh,
                                       device="cpu")
