"""The port's decentralized training against the reference on the CPU:
`make_decentralized_step` (R replicas, per-replica gradients mixed by a
`dist` strategy), `state_from_reference` of an R-stacked state, and
`run_train_scenarios` over the default failure matrix.

Sizes: llama3.2-3b at `reduce_config` (2 layers, d 64), vocab 256,
SyntheticLM batches of 16 tokens, 2 a replica.  The reference runs
inside `jax.threefry_partitionable(False)` (the fault masks' threefry
layout).  With `sgdm` the parameters after 3 steps are compared at
1e-5 and the metrics at 1e-5 (the grad-norm at 1e-4, as
`test_torch_train.py` holds it).  Compression is discontinuous in its
inputs: an entry 1e-8 either side of the top-k threshold or of an int8
rounding boundary flips, and a flip moves that entry's residual by a
whole quantization step.  So the top-k run, like AdamW's, compares the
loss trajectory at 1e-4, and no multi-step run compares residuals
(`test_torch_dist.py` compares them for one sync on the same inputs).
Exact strategies keep the port's replicas bitwise identical.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.dist as RD  # noqa: E402
import repro.models as RM  # noqa: E402
import repro.optim as RO  # noqa: E402
import repro.train as RT  # noqa: E402
import repro_torch.dist as TD  # noqa: E402
import repro_torch.optim as TO  # noqa: E402
import repro_torch.train as TT  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models import state_from_reference  # noqa: E402

F32_TOL = 1e-5
LOSS_TOL = 1e-4
GNORM_TOL = 1e-4
VOCAB = 256
R = 4


@pytest.fixture(autouse=True)
def _older_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(scope="module")
def model():
    rcfg = dataclasses.replace(RC.reduce_config(RC.get_config("llama3.2-3b")),
                               dtype="float32", vocab_size=VOCAB)
    pcfg = dataclasses.replace(reduce_config(get_config("llama3.2-3b")),
                               dtype="float32", vocab_size=VOCAB)
    params = RM.Transformer(rcfg, model_axis=1).init(jax.random.PRNGKey(0))
    return rcfg, pcfg, params


def _port_sync(cfg: RD.SyncConfig) -> TD.SyncConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["compression"] = TD.CompressionConfig(
        **dataclasses.asdict(cfg.compression))
    if cfg.failures is not None:
        fields["failures"] = TD.SyncFailureModel(
            **dataclasses.asdict(cfg.failures))
    return TD.SyncConfig(**fields)


def _batch(data, s, Rn=R):
    return {k: v.reshape(Rn, -1, *v.shape[1:])
            for k, v in data.batch_at(s).items()}


def _port_state(rs, pcfg):
    return state_from_reference(jax.tree.map(np.asarray, rs), pcfg,
                                device="cpu")


def _run_both(model, sync, opt_name="sgdm", steps=3, start_ref_steps=0):
    """The reference and the port from one R-replicated state (after
    `start_ref_steps` reference steps), `steps` steps each."""
    rcfg, pcfg, params = model
    ropt, popt = RO.make_optimizer(opt_name), TO.make_optimizer(opt_name)
    lr = 1e-2 if opt_name == "sgdm" else 1e-3
    rlr, plr = RO.cosine_schedule(lr, 1, 10), TO.cosine_schedule(lr, 1, 10)
    params_r = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (R,) + p.shape),
                            params)
    rs = RT.init_decentralized_state(params_r, ropt, sync=sync)
    rstep = jax.jit(RT.make_decentralized_step(rcfg, ropt, rlr, sync, R))
    pstep = TT.make_decentralized_step(pcfg, popt, plr, _port_sync(sync), R,
                                       device="cpu")
    data = SyntheticLM(VOCAB, seq_len=16, global_batch=R * 2, seed=5)
    for s in range(start_ref_steps):
        rs, _ = rstep(rs, {k: jnp.asarray(v) for k, v in _batch(data, s).items()})
    ps = _port_state(rs, pcfg)
    rms, pms = [], []
    for s in range(start_ref_steps, start_ref_steps + steps):
        b = _batch(data, s)
        rs, rm = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, b)
        rms.append({k: float(v) for k, v in rm.items()})
        pms.append({k: float(v) for k, v in pm.items()})
    return rs, ps, rms, pms


def _check_metrics(rms, pms, loss_tol=F32_TOL):
    for rm, pm in zip(rms, pms):
        assert rm.keys() == pm.keys()
        for k in rm:
            tol = (loss_tol if k == "loss" else GNORM_TOL if k == "grad_norm"
                   else F32_TOL)
            np.testing.assert_allclose(pm[k], rm[k], rtol=tol, atol=1e-7,
                                       err_msg=k)


def _replicas_identical(params):
    return all(torch.equal(p, p[:1].expand_as(p)) for p in params.values())


SGDM_SYNCS = {
    "allreduce": RD.SyncConfig("allreduce"),
    "hierarchical": RD.SyncConfig("hierarchical", levels=(2, 2)),
    "multiscale_rotated_int8": RD.SyncConfig(
        "multiscale", rotation_period=3, compression="int8"),
    "ring_churn_survivor": RD.SyncConfig(
        "ring", rounds=(3,), compression="int8",
        failures=RD.SyncFailureModel(churn_fraction=0.25, seed=3),
        aggregation="survivor_weighted"),
    "multiscale_byzantine_trimmed": RD.SyncConfig(
        "multiscale", aggregation="trimmed_mean",
        failures=RD.SyncFailureModel(byzantine_fraction=0.25, seed=1)),
    "multiscale_overlap": RD.SyncConfig("multiscale", overlap="one_step",
                                        rotation_period=2),
}


@pytest.mark.parametrize("name", list(SGDM_SYNCS))
def test_decentralized_step_matches_reference(model, name):
    sync = SGDM_SYNCS[name]
    rs, ps, rms, pms = _run_both(model, sync)
    _check_metrics(rms, pms)
    want = _port_state(rs, model[1])
    for part in ("params", "prev_grads"):
        if part in want:
            for k in want[part]:
                np.testing.assert_allclose(
                    ps[part][k].numpy(), want[part][k].numpy(), rtol=F32_TOL,
                    atol=F32_TOL, err_msg=f"{part} {k}")
    np.testing.assert_array_equal(ps["opt"]["count"].numpy(),
                                  want["opt"]["count"].numpy())
    if sync.strategy in ("allreduce", "hierarchical"):
        assert _replicas_identical(ps["params"])


def test_overlap_warmup_leaves_state_bitwise_unchanged(model):
    rcfg, pcfg, params = model
    sync = _port_sync(RD.SyncConfig("multiscale", overlap="one_step",
                                    compression="int8"))
    opt = TO.adamw(weight_decay=0.01)
    flat = _port_state(RT.init_train_state(params, RO.sgdm()), pcfg)["params"]
    state = TT.init_decentralized_state(TT.replicate(flat, R), opt, sync=sync)
    before = {k: v.clone() for k, v in state["params"].items()}
    m_before = {k: v.clone() for k, v in state["opt"]["m"].items()}
    step = TT.make_decentralized_step(pcfg, opt, lambda s: 1e-3, sync, R,
                                      device="cpu")
    data = SyntheticLM(VOCAB, seq_len=16, global_batch=R * 2, seed=5)
    state, m = step(state, _batch(data, 0))
    assert m["sync_overlap_fraction"] == 0.0
    for k in before:
        assert torch.equal(state["params"][k], before[k])
        assert torch.equal(state["opt"]["m"][k], m_before[k])
    assert int(state["opt"]["count"][0]) == 0 and state["step"] == 1
    state, m = step(state, _batch(data, 1))
    assert m["sync_overlap_fraction"] == 1.0
    assert not torch.equal(state["params"]["embed"], before["embed"])


def test_topk_and_adamw_loss_trajectories(model):
    """Discontinuous choices (top-k selection, AdamW's first sign step):
    the loss trajectory at 1e-4; the port's error feedback conserves
    the accumulator."""
    sync = RD.SyncConfig("multiscale", rotation_period=3,
                         compression=RD.CompressionConfig("topk", 0.25))
    _, ps, rms, pms = _run_both(model, sync)
    np.testing.assert_allclose([m["loss"] for m in pms],
                               [m["loss"] for m in rms], rtol=LOSS_TOL)
    assert float(TO.global_norm(ps["residuals"])) > 0
    _, _, rms, pms = _run_both(model, RD.SyncConfig("ring", rounds=(2,)),
                               opt_name="adamw")
    np.testing.assert_allclose([m["loss"] for m in pms],
                               [m["loss"] for m in rms], rtol=LOSS_TOL)


def test_state_from_reference_mid_run_decentralized(model):
    """A reference state one step in, with residuals and in-flight
    gradients, carried across: both go on alike."""
    sync = RD.SyncConfig("multiscale", overlap="one_step", compression="int8",
                         rotation_period=2)
    rs, ps, rms, pms = _run_both(model, sync, steps=2, start_ref_steps=1)
    assert ps["step"] == 3 and set(ps) == {"params", "opt", "step",
                                           "residuals", "prev_grads"}
    _check_metrics(rms, pms)
    want = _port_state(rs, model[1])
    for k in want["params"]:
        np.testing.assert_allclose(ps["params"][k].numpy(),
                                   want["params"][k].numpy(), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)


def test_run_train_scenarios_matches_reference(model):
    """The default four-scenario matrix at R=8, 2 steps each, from the
    same parameters and stream: every scenario's losses and degradation
    metrics."""
    rcfg, pcfg, params = model
    Rn = 8
    data = SyntheticLM(VOCAB, seq_len=16, global_batch=Rn, seed=5)
    ref = RT.run_train_scenarios(rcfg, RO.sgdm(), lambda s: 1e-2,
                                 RD.SyncConfig("multiscale"), Rn, params,
                                 data, num_steps=2)
    flat = _port_state(RT.init_train_state(params, RO.sgdm()), pcfg)["params"]
    port = TT.run_train_scenarios(pcfg, TO.sgdm(), lambda s: 1e-2,
                                  TD.SyncConfig("multiscale"), Rn, flat,
                                  data, num_steps=2, device="cpu")
    assert [r.scenario.name for r in port] == [r.scenario.name for r in ref] \
        == ["baseline", "churn", "straggler", "byzantine"]
    for a, b in zip(ref, port):
        assert b.scenario.aggregation == a.scenario.aggregation
        _check_metrics(a.history, b.history)
        assert b.effective_replica_fraction_mean == \
            a.effective_replica_fraction_mean
        assert b.rejected_gradients_total == a.rejected_gradients_total
        np.testing.assert_allclose(b.final_loss, a.final_loss, rtol=F32_TOL)
    assert port[3].rejected_gradients_total == 2.0
    for k, v in flat.items():  # the base parameters are left as they were
        assert torch.equal(v, _port_state(RT.init_train_state(
            params, RO.sgdm()), pcfg)["params"][k])


def test_decentralized_step_requires_its_state(model):
    _, pcfg, params = model
    flat = _port_state(RT.init_train_state(params, RO.sgdm()), pcfg)["params"]
    opt = TO.sgdm()
    state = TT.init_decentralized_state(TT.replicate(flat, R), opt)
    data = SyntheticLM(VOCAB, seq_len=16, global_batch=R * 2, seed=5)
    for sync, what in ((TD.SyncConfig("multiscale", compression="int8"),
                        "error-feedback"),
                       (TD.SyncConfig("multiscale", overlap="one_step"),
                        "in-flight")):
        step = TT.make_decentralized_step(pcfg, opt, lambda s: 1e-2, sync, R,
                                          device="cpu")
        with pytest.raises(ValueError, match=what):
            step(state, _batch(data, 0))
    # a mesh without a "replica" dim is refused, as the reference does
    no_replica = SimpleNamespace(mesh_dim_names=("data",), shape=(R,))
    with pytest.raises(ValueError, match="no dim 'replica'"):
        TT.make_decentralized_step(pcfg, opt, lambda s: 1e-2,
                                   TD.SyncConfig(), R, mesh=no_replica,
                                   device="cpu")
