"""Model sharding over a ("data", "model") mesh on gloo CPU ranks, against
the unsharded port and the reference.

Two process groups are started once for the module
(`dist.ranks.run_ranks`): 4 ranks holding a (2, 2) ("data", "model")
mesh, and 8 ranks holding a (2, 2, 2) ("pod", "data", "model") mesh, the
reference's multipod test's (d_model 64, 4 query heads, 2 KV heads,
head_dim 16).  In each, reduced llama3.2-3b and gemma2-27b (local and
global layers, both softcaps, post-norms, tied embeddings) in f32 with
the reference's parameters (`params_from_reference` then
`shard_params`) run sharded under `set_mesh` with `dp=` on each rank's
rows of 8 x 32 tokens: `forward`, `loss_fn` and its gradients, one
`make_train_step` AdamW step, and 4 `decode_step`s; the gradients
also with remat, their backward run outside the mesh's context, and
the input each block's remat keeps is the rank's block of the hidden
state, (B/dp, S, D/m) (`tests/torch_remat_inputs.py`).  Each
rank holds
its blocks against the matching blocks of the unsharded port's results,
computed here, and of the reference's (`forward`, `loss_fn` and
`jax.grad`), at 1e-5 relative to each leaf's largest element; a gradient
summed over a dim where it should not be (or not summed where it
should) is off by the dim's size and fails.  The 8-rank group also
saves a sharded train state on a (4, 2) mesh and restores it onto a
(2, 4) mesh (bitwise, blocks of the new mesh).  Each group also runs
one sharded Adafactor step against the unsharded one (the factored
moments `vr`, `vc` and the 1-D leaves' `v` at 1e-5 of each leaf's
largest, twice that being squares; the parameters where the gradient
exceeds 1e-5 of its leaf's largest: Adafactor's first step normalises
the gradient, so one within rounding of zero moves by a
rounding-dependent share of lr), and checks the mesh errors (a
production mesh on too few ranks, a `dp=` that leaves out a batch dim).
Head counts that "model" does not divide and the rwkv and RG-LRU
blocks are held in `tests/test_torch_sharded_kinds.py`; the mixtures of
experts in `tests/test_torch_sharded_moe.py`, whisper-tiny in
`tests/test_torch_sharded_whisper.py`.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.dist.ranks import run_ranks  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step, forward, init_cache, loss_fn, param_dict,
    params_from_reference,
)
import repro_torch.optim as TO  # noqa: E402
import repro_torch.train as TT  # noqa: E402
from torch_remat_inputs import remat_inputs  # noqa: E402

ARCHS = ("llama3.2-3b", "gemma2-27b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
B, S = 8, 32
DECODE_STEPS = 4
REL = 1e-5
# AdamW's first update is lr * g / (|g| + eps): a gradient within f32
# rounding of zero (|g| ~ eps) may move by up to lr either way, sharded
# or not (test_torch_train.py), so the step runs at a learning rate whose
# such moves stay below REL of a leaf's largest element
LR = 1e-4
TIMEOUT = 240


def _port_cfg(arch):
    return dataclasses.replace(reduce_config(get_config(arch)),
                               dtype="float32")


def _lr():
    return TO.cosine_schedule(LR, 0, 10)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1                      # masked labels count too
    return {"tokens": tok[:, :-1], "labels": labels,
            "decode": rng.integers(0, cfg.vocab_size,
                                   (DECODE_STEPS, B)).astype(np.int32)}


def _unsharded(flat, cfg, batch):
    """The unsharded port's results on the full batch."""
    full = {k: torch.tensor(v) for k, v in flat.items()}
    data = {k: batch[k] for k in ("tokens", "labels")}
    out = {"logits": forward(full, cfg, data).numpy()}
    leaves = {k: v.clone().requires_grad_() for k, v in full.items()}
    loss = loss_fn(leaves, cfg, data)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out["loss"] = float(loss)
    out["grads"] = {k: g.numpy() for k, g in zip(leaves, grads)}
    opt = TO.adamw()
    state = TT.init_train_state({k: v.clone() for k, v in full.items()}, opt)
    step = TT.make_train_step(cfg, opt, _lr(), device="cpu")
    state, m = step(state, data)
    out["stepped"] = {part: {k: v.numpy() for k, v in tree.items()}
                      for part, tree in (("params", state["params"]),
                                         ("m", state["opt"]["m"]),
                                         ("v", state["opt"]["v"]))}
    out["step_loss"], out["grad_norm"] = float(m["loss"]), float(
        m["grad_norm"])
    cache = init_cache(full, cfg, B, DECODE_STEPS)
    dec = []
    for t in range(DECODE_STEPS):
        lg, cache = decode_step(full, cfg, cache, batch["decode"][t])
        dec.append(lg.numpy())
    out["decode"] = np.stack(dec)
    opt = TO.adafactor()
    state = TT.init_train_state({k: v.clone() for k, v in full.items()}, opt)
    state, _ = TT.make_train_step(cfg, opt, _lr(), device="cpu")(state, data)
    out["adafactor"] = {f"params.{k}": v.numpy()
                        for k, v in state["params"].items()}
    out["adafactor"].update({f"{part}.{k}": a.numpy()
                             for k, v in state["opt"]["v"].items()
                             for part, a in v.items()})
    return out


def _reference(arch):
    """The reference's parameters (as the port's flat numpy dict), logits,
    loss and gradients on the batch.  jax is imported here, not at the
    top: the ranks import this module and need only the port."""
    import jax

    import repro.configs as RC
    import repro.models as RM

    rcfg = dataclasses.replace(RC.reduce_config(RC.get_config(arch)),
                               dtype="float32")
    cfg = _port_cfg(arch)
    batch = _batch(cfg, seed=len(arch))
    params = RM.Transformer(rcfg, model_axis=1).init(jax.random.PRNGKey(0))
    data = {k: batch[k] for k in ("tokens", "labels")}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(RM.loss_fn),
                                  static_argnums=1)(params, rcfg, data)

    def flat(tree):
        return {k: v.numpy() for k, v in param_dict(params_from_reference(
            jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}

    return batch, flat(params), {
        "logits": np.asarray(jax.jit(RM.forward, static_argnums=1)(
            params, rcfg, {"tokens": data["tokens"]})),
        "loss": float(ref_loss), "grads": flat(ref_grads)}


def _err(got, want) -> float:
    want = torch.as_tensor(want)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


def _check_arch(mesh, dp, arch, flat, batch, want, ref):
    """One arch's sharded runs in this rank: errors of its blocks."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import set_mesh
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import param_specs

    cfg = _port_cfg(arch)
    specs = param_specs(cfg, mesh)
    full = {k: torch.tensor(v) for k, v in flat.items()}
    local = SH.shard_params(full, mesh, specs)
    rows = shard_batch(batch, mesh, dp)
    data = {k: rows[k] for k in ("tokens", "labels")}
    block = lambda a, spec: SH.local_block(torch.as_tensor(a), mesh, spec)
    lspec = (dp, None, "model")
    err = {}
    with set_mesh(mesh):
        logits = forward(local, cfg, {"tokens": data["tokens"]}, dp=dp)
        err["forward"] = _err(logits, block(want["logits"], lspec))
        err["forward_ref"] = _err(logits, block(ref["logits"], lspec))
        err["gather_act"] = _err(SH.gather_act(logits, mesh, lspec),
                                 want["logits"])
        leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
        loss = loss_fn(leaves, cfg, data, dp=dp)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        err["loss"] = abs(float(loss) - want["loss"]) / abs(want["loss"])
        err["loss_ref"] = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
        err["grads"] = {k: _err(g, block(want["grads"][k], specs[k]))
                        for k, g in zip(leaves, grads)}
        err["grads_ref"] = {k: _err(g, block(ref["grads"][k], specs[k]))
                            for k, g in zip(leaves, grads)}
        # with remat each block is recomputed in backward, which may run
        # outside the mesh's context (on the card, in autograd's thread)
        leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
        with remat_inputs() as err["remat_inputs"]:
            loss = loss_fn(leaves, dataclasses.replace(cfg, remat=True),
                           data, dp=dp)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    err["grads_remat"] = {k: _err(g, block(want["grads"][k], specs[k]))
                          for k, g in zip(leaves, grads)}
    with set_mesh(mesh):
        opt = TO.adamw()
        state = TT.init_train_state({k: v.clone() for k, v in local.items()},
                                    opt)
        step = TT.make_train_step(cfg, opt, _lr(), device="cpu", dp=dp)
        state, m = step(state, data)
        err["step_loss"] = abs(float(m["loss"]) - want["step_loss"]) / abs(
            want["step_loss"])
        err["grad_norm"] = abs(float(m["grad_norm"]) - want["grad_norm"]) / (
            want["grad_norm"])
        err["adamw"] = {f"{part}.{k}": _err(v, block(
            want["stepped"][part][k], specs[k]))
            for part, tree in (("params", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"]))
            for k, v in tree.items()}
        whole = SH.gather_params(state["params"], mesh, specs)
        err["gather_params"] = max(_err(v, want["stepped"]["params"][k])
                                   for k, v in whole.items())
        cache = init_cache(local, cfg, data["tokens"].shape[0],
                           DECODE_STEPS, dp=dp)
        kv = cache["layers"][0]["k"].shape
        dec_rows = shard_batch({"d": batch["decode"].T}, mesh, dp)["d"].T
        err["decode"] = []
        for t in range(DECODE_STEPS):
            lg, cache = decode_step(local, cfg, cache, dec_rows[t], dp=dp)
            err["decode"].append(_err(lg, block(want["decode"][t],
                                                (dp, "model"))))
        err["adafactor"] = _adafactor(mesh, dp, cfg, local, data, want,
                                      specs)
    err["kv_heads"] = kv[1]
    return err


def _adafactor(mesh, dp, cfg, local, data, want, specs):
    """One sharded Adafactor step against the unsharded one: each block's
    error relative to its leaf's largest element (module docstring)."""
    from repro_torch.launch.specs import state_shardings
    from repro_torch.models import sharded as SH

    opt = TO.adafactor()
    state = TT.init_train_state({k: v.clone() for k, v in local.items()}, opt)
    state, _ = TT.make_train_step(cfg, opt, _lr(), device="cpu", dp=dp)(
        state, data)
    ref = want["adafactor"]
    shapes = {k: torch.empty(v.shape) for k, v in want["grads"].items()}
    sh = state_shardings(mesh, shapes, {k: specs[k] for k in shapes},
                         opt.init(shapes))["opt"]["v"]
    block = lambda a, spec: SH.local_block(torch.as_tensor(a), mesh, spec)
    err = {f"{part}.{k}": _err(a, block(ref[f"{part}.{k}"], sh[k][part]))
           for k, v in state["opt"]["v"].items() for part, a in v.items()}
    for k, p in state["params"].items():
        g = block(want["grads"][k], specs[k]).abs()
        held = g > REL * g.max()
        err[f"params.{k}"] = _err(p[held], block(ref[f"params.{k}"],
                                                 specs[k])[held])
    return err


def _elastic(rank, flat, stepped, ckpt_dir):
    """Save a train state sharded on a (4, 2) mesh, restore it on (2, 4)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.specs import state_shardings
    from repro_torch.models import Transformer
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import param_specs

    cfg = _port_cfg("llama3.2-3b")
    names = ("data", "model")
    opt = TO.adamw()
    model = Transformer(cfg, model_axis=2)
    p_abs, specs = model.abstract(), model.specs()
    opt_abs = opt.init(p_abs)
    full = {"params": stepped["params"], "m": stepped["m"],
            "v": stepped["v"]}
    full = {part: {k: torch.tensor(v) for k, v in tree.items()}
            for part, tree in full.items()}

    def sharded_state(mesh, tree):
        ps = param_specs(cfg, mesh)
        sh = lambda t: SH.shard_params(t, mesh, ps)
        return {"params": sh(tree["params"]),
                "opt": {"m": sh(tree["m"]), "v": sh(tree["v"]),
                        "count": torch.ones((), dtype=torch.int32)},
                "step": 1}

    mesh_a = init_device_mesh("cpu", (4, 2), mesh_dim_names=names)
    mesh_b = init_device_mesh("cpu", (2, 4), mesh_dim_names=names)
    state_a = sharded_state(mesh_a, full)
    TT.save_checkpoint(ckpt_dir, state_a, 3, shardings=state_shardings(
        mesh_a, p_abs, specs, opt_abs), mesh=mesh_a)
    zeros = {part: {k: torch.zeros_like(v) for k, v in tree.items()}
             for part, tree in full.items()}
    like = sharded_state(mesh_b, zeros)
    like["step"] = 0
    like["opt"]["count"].zero_()
    got, step = TT.restore_checkpoint(
        ckpt_dir, like, shardings=state_shardings(mesh_b, p_abs, specs,
                                                  opt_abs), mesh=mesh_b)
    want = sharded_state(mesh_b, full)
    same = all(torch.equal(got[p][k], want[p][k])
               for p in ("params",) for k in want[p])
    same &= all(torch.equal(got["opt"][p][k], want["opt"][p][k])
                for p in ("m", "v") for k in want["opt"][p])
    return {"step": step, "count": int(got["opt"]["count"]),
            "bitwise": same, "state_step": got["step"],
            "embed_block": tuple(got["params"]["embed"].shape),
            "embed_full": tuple(full["params"]["embed"].shape)}


def _rank(rank, world, mesh_key, inputs, ckpt_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import batch_axes, make_production_mesh, set_mesh
    from repro_torch.models import sharded

    shape, names = MESHES[mesh_key]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    dp = batch_axes(mesh)
    out = {"arch": {arch: _check_arch(mesh, dp, arch, *inputs[arch])
                    for arch in ARCHS}}
    try:
        make_production_mesh(device_type="cpu")
        out["production"] = "no error"
    except ValueError as e:
        out["production"] = str(e)
    try:
        with set_mesh(mesh):
            sharded.layout(_port_cfg("llama3.2-3b"), ("data",))
        out["dp_mismatch"] = "no error"
    except ValueError as e:
        out["dp_mismatch"] = str(e)
    if world == 8:
        arch = "llama3.2-3b"
        out["elastic"] = _elastic(rank, inputs[arch][0],
                                  inputs[arch][2]["stepped"], ckpt_dir)
    return out


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for arch in ARCHS:
        batch, flat, ref = _reference(arch)
        out[arch] = (flat, batch, _unsharded(flat, _port_cfg(arch), batch),
                     ref)
    return out


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    out = {}
    for key, (shape, _) in MESHES.items():
        out[key] = run_ranks(_rank, int(np.prod(shape)), key, inputs,
                             str(tmp_path_factory.mktemp("ckpt")),
                             backend="gloo", timeout=TIMEOUT, threads=1)
    return out


def _all(results, mesh, arch, name):
    return [r["arch"][arch][name] for r in results[mesh]]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_port_matches_reference(inputs, arch, mesh):
    """The unsharded port against the reference on the same parameters
    (the sharded checks below hold both)."""
    _, _, want, ref = inputs[arch]
    assert _err(torch.tensor(want["logits"]), ref["logits"]) < REL
    assert abs(want["loss"] - ref["loss"]) / abs(ref["loss"]) < REL
    for k, g in want["grads"].items():
        assert _err(torch.tensor(g), ref["grads"][k]) < REL, k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward(results, arch, mesh):
    for name in ("forward", "forward_ref", "gather_act"):
        errs = _all(results, mesh, arch, name)
        assert max(errs) < REL, (name, errs)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss(results, arch, mesh):
    for name in ("loss", "loss_ref"):
        errs = _all(results, mesh, arch, name)
        assert max(errs) < REL, (name, errs)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("against", ("grads", "grads_ref", "grads_remat"))
def test_sharded_gradients_leaf_by_leaf(results, arch, mesh, against):
    for rank, errs in enumerate(_all(results, mesh, arch, against)):
        bad = {k: e for k, e in errs.items() if not e < REL}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_saves_the_ranks_block_of_the_hidden_state(results, arch,
                                                         mesh):
    """Each block's remat keeps its input as the rank's block (B/dp, S,
    D/m): "model" 2 divides d_model 64."""
    cfg = _port_cfg(arch)
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    rows = B // math.prod(n for k, n in sizes.items() if k != "model")
    want = (rows, S, cfg.d_model // sizes["model"])
    for rank, seen in enumerate(_all(results, mesh, arch, "remat_inputs")):
        assert [k for k, _, _ in seen] == list(cfg.layer_kinds()), rank
        assert {x for _, x, _ in seen} == {want}, (rank, seen)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_adamw_step(results, arch, mesh):
    for name in ("step_loss", "grad_norm", "gather_params"):
        errs = _all(results, mesh, arch, name)
        assert max(errs) < REL, (name, errs)
    for rank, errs in enumerate(_all(results, mesh, arch, "adamw")):
        bad = {k: e for k, e in errs.items() if not e < REL}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode(results, arch, mesh):
    errs = _all(results, mesh, arch, "decode")
    assert all(len(e) == DECODE_STEPS for e in errs)
    assert max(max(e) for e in errs) < REL, errs
    # the cache holds the rank's KV heads: 2 KV heads over "model" 2
    assert set(_all(results, mesh, arch, "kv_heads")) == {1}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_adafactor_and_mesh_errors_refuse(results, mesh):
    """The sharded Adafactor step equals the unsharded one (module
    docstring); the mesh errors still refuse."""
    for rank, r in enumerate(results[mesh]):
        for arch in ARCHS:
            errs = r["arch"][arch]["adafactor"]
            assert any(k.startswith("vr.") for k in errs), errs
            bad = {k: e for k, e in errs.items()
                   if not e < (REL if k.startswith("params.") else 2 * REL)}
            assert not bad, (rank, arch, bad)
        assert "needs 256 ranks" in r["production"], r["production"]
    msgs = [r["dp_mismatch"] for r in results[mesh]]
    if mesh == "2x2x2":  # "pod" is neither in dp nor "model"
        assert all("not dp=" in m for m in msgs), msgs
    else:
        assert all(m == "no error" for m in msgs), msgs


def test_elastic_checkpoint_restore_across_meshes(results):
    for r in results["2x2x2"]:
        e = r["elastic"]
        assert e["bitwise"]
        assert e["step"] == 3 and e["state_step"] == 1 and e["count"] == 1
        # (V, D) = (512, 64) on the (2, 4) mesh: V over "model", D over "data"
        assert e["embed_full"] == (512, 64)
        assert e["embed_block"] == (128, 32)
