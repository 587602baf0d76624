"""Model sharding of the mixtures of experts and the sharded Adafactor,
on gloo CPU ranks, against the unsharded port and the reference.

A process group of 4 ranks (`dist.ranks.run_ranks`) holds a (1, 4) and
a (2, 2) ("data", "model") mesh, and one of 8 ranks a (2, 2, 2) ("pod",
"data", "model") mesh.  Reduced configs in f32 with the reference's
parameters (`params_from_reference` then `shard_params`), both at a
`moe_capacity_factor` of 0.01, so every expert's capacity is the
smallest, 256, and every expert drops tokens:

* expert parallel: llama4-maverick-400b-a17b with 16 experts, top-1
  (their specs at `model_axis` 16 put E over "model"), on 16 x 512
  tokens, on (1, 4) and (2, 2);
* tensor parallel inside each expert: grok-1-314b with 3 experts,
  top-2 (d_ff over "model"), on 8 x 128 tokens, on (2, 2) and
  (2, 2, 2).

Each runs sharded under `set_mesh` with `dp=` on each rank's rows:
`forward`, `loss_fn` and every gradient leaf (also with remat, its
backward outside the mesh's context; each block's remat keeps its input
as the rank's block (B/dp, S, D/m), `tests/torch_remat_inputs.py`), one
`make_train_step` Adafactor step (the moments `vr`, `vc` and `v`, and
the parameters) and 4 decode steps from a sharded `init_cache`.  The model's one chunk of tokens
spans the data-parallel ranks (on (2, 2) and (2, 2, 2)), so each rank's
capacity ranks take the prefix of the ranks before it.  `moe_ffn` alone
then runs each case's first MoE block on 8 rows of 1024 (768 on the pod
mesh) tokens at a `token_chunk` inside one rank's rows, one spanning
ranks (on the pod mesh one that also cuts a rank's rows in two) and the
default, where the FSDP gathers move the experts' weights, and on 8
rows of 2 tokens, where they move the tokens (fewer bytes; a spy on
`reduce_scatter` tells the routes apart): its output and the gradients
of its input and of each weight block.

Each rank holds its blocks against the matching blocks of the unsharded
port's results and of the reference's (run inside
`jax.threefry_partitionable(False)`), at 1e-5 relative to each leaf's
largest element.  The gradients and the second moments are held leaf by
leaf to the larger of 1e-5 and 4 times the leaf's conditioning: the
largest relative change of the unsharded port's gradient of that leaf
under a 1e-7 relative perturbation of its parameters (about one f32
rounding); the moments twice that, being squares.  That is about 1e-6
for every leaf but the top-1 router: with one expert a token, the
renormalised gate is exactly 1 and its gradient is analytically zero, so
what autograd gives is rounding noise (held to be at most 1e-4 of the
largest gradient of the block's other weights).  Adafactor's first step
normalises each gradient, so a parameter whose gradient is noise moves
by a rounding-dependent share of lr in any f32 computation: the stepped
parameters are held where the unsharded gradient exceeds the leaf's
bound times its largest, and the moments everywhere.  A gradient summed
over a wrong dim, or the router's not summed over "model", is off by a
share of the leaf and fails; a capacity rank without the earlier ranks'
prefix keeps tokens the unsharded model drops and fails the forward.

The 4-rank group also saves a sharded Adafactor train state (the
tensor-parallel case's, with its 3-D experts' (E, D) and (E, F)
factored moments) from (2, 2) and restores it onto (4, 1), bitwise.
Every registry config passes `check_config` at "model" 2, 4 and 16,
and its specs sanitize against those meshes.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, reduce_config  # noqa: E402
from repro_torch.dist.ranks import run_ranks  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step, forward, init_cache, loss_fn, param_dict,
    params_from_reference,
)
from repro_torch.models import moe  # noqa: E402
import repro_torch.optim as TO  # noqa: E402
import repro_torch.train as TT  # noqa: E402
from torch_remat_inputs import remat_inputs  # noqa: E402

# config key: (arch, config changes, (B, S))
CONFIGS = {
    "ep": ("llama4-maverick-400b-a17b",
           {"num_experts": 16, "experts_per_token": 1}, (16, 512)),
    "tp": ("grok-1-314b", {"num_experts": 3, "experts_per_token": 2},
           (8, 128)),
}
# case: (config key, mesh shape)
CASES = {
    "ep-1x4": ("ep", (1, 4)),
    "ep-2x2": ("ep", (2, 2)),
    "tp-2x2": ("tp", (2, 2)),
    "tp-2x2x2": ("tp", (2, 2, 2)),
}
# moe_ffn alone: case -> (rows' length, token chunk) runs
DEFAULT_CHUNK = 131_072
FEW = 2                 # tokens a row where the tokens are gathered
ALONE = {
    "ep-1x4": ((1024, 2048), (1024, DEFAULT_CHUNK), (FEW, DEFAULT_CHUNK)),
    "ep-2x2": ((1024, 1024), (1024, DEFAULT_CHUNK), (FEW, DEFAULT_CHUNK)),
    "tp-2x2": ((1024, 1024), (1024, DEFAULT_CHUNK), (FEW, DEFAULT_CHUNK)),
    # 4 ranks of 2 x 768 tokens: 768 inside, 2048 spans rank 0's and
    # cuts rank 1's rows in two
    "tp-2x2x2": ((768, 768), (768, 2048), (768, DEFAULT_CHUNK),
                 (FEW, DEFAULT_CHUNK)),
}
ALONE_ROWS = 8
CAPACITY_FACTOR = 0.01
DECODE_STEPS = 4
REL = 1e-5
LR = 1e-4
COND_FACTOR = 4
COND_PERTURBATION = 1e-7
TOP1_ROUTER = 1e-4
TIMEOUT = 300


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _port_cfg(key):
    arch, changes, _ = CONFIGS[key]
    return dataclasses.replace(reduce_config(get_config(arch)),
                               dtype="float32",
                               moe_capacity_factor=CAPACITY_FACTOR, **changes)


def _lr():
    return TO.cosine_schedule(LR, 0, 10)


def _batch(cfg, key):
    B, S = CONFIGS[key][2]
    rng = np.random.default_rng(len(key))
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1                      # masked labels count too
    return {"tokens": tok[:, :-1], "labels": labels,
            "decode": rng.integers(0, cfg.vocab_size,
                                   (DECODE_STEPS, B)).astype(np.int32)}


def _alone_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    shape = (ALONE_ROWS, S, cfg.d_model)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _moe_block(flat):
    pre = "blocks.0.moe."
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


def _err(got, want) -> float:
    want = torch.as_tensor(want)
    scale = float(want.abs().max())
    return float((got.detach() - want).abs().max()) / max(scale, 1e-30)


class _Drops:
    """Records, for each unsharded MoE chunk, which experts were picked
    by more assignments than the capacity."""

    def __init__(self):
        self.over = []
        self._chunk = moe._moe_chunk

        def spy(params, cfg, xt):
            _, experts = moe._route(params["router"], cfg, xt)
            counts = torch.bincount(experts.reshape(-1),
                                    minlength=cfg.num_experts)
            self.over.append((counts > moe.capacity(cfg, xt.shape[0]))
                             .tolist())
            return self._chunk(params, cfg, xt)
        moe._moe_chunk = spy

    def close(self):
        moe._moe_chunk = self._chunk


def _adafactor_tree(state):
    """{"params.k", "vr.k", "vc.k", "v.k": numpy} of a train state."""
    out = {f"params.{k}": v.numpy() for k, v in state["params"].items()}
    for k, v in state["opt"]["v"].items():
        for part, a in v.items():
            out[f"{part}.{k}"] = a.numpy()
    return out


def _unsharded(flat, cfg, batch):
    """The unsharded port's results on the full batch."""
    full = {k: torch.tensor(v) for k, v in flat.items()}
    data = {k: batch[k] for k in ("tokens", "labels")}
    drops = _Drops()
    try:
        out = {"logits": forward(full, cfg, data).numpy()}
    finally:
        drops.close()
    out["drops"] = drops.over

    def grads(params):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = loss_fn(leaves, cfg, data)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, g))

    out["loss"], g = grads(full)
    out["grads"] = {k: v.numpy() for k, v in g.items()}
    gen = torch.Generator().manual_seed(0)
    _, moved = grads({k: v * (1 + COND_PERTURBATION * torch.randn(
        v.shape, generator=gen)) for k, v in full.items()})
    out["cond"] = {k: _err(moved[k], v) for k, v in g.items()}
    opt = TO.adafactor()
    state = TT.init_train_state({k: v.clone() for k, v in full.items()}, opt)
    state, m = TT.make_train_step(cfg, opt, _lr(), device="cpu")(state, data)
    out["stepped"] = _adafactor_tree(state)
    out["step_loss"] = float(m["loss"])
    out["grad_norm"] = float(m["grad_norm"])
    cache = init_cache(full, cfg, batch["tokens"].shape[0], DECODE_STEPS)
    dec = []
    for t in range(DECODE_STEPS):
        lg, cache = decode_step(full, cfg, cache, batch["decode"][t])
        dec.append(lg.numpy())
    out["decode"] = np.stack(dec)
    return out


def _reference(key):
    """The reference's parameters (as the port's flat numpy dict), logits,
    loss, gradients, decode logits, and `moe_ffn` alone on the first
    block's experts at every case's token chunks.  jax is imported here,
    not at the top: the ranks import this module and need only the
    port."""
    import jax
    import jax.numpy as jnp

    import repro.configs as RC
    import repro.models as RM
    from repro.models import moe as ref_moe

    arch, changes, _ = CONFIGS[key]
    rcfg = dataclasses.replace(RC.reduce_config(RC.get_config(arch)),
                               dtype="float32",
                               moe_capacity_factor=CAPACITY_FACTOR, **changes)
    cfg = _port_cfg(key)
    batch = _batch(cfg, key)
    B = batch["tokens"].shape[0]
    with jax.threefry_partitionable(False):
        params = RM.Transformer(rcfg, model_axis=1).init(
            jax.random.PRNGKey(0))
    data = {k: batch[k] for k in ("tokens", "labels")}

    def run(p, data, toks):
        def step(cache, t):
            lg, cache = RM.decode_step(p, rcfg, cache, t)
            return cache, lg

        cache = RM.init_cache(p, rcfg, batch=B, max_len=DECODE_STEPS)
        return (RM.forward(p, rcfg, {"tokens": data["tokens"]}),
                jax.value_and_grad(RM.loss_fn)(p, rcfg, data),
                jax.lax.scan(step, cache, toks)[1])

    logits, (loss, grads), dec = jax.jit(run)(params, data, batch["decode"])

    def flat(tree):
        return {k: v.numpy() for k, v in param_dict(params_from_reference(
            jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}

    fp = flat(params)
    block = {k: jnp.asarray(v) for k, v in _moe_block(fp).items()}
    alone = {}
    for case, (ckey, _) in CASES.items():
        if ckey != key:
            continue
        for S, tc in ALONE[case]:
            if (S, tc) in alone:
                continue
            x, w = _alone_inputs(cfg, S, seed=S)

            def f(p, x, tc=tc, w=w):
                return (ref_moe.moe_ffn(p, rcfg, x, dp=None, token_chunk=tc)
                        * w).sum()
            y = jax.jit(lambda p, x, tc=tc: ref_moe.moe_ffn(
                p, rcfg, x, dp=None, token_chunk=tc))(block, jnp.asarray(x))
            gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(block,
                                                          jnp.asarray(x))
            alone[(S, tc)] = {"y": np.asarray(y), "x": np.asarray(gx),
                              **{k: np.asarray(v) for k, v in gp.items()}}
    return batch, fp, {
        "logits": np.asarray(logits), "loss": float(loss),
        "grads": flat(grads), "decode": np.asarray(dec), "alone": alone}


def _leaf_tol(want, k) -> float:
    return max(REL, COND_FACTOR * want["cond"][k])


def _check_case(mesh, dp, case, flat, batch, want, ref):
    """One case's sharded runs in this rank: errors of its blocks."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import set_mesh
    from repro_torch.launch.specs import state_shardings
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import param_specs

    key = CASES[case][0]
    cfg = _port_cfg(key)
    specs = param_specs(cfg, mesh)
    full = {k: torch.tensor(v) for k, v in flat.items()}
    local = SH.shard_params(full, mesh, specs)
    data = shard_batch({k: batch[k] for k in ("tokens", "labels")}, mesh,
                       dp)
    block = lambda a, spec: SH.local_block(torch.as_tensor(a), mesh, spec)
    lspec = (dp, None, "model")
    err = {}
    with set_mesh(mesh):
        logits = forward(local, cfg, {"tokens": data["tokens"]}, dp=dp)
        err["forward"] = _err(logits, block(want["logits"], lspec))
        err["forward_ref"] = _err(logits, block(ref["logits"], lspec))
        leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
        loss = loss_fn(leaves, cfg, data, dp=dp)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss = float(loss.detach())
        err["loss"] = abs(loss - want["loss"]) / abs(want["loss"])
        err["loss_ref"] = abs(loss - ref["loss"]) / abs(ref["loss"])
        err["grads"] = {k: _err(g, block(want["grads"][k], specs[k]))
                        for k, g in zip(leaves, grads)}
        err["grads_ref"] = {k: _err(g, block(ref["grads"][k], specs[k]))
                            for k, g in zip(leaves, grads)}
        leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
        with remat_inputs() as err["remat_inputs"]:
            loss = loss_fn(leaves, dataclasses.replace(cfg, remat=True),
                           data, dp=dp)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    err["grads_remat"] = {k: _err(g, block(want["grads"][k], specs[k]))
                          for k, g in zip(leaves, grads)}
    with set_mesh(mesh):
        opt = TO.adafactor()
        state = TT.init_train_state({k: v.clone() for k, v in local.items()},
                                    opt)
        step = TT.make_train_step(cfg, opt, _lr(), device="cpu", dp=dp)
        state, m = step(state, data)
        err["step_loss"] = abs(float(m["loss"]) - want["step_loss"]) / abs(
            want["step_loss"])
        err["grad_norm"] = abs(float(m["grad_norm"]) - want["grad_norm"]) / (
            want["grad_norm"])
        sh = state_shardings(mesh, {k: v for k, v in full.items()},
                             param_specs(cfg), opt.init(full))
        err["adafactor"] = {}
        for k, v in state["opt"]["v"].items():
            for part, a in v.items():
                err["adafactor"][f"{part}.{k}"] = _err(a, block(
                    want["stepped"][f"{part}.{k}"], sh["opt"]["v"][k][part]))
        for k, v in state["params"].items():
            g = block(want["grads"][k], specs[k]).abs()
            held = g > _leaf_tol(want, k) * g.max()      # module docstring
            w = block(want["stepped"][f"params.{k}"], specs[k])
            err["adafactor"][f"params.{k}"] = (_err(v[held], w[held])
                                               if held.any() else 0.0)
        err["state"] = state
        cache = init_cache(local, cfg, data["tokens"].shape[0], DECODE_STEPS,
                           dp=dp)
        dec_rows = shard_batch({"d": batch["decode"].T}, mesh, dp)["d"].T
        err["decode"], err["decode_ref"] = [], []
        for t in range(DECODE_STEPS):
            lg, cache = decode_step(local, cfg, cache, dec_rows[t], dp=dp)
            err["decode"].append(_err(lg, block(want["decode"][t],
                                                (dp, "model"))))
            err["decode_ref"].append(_err(lg, block(ref["decode"][t],
                                                    (dp, "model"))))
    return err


def _alone(mesh, dp, case, flat, ref):
    """`moe_ffn` alone on the first block's experts (module docstring):
    {(rows' length, token chunk): errors against the unsharded port and
    the reference, and the route of the FSDP gathers}."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import set_mesh
    from repro_torch.models import sharded as SH

    key = CASES[case][0]
    cfg = _port_cfg(key)
    descr = moe.moe_params(cfg)
    full = {k: torch.tensor(v) for k, v in _moe_block(flat).items()}
    specs = {k: SH.sanitize_spec(d.spec, d.shape, mesh)
             for k, d in descr.items()}
    scatters = []
    reduce_scatter = SH.reduce_scatter

    def spy(*args, **kw):
        scatters.append(1)
        return reduce_scatter(*args, **kw)

    out = {}
    for S, tc in ALONE[case]:
        x, w = _alone_inputs(cfg, S, seed=S)
        rows = shard_batch({"x": x, "w": w}, mesh, dp)
        leaves = {k: v.clone().requires_grad_() for k, v in full.items()}
        xs = torch.tensor(x).requires_grad_()
        y = moe.moe_ffn(leaves, cfg, xs, tc)
        g = torch.autograd.grad((y * torch.tensor(w)).sum(),
                                [xs, *leaves.values()])
        scale = max(float(v.abs().max()) for k, v in zip(leaves, g[1:])
                    if k != "router")
        want = {"y": y.detach(), "x": g[0],
                **{k: SH.local_block(v, mesh, specs[k])
                   for k, v in zip(leaves, g[1:])}}
        want = {k: (shard_batch({"a": v.numpy()}, mesh, dp)["a"]
                    if k in ("y", "x") else v) for k, v in want.items()}
        r = ref["alone"][(S, tc)]
        rwant = {k: (shard_batch({"a": v}, mesh, dp)["a"] if k in ("y", "x")
                     else SH.local_block(torch.tensor(v), mesh, specs[k]))
                 for k, v in r.items()}
        leaves = {k: SH.local_block(v, mesh, specs[k]).clone()
                  .requires_grad_() for k, v in full.items()}
        xs = torch.tensor(rows["x"]).requires_grad_()
        scatters.clear()
        SH.reduce_scatter = spy
        try:
            with set_mesh(mesh):
                y = moe.moe_ffn(leaves, cfg, xs, tc, dp=dp)
                g = torch.autograd.grad((y * torch.tensor(rows["w"])).sum(),
                                        [xs, *leaves.values()])
        finally:
            SH.reduce_scatter = reduce_scatter
        got = {"y": y, "x": g[0], **dict(zip(leaves, g[1:]))}
        out[(S, tc)] = {
            "port": {k: _err(v, want[k]) for k, v in got.items()},
            "ref": {k: _err(v, rwant[k]) for k, v in got.items()},
            "route": "tokens" if scatters else "weights",
            "router_scale": float(got["router"].abs().max()) / scale}
    return out


def _restore(mesh, state, key, ckpt_dir):
    """The sharded Adafactor state saved from `mesh` (2, 2) and restored
    onto (4, 1): whether every block is bitwise the (4, 1) block of the
    whole leaf, and the vr / vc block shapes there."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.specs import state_shardings
    from repro_torch.models import Transformer
    from repro_torch.models import sharded as SH

    cfg = _port_cfg(key)
    opt = TO.adafactor()
    model = Transformer(cfg)
    p_abs, specs = model.abstract(), model.specs()
    opt_abs = opt.init(p_abs)
    sh_a = state_shardings(mesh, p_abs, specs, opt_abs)
    TT.save_checkpoint(ckpt_dir, state, 1, shardings=sh_a, mesh=mesh)
    whole = {k: SH.gather_act(v, mesh, sh_a["params"][k])
             for k, v in state["params"].items()}
    whole_v = {k: {part: SH.gather_act(a, mesh, sh_a["opt"]["v"][k][part])
                   for part, a in v.items()}
               for k, v in state["opt"]["v"].items()}
    new = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    sh_b = state_shardings(new, p_abs, specs, opt_abs)
    like = {"params": {k: torch.zeros_like(SH.local_block(
                v, new, sh_b["params"][k])) for k, v in whole.items()},
            "opt": {"v": {k: {part: torch.zeros_like(SH.local_block(
                a, new, sh_b["opt"]["v"][k][part])) for part, a in v.items()}
                for k, v in whole_v.items()},
                "count": torch.zeros((), dtype=torch.int32)},
            "step": 0}
    got, step = TT.restore_checkpoint(ckpt_dir, like, shardings=sh_b,
                                      mesh=new)
    same = all(torch.equal(got["params"][k], SH.local_block(
        v, new, sh_b["params"][k])) for k, v in whole.items())
    same &= all(torch.equal(got["opt"]["v"][k][part], SH.local_block(
        a, new, sh_b["opt"]["v"][k][part]))
        for k, v in whole_v.items() for part, a in v.items())
    same &= int(got["opt"]["count"]) == int(state["opt"]["count"])
    wi = "blocks.0.moe.wi"
    return {"bitwise": bool(same), "step": step, "state_step": got["step"],
            "vr": tuple(got["opt"]["v"][wi]["vr"].shape),
            "vc": tuple(got["opt"]["v"][wi]["vc"].shape)}


def _rank(rank, world, cases, inputs, ckpt_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import batch_axes

    out, meshes = {}, {}
    for case in cases:
        key, shape = CASES[case]
        if shape not in meshes:
            meshes[shape] = init_device_mesh("cpu", shape,
                                             mesh_dim_names=_names(shape))
        mesh = meshes[shape]
        dp = batch_axes(mesh)
        flat, batch, want, ref = inputs[key]
        out[case] = _check_case(mesh, dp, case, flat, batch, want, ref)
        out[case]["alone"] = _alone(mesh, dp, case, flat, ref)
        state = out[case].pop("state")
        if case == "tp-2x2":
            out["restore"] = _restore(mesh, state, key, ckpt_dir)
    return out


@pytest.fixture(scope="module")
def inputs():
    import jax

    out = {}
    with jax.threefry_partitionable(False):
        for key in CONFIGS:
            batch, flat, ref = _reference(key)
            out[key] = (flat, batch, _unsharded(flat, _port_cfg(key), batch),
                        ref)
    return out


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    out = {}
    for world in (4, 8):
        cases = [c for c, (_, shape) in CASES.items()
                 if int(np.prod(shape)) == world]
        ranks = run_ranks(_rank, world, cases, inputs,
                          str(tmp_path_factory.mktemp("ckpt")),
                          backend="gloo", timeout=TIMEOUT, threads=1)
        for case in cases:
            out[case] = [r[case] for r in ranks]
        if world == 4:
            out["restore"] = [r["restore"] for r in ranks]
    return out


def _router(cfg) -> set:
    """The top-1 routers' names (module docstring), else none."""
    if cfg.experts_per_token != 1:
        return set()
    return {f"blocks.{i}.moe.router" for i in range(cfg.num_layers)}


@pytest.mark.parametrize("key", list(CONFIGS))
def test_every_expert_drops_tokens(inputs, key):
    """In the unsharded forward every expert is picked more often than
    its capacity of 256 in some layer, and the first layer drops tokens
    of every expert."""
    cfg = _port_cfg(key)
    drops = np.array(inputs[key][2]["drops"])
    assert drops.shape == (cfg.num_layers, cfg.num_experts)
    assert drops.any(0).all() and drops[0].all(), drops


@pytest.mark.parametrize("key", list(CONFIGS))
def test_gradient_conditioning(inputs, key):
    """Every leaf's conditioning is at most 2.5e-5 (so no bound exceeds
    1e-4), but the top-1 router's, whose gradient is rounding noise: at
    most 1e-4 of the largest gradient of its block's experts."""
    cfg = _port_cfg(key)
    want = inputs[key][2]
    noise = _router(cfg)
    bad = {k: c for k, c in want["cond"].items()
           if k not in noise and not c <= 2.5e-5}
    assert not bad, bad
    for k in noise:
        pre = k[:-len("router")]
        scale = max(np.abs(want["grads"][pre + n]).max()
                    for n in ("wi", "wg", "wo"))
        assert np.abs(want["grads"][k]).max() <= TOP1_ROUTER * scale, k


@pytest.mark.parametrize("key", list(CONFIGS))
def test_unsharded_port_matches_reference(inputs, key):
    """The unsharded port against the reference on the same parameters
    (the sharded checks below hold both)."""
    _, _, want, ref = inputs[key]
    assert _err(torch.tensor(want["logits"]), ref["logits"]) < REL
    assert abs(want["loss"] - ref["loss"]) / abs(ref["loss"]) < REL
    for k, g in want["grads"].items():
        assert _err(torch.tensor(g), ref["grads"][k]) < _leaf_tol(want, k), k
    for t, lg in enumerate(want["decode"]):
        assert _err(torch.tensor(lg), ref["decode"][t]) < REL, t


@pytest.mark.parametrize("case", list(CASES))
def test_layout_route(case):
    """The expert-parallel configs split E over "model", the
    tensor-parallel ones d_ff, at the case's mesh."""
    from repro_torch.models import sharded as SH

    key, shape = CASES[case]
    cfg = _port_cfg(key)
    sizes = dict(zip(_names(shape), shape))
    wi = moe.moe_params(cfg)["wi"]
    spec = SH.sanitize_spec(wi.spec, wi.shape, sizes)
    assert spec == (("model", "data", None) if key == "ep"
                    else (None, "data", "model")), spec


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_forward(results, case):
    for key in ("forward", "forward_ref"):
        errs = [r[key] for r in results[case]]
        assert max(errs) < REL, (key, errs)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_loss(results, case):
    for key in ("loss", "loss_ref"):
        errs = [r[key] for r in results[case]]
        assert max(errs) < REL, (key, errs)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("against", ("grads", "grads_ref", "grads_remat"))
def test_sharded_gradients_leaf_by_leaf(inputs, results, case, against):
    want = inputs[CASES[case][0]][2]
    for rank, r in enumerate(results[case]):
        bad = {k: e for k, e in r[against].items()
               if not e < _leaf_tol(want, k)}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_saves_the_ranks_block_of_the_hidden_state(results, case):
    """Each block's remat keeps its input as the rank's block (B/dp, S,
    D/m), on the expert- and the tensor-parallel route: "model" 2 or 4
    divides d_model 64."""
    key, shape = CASES[case]
    cfg = _port_cfg(key)
    B, S = CONFIGS[key][2]
    want = (B // math.prod(shape[:-1]), S, cfg.d_model // shape[-1])
    for rank, r in enumerate(results[case]):
        seen = r["remat_inputs"]
        assert [k for k, _, _ in seen] == list(cfg.layer_kinds()), rank
        assert {x for _, x, _ in seen} == {want}, (rank, seen)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_adafactor_step(inputs, results, case):
    """The factored moments (`vr`, `vc`; `v` of the 1-D leaves) at twice
    each leaf's bound, the parameters at the bound where their gradient
    is conditioned (module docstring)."""
    want = inputs[CASES[case][0]][2]
    for rank, r in enumerate(results[case]):
        for key in ("step_loss", "grad_norm"):
            assert r[key] < REL, (rank, key, r[key])
        bad = {}
        for name, e in r["adafactor"].items():
            part, k = name.split(".", 1)
            tol = _leaf_tol(want, k) * (1 if part == "params" else 2)
            if not e < tol:
                bad[name] = (e, tol)
        assert not bad, (rank, bad)
        assert any(n.startswith("vr.") for n in r["adafactor"])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("against", ("decode", "decode_ref"))
def test_sharded_decode(results, case, against):
    errs = [r[against] for r in results[case]]
    assert all(len(e) == DECODE_STEPS for e in errs)
    assert max(max(e) for e in errs) < REL, errs


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("against", ("port", "ref"))
def test_moe_alone_chunks(results, case, against):
    """`moe_ffn` alone at each token chunk (inside a rank's rows, across
    ranks, the default) and on few tokens: output, input gradient and
    every weight block's gradient; the top-1 router's gradient only by
    its size."""
    cfg = _port_cfg(CASES[case][0])
    for rank, r in enumerate(results[case]):
        for S, tc in ALONE[case]:
            got = r["alone"][(S, tc)]
            bad = {k: e for k, e in got[against].items()
                   if not e < REL and not (k == "router" and _router(cfg))}
            assert not bad, (rank, S, tc, bad)
            if _router(cfg):
                assert got["router_scale"] <= TOP1_ROUTER, got


@pytest.mark.parametrize("case", list(CASES))
def test_moe_alone_gathers_the_fewer_bytes(results, case):
    """Where "data" splits the experts' width, the long rows gather the
    weights and the few tokens gather the tokens; on (1, 4) nothing is
    gathered."""
    split = CASES[case][1][-2] > 1
    for r in results[case]:
        routes = {S: r["alone"][(S, tc)]["route"] for S, tc in ALONE[case]}
        assert routes == {S: ("tokens" if split and S == FEW
                              else "weights") for S, _ in ALONE[case]}, routes


def test_elastic_adafactor_restore(results):
    """The Adafactor state saved from (2, 2) restores onto (4, 1)
    bitwise; the (E, D) `vr` of wi splits D over "data" 4 there."""
    for r in results["restore"]:
        assert r["bitwise"] and r["step"] == 1 and r["state_step"] == 1, r
        cfg = _port_cfg("tp")
        assert r["vr"] == (cfg.num_experts, cfg.d_model // 4), r
        assert r["vc"] == (cfg.num_experts, cfg.d_ff), r


@pytest.mark.parametrize("m", (2, 4, 16))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_shards(arch, m):
    """Every registry config passes `check_config` at "model" m, and each
    sanitized spec divides its leaf on a (2, m) mesh."""
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import Transformer, param_specs

    cfg = get_config(arch)
    SH.check_config(cfg, m)
    sizes = {"data": 2, "model": m}
    specs = param_specs(cfg, sizes)
    for name, a in Transformer(cfg).abstract().items():
        spec = specs[name]
        for dim, entry in enumerate(spec):
            axes = SH._axes(entry)
            n = int(np.prod([sizes[x] for x in axes])) if axes else 1
            assert a.shape[dim] % n == 0, (name, spec, a.shape)
