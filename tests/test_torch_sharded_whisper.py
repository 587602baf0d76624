"""Model sharding of the encoder-decoder (whisper-tiny) on gloo CPU
ranks, against the unsharded port and the reference.

One process group of 4 ranks (`dist.ranks.run_ranks`) holds a (2, 2)
and a (1, 4) ("data", "model") mesh.  whisper-tiny reduced (2 encoder
and 2 decoder layers over 24 frames) in f32 with the reference's
parameters (`params_from_reference` then `shard_params`):

* at 4 query and 2 KV heads on (2, 2): "model" divides the heads, so
  each rank's self- and cross-attentions take their own heads;
* at 6 heads of 16 (6 KV heads) on (1, 4): "model" divides neither, so
  every attention, the cross-attentions too, runs on the rank's share
  of the (row, query head) units.

Each runs sharded under `set_mesh` with `dp=` on each rank's rows of
8 x 32 tokens and 8 x 24 frames: `forward`, `loss_fn` and every
gradient leaf (also with remat, its backward outside the mesh's
context; each encoder and decoder block's remat keeps its input as the
rank's block (B/dp, Se or S, D/m), `tests/torch_remat_inputs.py`), one
`make_train_step` AdamW step, and 6 decode steps from a
sharded `init_cache(frames=)`, whose memory is the encoder's output on
the rank's rows and which each step's cross-attention reads.  Then
`decode_attention(memory_kv=)` alone on the first block's
cross-attention over the memory's k and v (the rank's KV heads, or every
KV head where "model" does not divide them).  Each rank holds its blocks
against the matching blocks of the unsharded port's results and of the
reference's (run inside `jax.threefry_partitionable(False)`), at 1e-5
relative to each leaf's largest element; the gradients and AdamW's
moments with the conditioning rule of
`tests/test_torch_sharded_kinds.py` (4 times the largest relative change
of any gradient leaf under a 1e-7 relative perturbation of the
parameters, where that exceeds 1e-5; the second moments twice that;
the stepped parameters where the gradient is conditioned and large
enough that AdamW's first update lr·g/(|g| + eps) does not amplify its
rounding past the bound: |g| > sqrt(eps·max|g|)).
"""
import dataclasses

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

ARCH = "whisper-tiny"
# name: (config changes, mesh shape)
CASES = {
    "h4-2x2": ({}, (2, 2)),
    "h6-1x4": ({"num_heads": 6, "num_kv_heads": 6}, (1, 4)),
}
NAMES = ("data", "model")
B, S = 8, 32
DECODE_STEPS = 6
REL = 1e-5
LR = 1e-4
COND_FACTOR = 4
COND_PERTURBATION = 1e-7
B1, EPS = 0.9, 1e-8                         # TO.adamw()'s defaults
TIMEOUT = 240
WORLD = 4


def _port_cfg(name):
    return dataclasses.replace(reduce_config(get_config(ARCH)),
                               dtype="float32", **CASES[name][0])


def _lr():
    return TO.cosine_schedule(LR, 0, 10)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1                      # masked labels count too
    return {"tokens": tok[:, :-1], "labels": labels,
            "frames": rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32),
            "decode": rng.integers(0, cfg.vocab_size,
                                   (DECODE_STEPS, B)).astype(np.int32)}


def _train_data(batch):
    return {k: batch[k] for k in ("tokens", "labels", "frames")}


def _err(got, want) -> float:
    want = torch.as_tensor(want)
    scale = float(want.abs().max())
    return float((got.detach() - want).abs().max()) / max(scale, 1e-30)


def _unsharded(flat, cfg, batch):
    """The unsharded port's results on the full batch."""
    full = {k: torch.tensor(v) for k, v in flat.items()}
    data = _train_data(batch)
    out = {"logits": forward(full, cfg, data).numpy()}

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
    out["cond"] = max(_err(moved[k], v) for k, v in g.items())
    opt = TO.adamw()
    state = TT.init_train_state({k: v.clone() for k, v in full.items()}, opt)
    state, m = TT.make_train_step(cfg, opt, _lr(), device="cpu")(state, data)
    out["stepped"] = {part: {k: v.numpy() for k, v in tree.items()}
                      for part, tree in (("params", state["params"]),
                                         ("m", state["opt"]["m"]),
                                         ("v", state["opt"]["v"]))}
    out["step_loss"] = float(m["loss"])
    out["grad_norm"] = float(m["grad_norm"])
    cache = init_cache(full, cfg, B, DECODE_STEPS, frames=batch["frames"])
    out["memory"] = cache["memory"].numpy()
    dec = []
    for t in range(DECODE_STEPS):
        lg, cache = decode_step(full, cfg, cache, batch["decode"][t])
        dec.append(lg.numpy())
    out["decode"] = np.stack(dec)
    return out


def _reference(name):
    """The reference's parameters (as the port's flat numpy dict), logits,
    loss, gradients and decode logits.  jax is imported here, not at the
    top: the ranks import this module and need only the port."""
    import jax

    import repro.configs as RC
    import repro.models as RM

    rcfg = dataclasses.replace(RC.reduce_config(RC.get_config(ARCH)),
                               dtype="float32", **CASES[name][0])
    cfg = _port_cfg(name)
    batch = _batch(cfg, seed=len(name))
    params = RM.Transformer(rcfg, model_axis=1).init(jax.random.PRNGKey(0))
    data = _train_data(batch)

    def run(p, data, toks):
        def step(cache, t):
            lg, cache = RM.decode_step(p, rcfg, cache, t)
            return cache, lg

        cache = RM.init_cache(p, rcfg, batch=B, max_len=DECODE_STEPS,
                              frames=data["frames"])
        return (RM.forward(p, rcfg, {"tokens": data["tokens"],
                                     "frames": data["frames"]}),
                jax.value_and_grad(RM.loss_fn)(p, rcfg, data),
                jax.lax.scan(step, cache, toks)[1])

    logits, (loss, grads), dec = jax.jit(run)(params, data, batch["decode"])

    def flat(tree):
        return {k: v.numpy() for k, v in param_dict(params_from_reference(
            jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}

    return batch, flat(params), {
        "logits": np.asarray(logits), "loss": float(loss),
        "grads": flat(grads), "decode": np.asarray(dec)}


def _check_case(mesh, dp, name, flat, batch, want, ref):
    """One config's sharded runs in this rank: errors of its blocks."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import set_mesh
    from repro_torch.launch.specs import _cache_shardings
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import param_specs

    cfg = _port_cfg(name)
    specs = param_specs(cfg, mesh)
    full = {k: torch.tensor(v) for k, v in flat.items()}
    local = SH.shard_params(full, mesh, specs)
    data = shard_batch(_train_data(batch), mesh, dp)
    block = lambda a, spec: SH.local_block(torch.as_tensor(a), mesh, spec)
    lspec = (dp, None, "model")
    err = {}
    with set_mesh(mesh):
        logits = forward(local, cfg, data, dp=dp)
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
            for part, tree in (("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"]))
            for k, v in tree.items()}
        tol = max(REL, COND_FACTOR * want["cond"])
        for k, v in state["params"].items():
            # g = m / (1 - b1); the update lr g / (|g| + eps) moves by
            # lr eps dg / (|g| + eps)^2 for an error dg of g, which stays
            # below tol lr where |g| > sqrt(eps max|g|) (module docstring)
            g = block(want["stepped"]["m"][k], specs[k]).abs() / (1 - B1)
            held = (g > tol * g.max()) & (g > (EPS * g.max()) ** 0.5)
            w = block(want["stepped"]["params"][k], specs[k])
            err["adamw"][f"params.{k}"] = _err(v[held], w[held])
        cache = init_cache(local, cfg, data["tokens"].shape[0], DECODE_STEPS,
                           frames=data["frames"], dp=dp)
        abstract = {"layers": [], "memory": torch.empty(
            want["memory"].shape, device="meta")}
        mem_spec = _cache_shardings(cfg, abstract, mesh, dp)["memory"]
        err["memory"] = _err(cache["memory"], block(want["memory"], mem_spec))
        err["memory_block"] = (tuple(cache["memory"].shape), tuple(
            SH.local_block(abstract["memory"], mesh, mem_spec).shape))
        dec_rows = shard_batch({"d": batch["decode"].T}, mesh, dp)["d"].T
        err["decode"], err["decode_ref"] = [], []
        for t in range(DECODE_STEPS):
            lg, cache = decode_step(local, cfg, cache, dec_rows[t], dp=dp)
            err["decode"].append(_err(lg, block(want["decode"][t],
                                                (dp, "model"))))
            err["decode_ref"].append(_err(lg, block(ref["decode"][t],
                                                    (dp, "model"))))
    err["memory_kv"] = _memory_kv(mesh, dp, cfg, full, local, want["memory"])
    return err


def _memory_kv(mesh, dp, cfg, full, local, memory):
    """`decode_attention(memory_kv=)` of the first decoder block's
    cross-attention for one token a row over the whole memory, sharded
    against the unsharded call."""
    from repro_torch.launch import set_mesh
    from repro_torch.models import sharded as SH
    from repro_torch.models.attention import _heads, decode_attention

    pre = "blocks.0.xattn."
    p = {k[len(pre):]: v for k, v in full.items() if k.startswith(pre)}
    lp = {k[len(pre):]: v for k, v in local.items() if k.startswith(pre)}
    H, dh = cfg.kv_heads, cfg.head_width
    mem = torch.tensor(memory)
    k, v = (_heads(mem @ p[n], H, dh) for n in ("wk", "wv"))
    k_pos = torch.arange(mem.shape[1])[None].expand(mem.shape[:2])
    x = torch.tensor(np.random.default_rng(3).normal(
        size=(mem.shape[0], 1, cfg.d_model)).astype(np.float32))
    want, _ = decode_attention(p, cfg, x, {}, 0, memory_kv=(k, v, k_pos))
    rows = lambda a: SH.local_block(a, mesh, (dp,))
    lk, lv = rows(k), rows(v)
    if cfg.kv_heads % mesh.size(mesh.mesh_dim_names.index("model")) == 0:
        lk, lv = (SH.local_block(a, mesh, (None, "model")) for a in (lk, lv))
    with set_mesh(mesh):
        got, cache = decode_attention(lp, cfg, rows(x), {}, 0, dp=dp,
                                      memory_kv=(lk, lv, rows(k_pos)))
    return {"err": _err(got, rows(want)), "heads": lk.shape[1]}


def _rank(rank, world, inputs):
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    for name, (_, shape) in CASES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
        out[name] = _check_case(mesh, ("data",), name, *inputs[name])
    return out


@pytest.fixture(scope="module")
def inputs():
    import jax

    out = {}
    with jax.threefry_partitionable(False):
        for name in CASES:
            batch, flat, ref = _reference(name)
            out[name] = (flat, batch, _unsharded(flat, _port_cfg(name),
                                                 batch), ref)
    return out


@pytest.fixture(scope="module")
def results(inputs):
    return run_ranks(_rank, WORLD, inputs, backend="gloo", timeout=TIMEOUT,
                     threads=1)


def _all(results, name, key):
    return [r[name][key] for r in results]


def _grad_tol(inputs, name) -> float:
    return max(REL, COND_FACTOR * inputs[name][2]["cond"])


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_conditioning(inputs, name):
    assert inputs[name][2]["cond"] <= 2.5e-5, inputs[name][2]["cond"]


@pytest.mark.parametrize("name", list(CASES))
def test_unsharded_port_matches_reference(inputs, name):
    _, _, want, ref = inputs[name]
    assert _err(torch.tensor(want["logits"]), ref["logits"]) < REL
    assert abs(want["loss"] - ref["loss"]) / abs(ref["loss"]) < REL
    tol = _grad_tol(inputs, name)
    for k, g in want["grads"].items():
        assert _err(torch.tensor(g), ref["grads"][k]) < tol, k
    for t, lg in enumerate(want["decode"]):
        assert _err(torch.tensor(lg), ref["decode"][t]) < REL, t


@pytest.mark.parametrize("name", list(CASES))
def test_heads_split_as_named(name):
    """4 heads of 2 KV heads divide over "model" 2; 6 divide over neither
    a "model" of 4 nor 16, and their widths split, so both shard."""
    from repro_torch.models import sharded

    cfg = _port_cfg(name)
    m = CASES[name][1][1]
    sharded.check_config(cfg, m)
    assert (cfg.kv_heads % m == 0) == (name == "h4-2x2")
    if name == "h6-1x4":
        sharded.check_config(cfg, 16)
        assert cfg.num_heads % 16 and cfg.kv_heads % 16


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward(results, name):
    for key in ("forward", "forward_ref"):
        errs = _all(results, name, key)
        assert max(errs) < REL, (key, errs)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loss(results, name):
    for key in ("loss", "loss_ref"):
        errs = _all(results, name, key)
        assert max(errs) < REL, (key, errs)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ("grads", "grads_ref", "grads_remat"))
def test_sharded_gradients_leaf_by_leaf(inputs, results, name, against):
    tol = _grad_tol(inputs, name)
    for rank, errs in enumerate(_all(results, name, against)):
        bad = {k: e for k, e in errs.items() if not e < tol}
        assert not bad, (rank, tol, bad)
        assert any(k.startswith("encoder.") for k in errs)
        assert any(".xattn." in k for k in errs)


@pytest.mark.parametrize("name", list(CASES))
def test_remat_saves_the_ranks_block_of_the_hidden_state(results, name):
    """Each encoder and decoder block's remat keeps its input as the
    rank's block (B/dp, Se or S, D/m): "model" divides d_model 64."""
    cfg = _port_cfg(name)
    dp, m = CASES[name][1]
    D = cfg.d_model // m
    want = ([("attn", (B // dp, cfg.encoder_seq, D), False)]
            * cfg.encoder_layers
            + [("attn", (B // dp, S, D), True)] * cfg.num_layers)
    for rank, seen in enumerate(_all(results, name, "remat_inputs")):
        assert seen == want, (rank, seen)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_adamw_step(inputs, results, name):
    for key in ("step_loss", "grad_norm"):
        errs = _all(results, name, key)
        assert max(errs) < REL, (key, errs)
    tol = _grad_tol(inputs, name)
    for rank, errs in enumerate(_all(results, name, "adamw")):
        bad = {k: e for k, e in errs.items()
               if not e < (2 * tol if k.startswith("v.") else tol)}
        assert not bad, (rank, tol, bad)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_memory(results, name):
    """The cache's memory is the encoder's output on the rank's rows, of
    the block shape `_cache_shardings` gives it."""
    for r in results:
        got = r[name]
        assert got["memory"] < REL, got["memory"]
        shape, want = got["memory_block"]
        assert shape == want, (shape, want)
        assert shape[0] == B // CASES[name][1][0]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ("decode", "decode_ref"))
def test_sharded_decode(results, name, against):
    errs = _all(results, name, against)
    assert all(len(e) == DECODE_STEPS for e in errs)
    assert max(max(e) for e in errs) < REL, errs


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_over_memory_kv(results, name):
    """`decode_attention(memory_kv=)` sharded: the rank's KV heads where
    "model" divides them, else every KV head on its units."""
    cfg = _port_cfg(name)
    m = CASES[name][1][1]
    for r in results:
        got = r[name]["memory_kv"]
        assert got["err"] < REL, got
        want = cfg.kv_heads // m if cfg.kv_heads % m == 0 else cfg.kv_heads
        assert got["heads"] == want, got
