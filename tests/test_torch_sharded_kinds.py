"""Model sharding where "model" does not divide the heads, and for the
rwkv and RG-LRU blocks, on gloo CPU ranks, against the unsharded port
and the reference.

One process group of 4 ranks (`dist.ranks.run_ranks`) holds a (1, 4)
and a (2, 2) ("data", "model") mesh.  Reduced configs in f32 with the
reference's parameters (`params_from_reference` then `shard_params`):

* llama3.2-3b with 6 query and 2 KV heads on (1, 4): neither divides;
* llama3.2-3b with 1 KV head on (2, 2): the query heads divide, the KV
  head does not; decoded 9 steps, a cache length "model" does not
  divide, so every rank keeps the whole cache;
* recurrentgemma-9b (rglru, rglru, local; 1 KV head, window 16) on
  (2, 2), decoded 40 steps so the sequence-sharded ring of the local
  layer (16 positions, 8 a rank) wraps;
* rwkv6-3b at 4 heads of 16 (2 a rank) and at d_model 48, 3 heads of
  16, which "model" 2 does not divide, on (2, 2);
* llama3.2-3b at d_model 54 on (1, 4): "model" divides neither d_model
  nor the KV heads, so the hidden state between blocks stays whole.

Under every other case the hidden state between residual updates is the
rank's block (B/dp, S, D/m): the input each block's remat keeps has
that shape (`tests/torch_remat_inputs.py`), (B/dp, S, D) in the last.

Each runs sharded under `set_mesh` with `dp=` on each rank's rows of
8 x 32 tokens: `forward`, `loss_fn` and every gradient leaf (also with
remat, its backward outside the mesh's context), one `make_train_step`
AdamW step, and the decode steps from a sharded `init_cache`, whose
leaves have the block shapes of `launch.specs._cache_shardings`.  Each
rank holds its blocks against the matching blocks of the unsharded
port's results and of the reference's, at 1e-5 relative to each
leaf's largest element.  The gradients and the AdamW moments are held
to the larger of 1e-5 and 4 times the config's conditioning: the
largest relative change of any gradient leaf of the unsharded port
under a 1e-7 relative perturbation of its parameters (about one f32
rounding).  That is about 1e-6 for llama and recurrentgemma, so their
bound is 1e-5, and about 1e-5 for the reduced rwkv6-3b, whose unsharded
port and reference differ by 1.7e-5 on the same parameters (the
reference's own rwkv gradients move by 3e-5 under such a perturbation,
`test_torch_train.py`); a gradient summed over a wrong dim is off by
half the leaf or more and fails either bound.  The second moments are
squares, held to twice that.  AdamW's first update lr·g/(|g| + eps)
moves a parameter whose gradient lies within rounding of zero by a
rounding-dependent share of lr, in any f32 computation; so the stepped
parameters are held where the unsharded step's first moment exceeds
the bound times its leaf's largest, and the moments everywhere.  Spies
on the flash op and the wkv op count the
units each rank's calls cover: never more than its share of the
B_local·H (row, head) units.  The non-dividing query heads also run
`attention()` alone on one row at `chunk_threshold=0` (6 units over 4
ranks: 1, 2, 1, 2), on the flash route.
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

# name: (arch, config changes, mesh shape, decode steps)
CASES = {
    "llama-h6-kv2": ("llama3.2-3b", {"num_heads": 6, "num_kv_heads": 2},
                     (1, 4), 8),
    "llama-kv1": ("llama3.2-3b", {"num_kv_heads": 1}, (2, 2), 9),
    "recurrentgemma": ("recurrentgemma-9b", {}, (2, 2), 40),
    "rwkv-h4": ("rwkv6-3b", {}, (2, 2), 8),
    "rwkv-h3": ("rwkv6-3b", {"d_model": 48}, (2, 2), 8),
    # "model" 4 does not divide d_model 54: the hidden state between
    # blocks stays replicated
    "llama-d54": ("llama3.2-3b", {"d_model": 54}, (1, 4), 8),
}
NAMES = ("data", "model")
B, S = 8, 32
REL = 1e-5
LR = 1e-4
COND_FACTOR = 4
COND_PERTURBATION = 1e-7
TIMEOUT = 240
WORLD = 4


def _port_cfg(name):
    arch, changes, _, _ = CASES[name]
    return dataclasses.replace(reduce_config(get_config(arch)),
                               dtype="float32", **changes)


def _lr():
    return TO.cosine_schedule(LR, 0, 10)



def _batch(cfg, seed, steps):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1                      # masked labels count too
    return {"tokens": tok[:, :-1], "labels": labels,
            "decode": rng.integers(0, cfg.vocab_size,
                                   (steps, B)).astype(np.int32)}


def _unsharded(flat, cfg, batch, steps):
    """The unsharded port's results on the full batch."""
    full = {k: torch.tensor(v) for k, v in flat.items()}
    data = {k: batch[k] for k in ("tokens", "labels")}
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
    cache = init_cache(full, cfg, B, steps)
    out["cache_shapes"] = [{k: tuple(a.shape) for k, a in layer.items()}
                           for layer in cache["layers"]]
    dec = []
    for t in range(steps):
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

    arch, changes, _, steps = CASES[name]
    rcfg = dataclasses.replace(RC.reduce_config(RC.get_config(arch)),
                               dtype="float32", **changes)
    cfg = _port_cfg(name)
    batch = _batch(cfg, seed=len(name), steps=steps)
    params = RM.Transformer(rcfg, model_axis=1).init(jax.random.PRNGKey(0))
    data = {k: batch[k] for k in ("tokens", "labels")}

    def run(p, data, toks):
        """Logits, loss, gradients and the decode steps' logits (a scan
        over the steps from an empty cache), in one compiled program."""
        def step(cache, t):
            lg, cache = RM.decode_step(p, rcfg, cache, t)
            return cache, lg

        cache = RM.init_cache(p, rcfg, batch=B, max_len=steps)
        return (RM.forward(p, rcfg, {"tokens": data["tokens"]}),
                jax.value_and_grad(RM.loss_fn)(p, rcfg, data),
                jax.lax.scan(step, cache, toks)[1])

    logits, (loss, grads), dec = jax.jit(run)(params, data, batch["decode"])

    def flat(tree):
        return {k: v.numpy() for k, v in param_dict(params_from_reference(
            jax.tree.map(np.asarray, tree), cfg, device="cpu")).items()}

    return batch, flat(params), {
        "logits": np.asarray(logits), "loss": float(loss),
        "grads": flat(grads), "decode": np.asarray(dec)}


def _err(got, want) -> float:
    want = torch.as_tensor(want)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


class _Spy:
    """Records the first dim (the units) of each flash or wkv call."""

    def __init__(self):
        import repro_torch.models.attention as A
        import repro_torch.models.rwkv as R

        self.calls = {"flash": [], "wkv": []}
        self._patch(A, "flash_attention", "flash")
        self._patch(R, "rwkv6_wkv", "wkv")

    def _patch(self, module, attr, key):
        fn = getattr(module, attr)

        def spy(*args, **kw):
            self.calls[key].append(int(args[0].shape[0]))
            return fn(*args, **kw)
        setattr(module, attr, spy)

    def take(self):
        out = {k: list(v) for k, v in self.calls.items()}
        for v in self.calls.values():
            v.clear()
        return out


def _check_case(mesh, dp, name, flat, batch, want, ref, spy):
    """One config's sharded runs in this rank: errors of its blocks."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import set_mesh
    from repro_torch.launch.specs import _cache_shardings
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import param_specs

    cfg = _port_cfg(name)
    steps = CASES[name][3]
    specs = param_specs(cfg, mesh)
    full = {k: torch.tensor(v) for k, v in flat.items()}
    local = SH.shard_params(full, mesh, specs)
    data = shard_batch({k: batch[k] for k in ("tokens", "labels")}, mesh,
                       dp)
    block = lambda a, spec: SH.local_block(torch.as_tensor(a), mesh, spec)
    lspec = (dp, None, "model")
    err = {}
    spy.take()
    with set_mesh(mesh):
        logits = forward(local, cfg, {"tokens": data["tokens"]}, dp=dp)
        err["units"] = spy.take()
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
            m = block(want["stepped"]["m"][k], specs[k]).abs()
            held = m > tol * m.max()        # module docstring
            w = block(want["stepped"]["params"][k], specs[k])
            err["adamw"][f"params.{k}"] = _err(v[held], w[held])
        cache = init_cache(local, cfg, data["tokens"].shape[0], steps, dp=dp)
        abstract = {"layers": [{k: torch.empty(s, device="meta")
                                for k, s in layer.items()}
                               for layer in want["cache_shapes"]],
                    "memory": None}
        cache_sh = _cache_shardings(cfg, abstract, mesh, dp)
        err["cache_blocks"] = [
            {k: (tuple(a.shape), tuple(SH.local_block(
                abstract["layers"][i][k], mesh, cache_sh["layers"][i][k])
                .shape)) for k, a in layer.items()}
            for i, layer in enumerate(cache["layers"])]
        dec_rows = shard_batch({"d": batch["decode"].T}, mesh, dp)["d"].T
        err["decode"], err["decode_ref"] = [], []
        for t in range(steps):
            lg, cache = decode_step(local, cfg, cache, dec_rows[t], dp=dp)
            err["decode"].append(_err(lg, block(want["decode"][t],
                                                (dp, "model"))))
            err["decode_ref"].append(_err(lg, block(ref["decode"][t],
                                                    (dp, "model"))))
        err["later_units"] = spy.take()  # training and decode
    return err


def _attention_alone(mesh, dp, flat, spy):
    """`attention()` of llama-h6-kv2's first block on one row at
    chunk_threshold=0 (the flash route) against the unsharded call: the
    units each rank attends over, and the error of its output."""
    from repro_torch.launch import set_mesh
    from repro_torch.models import sharded as SH
    from repro_torch.models.attention import attention
    from repro_torch.models.model import param_specs

    cfg = _port_cfg("llama-h6-kv2")
    full = {k: torch.tensor(v) for k, v in flat.items()}
    local = SH.shard_params(full, mesh, param_specs(cfg, mesh))
    pre = "blocks.0.attn."
    x = torch.tensor(np.random.default_rng(5).normal(
        size=(1, S, cfg.d_model)).astype(np.float32))
    want = attention({k[len(pre):]: v for k, v in full.items()
                      if k.startswith(pre)}, cfg, x, chunk_threshold=0)
    spy.take()
    with set_mesh(mesh):
        got = attention({k[len(pre):]: v for k, v in local.items()
                         if k.startswith(pre)}, cfg, x, chunk_threshold=0,
                        dp=dp)
    return {"err": _err(got, want), "units": spy.take()["flash"]}


def _attention_few_units(mesh, dp, spy):
    """2 query heads over 1 KV head on one row: 2 units over 4 ranks, so
    ranks 0 and 2 attend over none.  The output on the flash route, and
    in training the output and the gradients of x and of each weight
    block, against the unsharded call; every rank takes part in the
    gathers' backward, units or not."""
    from repro_torch.launch import set_mesh
    from repro_torch.models import sharded as SH
    from repro_torch.models.attention import attention, attn_params

    cfg = dataclasses.replace(_port_cfg("llama-kv1"), num_heads=2,
                              num_kv_heads=1)
    rng = np.random.default_rng(9)
    descr = attn_params(cfg)
    full = {k: torch.tensor(rng.normal(size=d.shape).astype(np.float32)
                            * d.std()) for k, d in descr.items()}
    x = torch.tensor(rng.normal(size=(1, S, cfg.d_model)).astype(np.float32))
    seed = torch.tensor(rng.normal(size=(1, S, cfg.d_model)).astype(
        np.float32))
    specs = {k: SH.sanitize_spec(d.spec, d.shape, mesh)
             for k, d in descr.items()}
    local = {k: SH.local_block(v, mesh, specs[k]).clone()
             for k, v in full.items()}
    out = {}
    spy.take()
    with set_mesh(mesh):
        got = attention(local, cfg, x, chunk_threshold=0, dp=dp)
    out["units"] = spy.take()["flash"]
    out["err"] = _err(got, attention(full, cfg, x, chunk_threshold=0))

    def grads(params, xs, **kw):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xs = xs.clone().requires_grad_()
        y = attention(leaves, cfg, xs, train=True, **kw)
        g = torch.autograd.grad((y * seed).sum(), [xs, *leaves.values()])
        return y.detach(), g[0], dict(zip(leaves, g[1:]))

    want = grads(full, x)
    with set_mesh(mesh):
        got = grads(local, x, dp=dp)
    out["train"] = {"out": _err(got[0], want[0]), "x": _err(got[1], want[1]),
                    **{k: _err(g, SH.local_block(want[2][k], mesh, specs[k]))
                       for k, g in got[2].items()}}
    return out


def _rank(rank, world, inputs):
    from torch.distributed.device_mesh import init_device_mesh

    spy = _Spy()
    meshes = {}
    out = {}
    for name, (_, _, shape, _) in CASES.items():
        if shape not in meshes:
            meshes[shape] = init_device_mesh("cpu", shape,
                                             mesh_dim_names=NAMES)
        out[name] = _check_case(meshes[shape], ("data",), name,
                                *inputs[name], spy)
    out["attention_alone"] = _attention_alone(
        meshes[(1, 4)], ("data",), inputs["llama-h6-kv2"][0], spy)
    out["few_units"] = _attention_few_units(meshes[(1, 4)], ("data",), spy)
    return out


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for name, (_, _, _, steps) in CASES.items():
        batch, flat, ref = _reference(name)
        out[name] = (flat, batch, _unsharded(flat, _port_cfg(name), batch,
                                             steps), ref)
    return out


@pytest.fixture(scope="module")
def results(inputs):
    return run_ranks(_rank, WORLD, inputs, backend="gloo", timeout=TIMEOUT,
                     threads=1)


def _all(results, name, key):
    return [r[name][key] for r in results]


def _grad_tol(inputs, name) -> float:
    """The gradients' bound (module docstring)."""
    return max(REL, COND_FACTOR * inputs[name][2]["cond"])


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_conditioning(inputs, name):
    """The conditioning that widens the gradients' bound stays small: at
    most 2.5e-5, so no bound exceeds 1e-4."""
    assert inputs[name][2]["cond"] <= 2.5e-5, inputs[name][2]["cond"]


@pytest.mark.parametrize("name", list(CASES))
def test_unsharded_port_matches_reference(inputs, name):
    """The unsharded port against the reference on the same parameters
    (the sharded checks below hold both)."""
    _, _, want, ref = inputs[name]
    assert _err(torch.tensor(want["logits"]), ref["logits"]) < REL
    assert abs(want["loss"] - ref["loss"]) / abs(ref["loss"]) < REL
    tol = _grad_tol(inputs, name)
    for k, g in want["grads"].items():
        assert _err(torch.tensor(g), ref["grads"][k]) < tol, k
    for t, lg in enumerate(want["decode"]):
        assert _err(torch.tensor(lg), ref["decode"][t]) < REL, t


@pytest.mark.parametrize("name", list(CASES))
def test_layout_accepts_config(inputs, name):
    """`sharded.layout` takes the config on its mesh, whose "model" size
    divides neither the heads (llama, rwkv-h3) nor the KV heads."""
    from repro_torch.models import sharded

    cfg = _port_cfg(name)
    m = CASES[name][2][1]
    sharded.check_config(cfg, m)
    heads = cfg.rwkv_heads if cfg.block_unit == ("rwkv",) else cfg.kv_heads
    assert name == "rwkv-h4" or heads % m, (name, heads, m)


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


@pytest.mark.parametrize("name", list(CASES))
def test_remat_saves_the_ranks_block_of_the_hidden_state(results, name):
    """Each block's remat keeps its input as the rank's block (B/dp, S,
    D/m) where "model" divides d_model, else (B/dp, S, D) whole."""
    cfg = _port_cfg(name)
    dp, m = CASES[name][2]
    D = cfg.d_model // m if cfg.d_model % m == 0 else cfg.d_model
    assert (name == "llama-d54") == (D == cfg.d_model)
    for rank, seen in enumerate(_all(results, name, "remat_inputs")):
        assert [k for k, _, _ in seen] == list(cfg.layer_kinds()), rank
        assert {x for _, x, _ in seen} == {(B // dp, S, D)}, (rank, seen)


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
@pytest.mark.parametrize("against", ("decode", "decode_ref"))
def test_sharded_decode(results, name, against):
    steps = CASES[name][3]
    errs = _all(results, name, against)
    assert all(len(e) == steps for e in errs)
    assert max(max(e) for e in errs) < REL, errs


@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_follow_cache_shardings(results, name):
    """Every cache leaf of every rank has its block shape under
    `_cache_shardings`; the KV caches that "model" cannot split by head
    are split by position where it divides their length, else whole."""
    cfg = _port_cfg(name)
    m = CASES[name][2][1]
    for r in results:
        for layer, kind in zip(r[name]["cache_blocks"], cfg.layer_kinds()):
            for leaf, (got, want) in layer.items():
                assert got == want, (leaf, got, want)
            if kind in ("attn", "local"):
                full_len = layer["pos"][0][1]
                assert layer["k"][0][1] == cfg.kv_heads
                split = m if full_len % m == 0 else 1
                assert layer["k"][0][2] * split == full_len


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_ops_take_only_the_ranks_units(results, name):
    """The flash op (recurrentgemma's local layer past its window) and
    the wkv op receive only this rank's share of the units: B_local·H/m
    (row, head) pairs, rounded up at most; training and decode call
    neither."""
    cfg = _port_cfg(name)
    dp, m = CASES[name][2]
    rows = B // dp
    for r in results:
        calls = r[name]["units"]
        assert r[name]["later_units"] == {"flash": [], "wkv": []}
        kinds = cfg.layer_kinds()
        if "rwkv" in kinds:
            share = -(-rows * cfg.rwkv_heads // m)
            assert calls["wkv"] == [share] * len(kinds), calls
            assert calls["flash"] == []
        elif "local" in kinds:
            share = -(-rows * cfg.num_heads // m)
            assert calls["flash"] == [share] * kinds.count("local"), calls
            assert calls["wkv"] == []
        else:                       # under the threshold: no flash call
            assert calls == {"flash": [], "wkv": []}, calls


def test_ranks_without_units(results):
    """2 units over 4 ranks: ranks 0 and 2 call no flash op, and the
    output and every gradient, in training too, are the unsharded
    call's."""
    got = [r["few_units"] for r in results]
    assert [g["units"] for g in got] == [[], [1], [], [1]]
    for rank, g in enumerate(got):
        assert g["err"] < REL, (rank, g)
        bad = {k: e for k, e in g["train"].items() if not e < REL}
        assert not bad, (rank, bad)


def test_uneven_units_on_the_flash_route(results):
    """6 (row, query head) units of one row over 4 ranks: 1, 2, 1, 2 in
    rank order, none above ceil(6 / 4), and the output the unsharded
    attention's."""
    got = [r["attention_alone"] for r in results]
    assert [g["units"] for g in got] == [[1], [2], [1], [2]]
    assert max(g["err"] for g in got) < REL, got
