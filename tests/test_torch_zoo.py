"""The port's serving and training paths for the zoo's block kinds beyond
rwkv and dense attention, against the reference package on the CPU:
recurrentgemma-9b (RG-LRU and sliding-window "local" blocks, MQA),
gemma2-27b (local and global blocks, softcaps, post-norms), grok-1-314b
(MoE top-2 of 8, softcap) and llama4-maverick (MoE top-1; 4 experts at
this size).  At `reduce_config` size (2 or 3 layers, d 64, window 16,
vocab 512) on the reference's initialised parameters
(`params_from_reference`).  The forward over 40 tokens takes the local
layers past their window: the reference runs `banded_local_attention`
there and the port the flash op with the window (its plain version on
CPU tensors).

Tolerances as `tests/test_torch_models.py` sets them out: f32 at 1e-5
(rtol and atol); bf16 held to the reference's own bf16-vs-f32 error
(the mean and the largest element at most 1.5x, each row at most
2.5x).  Paged and dense decode in the port are bitwise equal where the
dense cache's length, P * page_size, is no longer than the window.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro.serve import Generator as RefGenerator  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Transformer,
    cache_from_reference,
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    loss_fn,
    paged_decode_step,
    params_from_reference,
    state_from_reference,
)
from repro_torch.serve import Generator  # noqa: E402

F32_TOL = 1e-5
BF16_MEAN_RATIO = 1.5
BF16_MAX_RATIO = 1.5
BF16_ROW_RATIO = 2.5

ZOO = ("recurrentgemma-9b", "gemma2-27b", "grok-1-314b",
       "llama4-maverick-400b-a17b")
LOCAL = ("recurrentgemma-9b", "gemma2-27b")


@pytest.fixture(autouse=True)
def _older_threefry():
    with jax.threefry_partitionable(False):
        yield


def _cfgs(arch, dtype="float32"):
    ref = dataclasses.replace(
        ref_configs.reduce_config(ref_configs.get_config(arch)), dtype=dtype)
    port = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    return ref, port


def _params(ref_cfg, port_cfg, seed):
    ref = ref_models.Transformer(ref_cfg, model_axis=1).init(
        jax.random.PRNGKey(seed))
    port = params_from_reference(jax.tree.map(np.asarray, ref), port_cfg,
                                 device="cpu")
    return ref, port


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _f32_twin(ref_cfg, ref_params):
    return (dataclasses.replace(ref_cfg, dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), ref_params))


def _assert_bf16_close(port, ref16, ref32):
    port, ref16, ref32 = (np.asarray(a, np.float32) for a in (port, ref16, ref32))
    port_err, ref_err = np.abs(port - ref32), np.abs(ref16 - ref32)
    assert port_err.mean() <= BF16_MEAN_RATIO * ref_err.mean(), (
        port_err.mean(), ref_err.mean())
    assert port_err.max() <= BF16_MAX_RATIO * ref_err.max(), (
        port_err.max(), ref_err.max())
    rows = port.shape[0] * port.shape[1]
    port_rows = port_err.reshape(rows, -1).mean(1)
    ref_rows = ref_err.reshape(rows, -1).mean(1)
    worst = int(np.argmax(port_rows / ref_rows))
    assert (port_rows <= BF16_ROW_RATIO * ref_rows).all(), (
        worst, port_rows[worst], ref_rows[worst])


def _ref_step(ref_cfg):
    """The reference's decode_step, jitted (eager it runs op by op)."""
    return jax.jit(lambda p, c, t: ref_models.decode_step(p, ref_cfg, c, t))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=F32_TOL,
                               atol=F32_TOL)


# ------------------------------ forward -------------------------------


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("S", [16, 40], ids=["in-window", "past-window"])
def test_forward_matches_reference_f32(arch, S):
    ref_cfg, cfg = _cfgs(arch)
    ref_p, port_p = _params(ref_cfg, cfg, seed=0)
    toks = _tokens(cfg, 2, S, seed=1)
    want = ref_models.forward(ref_p, ref_cfg, {"tokens": jnp.asarray(toks)})
    before = flash_attention.launches
    got = forward(port_p, cfg, {"tokens": toks})
    assert flash_attention.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab_size)
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", ZOO)
def test_forward_matches_reference_bf16(arch):
    """40 tokens: the local layers past their window too."""
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    ref_p, port_p = _params(ref_cfg, cfg, seed=3)
    batch = {"tokens": jnp.asarray(_tokens(cfg, 2, 40, seed=4))}
    want16 = ref_models.forward(ref_p, ref_cfg, batch)
    want32 = ref_models.forward(*reversed(_f32_twin(ref_cfg, ref_p)), batch)
    _assert_bf16_close(port_p({"tokens": np.asarray(batch["tokens"])}),
                       want16, want32)


# ------------------------------ decode --------------------------------


def _cache_close(got, want, check):
    assert got["step"] == want["step"]
    for layer_got, layer_want in zip(got["layers"], want["layers"]):
        assert layer_got.keys() == layer_want.keys()
        for k in layer_got:
            assert layer_got[k].dtype == layer_want[k].dtype, k
            assert layer_got[k].shape == layer_want[k].shape, k
            check(layer_got[k].float().numpy(), layer_want[k].float().numpy())


@pytest.mark.parametrize("arch", ZOO)
def test_decode_step_and_cache_match_reference_f32(arch):
    """24 steps into a cache of 32: the local layers' rotating cache of
    their window (16) wraps; the rglru state (h and the conv's inputs)
    and every KV cache converted from the reference's, at the start
    (bitwise) and the end."""
    ref_cfg, cfg = _cfgs(arch)
    ref_p, port_p = _params(ref_cfg, cfg, seed=2)
    B, steps = 2, 24
    toks = _tokens(cfg, B, steps, seed=3)
    ref_c = ref_models.init_cache(ref_p, ref_cfg, batch=B, max_len=32)
    port_c = init_cache(port_p, cfg, B, 32)
    _cache_close(port_c, cache_from_reference(jax.tree.map(np.asarray, ref_c),
                                              cfg, device="cpu"),
                 np.testing.assert_array_equal)
    ref_step = _ref_step(ref_cfg)
    for t in range(steps):
        want, ref_c = ref_step(ref_p, ref_c, jnp.asarray(toks[:, t]))
        got, port_c = decode_step(port_p, cfg, port_c, toks[:, t])
        assert got.shape == (B, cfg.vocab_size) and got.dtype == torch.float32
        _close(got.numpy(), want)
    want_c = cache_from_reference(jax.tree.map(np.asarray, ref_c), cfg,
                                  device="cpu")
    _cache_close(port_c, want_c, _close)


def test_decode_step_matches_reference_bf16():
    """recurrentgemma-9b in bf16: the logits and the rglru state."""
    ref_cfg, cfg = _cfgs("recurrentgemma-9b", "bfloat16")
    ref_p, port_p = _params(ref_cfg, cfg, seed=2)
    twin_cfg, twin_p = _f32_twin(ref_cfg, ref_p)
    B, steps = 2, 20
    toks = _tokens(cfg, B, steps, seed=3)
    ref_c = ref_models.init_cache(ref_p, ref_cfg, batch=B, max_len=steps)
    twin_c = ref_models.init_cache(twin_p, twin_cfg, batch=B, max_len=steps)
    port_c = init_cache(port_p, cfg, B, steps)
    logits = {"port": [], "ref": [], "twin": []}
    ref_step, twin_step = _ref_step(ref_cfg), _ref_step(twin_cfg)
    for t in range(steps):
        tok = jnp.asarray(toks[:, t])
        want, ref_c = ref_step(ref_p, ref_c, tok)
        want32, twin_c = twin_step(twin_p, twin_c, tok)
        got, port_c = decode_step(port_p, cfg, port_c, toks[:, t])
        for k, v in (("port", got), ("ref", want), ("twin", want32)):
            logits[k].append(np.asarray(v, np.float32))
    _assert_bf16_close(*(np.stack(logits[k]) for k in ("port", "ref", "twin")))
    caches = [cache_from_reference(jax.tree.map(np.asarray, c), cfg,
                                   device="cpu") for c in (ref_c, twin_c)]
    rglru_layers = [i for i, k in enumerate(cfg.layer_kinds()) if k == "rglru"]
    for key in ("h", "conv"):
        _assert_bf16_close(*(np.stack([c["layers"][i][key].float().numpy()
                                       for i in rglru_layers])
                             for c in (port_c, *caches)))


@pytest.mark.parametrize("arch", LOCAL)
def test_decode_matches_forward(arch):
    """Teacher-forced decode logits equal the forward's at every position
    over 40 tokens (past the window; f32 at 1e-4: the two paths sum in
    other orders)."""
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32")
    model = Transformer(cfg).init(seed=4, device="cpu")
    B, S = 2, 40
    toks = _tokens(cfg, B, S, seed=6)
    full = forward(model, cfg, {"tokens": toks})
    cache = init_cache(model, cfg, B, S)
    outs = []
    for t in range(S):
        logits, cache = decode_step(model, cfg, cache, toks[:, t])
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=1e-4,
                               atol=1e-4)


# ------------------------------ serving -------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_generator_greedy_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_p, port_p = _params(ref_cfg, cfg, seed=5)
    prompts = _tokens(cfg, 3, 6, seed=7)
    ref_gen = RefGenerator(ref_cfg, ref_p, max_len=32)
    gen = Generator(cfg, port_p, max_len=32, device="cpu")
    want = ref_gen.generate(prompts, steps=14)
    got = gen.generate(prompts, steps=14)
    np.testing.assert_array_equal(got, want)
    assert gen.last_stats == ref_gen.last_stats


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_bitwise_to_dense(arch, dtype):
    """With an identity page map and P * page_size = max_len (16, the
    window) the paged step is the dense `decode_step` bit for bit."""
    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    model = Transformer(cfg).init(seed=3, device="cpu")
    B, ps, P = 3, 4, 4
    dense = init_cache(model, cfg, B, P * ps)
    paged = init_paged_cache(model, cfg, B, B * P, ps)
    page_map = np.arange(B * P, dtype=np.int32).reshape(B, P)
    toks = np.random.default_rng(4).integers(2, cfg.vocab_size, (B, P * ps))
    for t in range(P * ps):
        want, dense = decode_step(model, cfg, dense, toks[:, t])
        got, paged = paged_decode_step(model, cfg, paged, toks[:, t],
                                       page_map, np.full(B, t),
                                       np.ones(B, bool))
        assert torch.equal(got, want), t


def test_paged_rglru_state_zeroed_at_admission_and_held_when_masked():
    """A slot's rglru state: held where write_mask is False, and zeroed
    at a fresh admission (step 0), whatever the slot held before."""
    cfg = dataclasses.replace(reduce_config(get_config("recurrentgemma-9b")),
                              dtype="float32")
    model = Transformer(cfg).init(seed=8, device="cpu")
    B, ps, P = 2, 4, 4
    paged = init_paged_cache(model, cfg, B, B * P, ps)
    page_map = np.arange(B * P, dtype=np.int32).reshape(B, P)
    toks = np.random.default_rng(9).integers(2, cfg.vocab_size, (B, 6))
    for t in range(5):
        _, paged = paged_decode_step(model, cfg, paged, toks[:, t],
                                     page_map, np.full(B, t),
                                     np.ones(B, bool))
    layer = cfg.layer_kinds().index("rglru")
    held = {k: v.clone() for k, v in paged["layers"][layer].items()}
    assert held["h"].abs().sum() > 0
    # slot 0 masked, slot 1 readmitted at step 0 with a new token
    _, paged = paged_decode_step(model, cfg, paged, toks[:, 5], page_map,
                                 np.array([5, 0]), np.array([False, True]))
    state = paged["layers"][layer]
    for k in ("h", "conv"):
        assert torch.equal(state[k][0], held[k][0]), k
    fresh = init_cache(model, cfg, B, P * ps)
    _, fresh = decode_step(model, cfg, fresh, toks[:, 5])
    for k in ("h", "conv"):
        assert torch.equal(state[k][1], fresh["layers"][layer][k][1]), k


# ------------------------------ training ------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_grads_match_reference(arch):
    """20 positions (past the window of 16: the local layers train
    through `banded_local_attention`) in loss chunks of 8, three labels
    masked: the loss and every parameter's gradient at 1e-5."""
    ref_cfg, cfg = _cfgs(arch)
    ref_cfg = dataclasses.replace(ref_cfg, vocab_size=256)
    cfg = dataclasses.replace(cfg, vocab_size=256)
    rp = ref_models.Transformer(ref_cfg, model_axis=1).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (2, 20)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 20)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    rl, rg = jax.value_and_grad(lambda p: ref_models.loss_fn(
        p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}, dp=None,
        loss_chunk=8))(rp)

    def flat(tree):
        state = {"params": jax.tree.map(np.asarray, tree), "opt": {},
                 "step": 0}
        return state_from_reference(state, cfg, device="cpu")["params"]

    leaves = {k: v.clone().requires_grad_() for k, v in flat(rp).items()}
    loss = loss_fn(leaves, cfg, batch, loss_chunk=8)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss), float(rl), rtol=F32_TOL)
    want = flat(rg)
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)
