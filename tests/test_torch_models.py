"""The port's serving path against the reference package, on the CPU,
at `reduce_config` size (2 layers, d 64, heads of 16, vocab 512) on the
reference's initialised parameters (`params_from_reference`): rwkv6-3b,
and the dense attention models llama3.2-3b (tied, GQA), yi-6b (untied)
and gemma-7b (GeGLU, scaled embeddings, MHA), the encoder-decoder
whisper-tiny (2 encoder layers over 24 frames at this size) and
qwen2-vl-72b (M-RoPE).  One forward runs 2100 tokens, past the
reference's `chunk_threshold`, so the model itself takes the flash
route (the op's plain version on CPU tensors) where the reference runs
`chunked_attention`; whisper's decoder does the same at 2100 tokens, and
qwen2-vl-72b's M-RoPE positions take the port's `chunked_attention`
there.

Tolerances:

* float32 config: 1e-5 (rtol and atol).  The two frameworks run the same
  f32 arithmetic with sums in other orders.
* bfloat16 config: bf16 rounds at other places in the two frameworks, so
  single logits differ by a bf16 ulp of their own size or more, and an
  element-wise 2e-2 does not hold for every logit.  The port's bf16
  results must instead be as close to the f32 computation on the same
  bf16 weights (`ref32`) as the reference's bf16 results (`ref16`) are,
  read three ways:

  - the mean of |port - ref32| over everything at most 1.5x the mean of
    |ref16 - ref32|;
  - the largest element of |port - ref32| at most 1.5x the largest of
    |ref16 - ref32|;
  - per row, the mean of |port - ref32| at most 2.5x that row's mean of
    |ref16 - ref32|.  A row is one index of the two leading axes: one
    position's logits (batch x position, or step x batch), one layer's
    cache of one slot (layer x batch) or of one batch-head (layer x
    batch-head).

  The last two fail a bf16 fault that hits only a few rows or elements,
  which the mean alone would average away.  (Measured at these seeds:
  at most 1.08, 1.17 and 1.94.)
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
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduce_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Transformer,
    cache_from_reference,
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    params_from_reference,
)
from repro_torch.serve import Generator  # noqa: E402

F32_TOL = 1e-5
BF16_MEAN_RATIO = 1.5
BF16_MAX_RATIO = 1.5
BF16_ROW_RATIO = 2.5


DENSE = ("llama3.2-3b", "yi-6b", "gemma-7b")


def _cfgs(dtype="bfloat16", arch="rwkv6-3b", **changes):
    ref = dataclasses.replace(
        ref_configs.reduce_config(ref_configs.get_config(arch)),
        dtype=dtype, **changes)
    port = dataclasses.replace(reduce_config(get_config(arch)),
                               dtype=dtype, **changes)
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
    """The reference config and parameters in f32 (bf16 values exactly)."""
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


# ------------------------------ configs -------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    assert ARCH_IDS == ref_configs.ARCH_IDS and SHAPES == ref_configs.SHAPES
    for mine, ref in ((get_config(arch), ref_configs.get_config(arch)),
                      (reduce_config(get_config(arch)),
                       ref_configs.reduce_config(ref_configs.get_config(arch)))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.scan_groups() == ref.scan_groups()


@pytest.mark.parametrize("reduced", [True, False])
def test_num_params_match_reference(reduced):
    cfg, ref_cfg = get_config("rwkv6-3b"), ref_configs.get_config("rwkv6-3b")
    if reduced:
        cfg, ref_cfg = reduce_config(cfg), ref_configs.reduce_config(ref_cfg)
    model = Transformer(cfg)  # on the meta device: nothing is allocated
    want = ref_models.Transformer(ref_cfg, model_axis=1).num_params
    assert model.num_params == want == sum(p.numel() for p in model.parameters())
    if not reduced:
        assert want == 3_073_477_120
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_unported_block_kinds_raise(arch):
    """whisper's encoder and cross-attention are ported: the model builds
    with the reference's parameter names and shapes.  What it still
    refuses is what the reference refuses: the paged cache, and a
    forward or cache without frames."""
    ref_cfg, cfg = _cfgs("float32", arch)
    model = Transformer(cfg)
    want = ref_models.Transformer(ref_cfg, model_axis=1).abstract()
    names = dict(model.named_parameters())
    assert names["blocks.0.xattn.wq"].shape == want["groups"][0]["b0"][
        "xattn"]["wq"].shape[1:]
    assert names["encoder.blocks.1.attn.wo"].shape == want["encoder"][
        "blocks"]["b0"]["attn"]["wo"].shape[1:]
    assert len(model.encoder.blocks) == cfg.encoder_layers == 2
    port = model.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        init_paged_cache(port, cfg, 2, 4, 4)
    with pytest.raises(ValueError, match="needs frames"):
        forward(port, cfg, {"tokens": _tokens(cfg, 1, 4, seed=0)})
    with pytest.raises(ValueError, match="needs frames"):
        init_cache(port, cfg, 1, 4)


# the reference's counts at full size (`Transformer(cfg, model_axis=1)`)
ZOO_PARAMS = {"recurrentgemma-9b": 9_396_088_832,
              "gemma2-27b": 27_227_128_320,
              "grok-1-314b": 316_489_340_928,
              "llama4-maverick-400b-a17b": 778_214_937_600}


@pytest.mark.parametrize("arch", list(ZOO_PARAMS))
@pytest.mark.parametrize("reduced", [True, False])
def test_zoo_num_params_match_reference(arch, reduced):
    """The RG-LRU, local-attention and MoE configs build (on the meta
    device) with the reference's parameter tree: names, shapes, count."""
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    if reduced:
        cfg, ref_cfg = reduce_config(cfg), ref_configs.reduce_config(ref_cfg)
    model = Transformer(cfg)
    want = ref_models.Transformer(ref_cfg, model_axis=1).num_params
    assert model.num_params == want == sum(p.numel() for p in model.parameters())
    if not reduced:
        assert want == ZOO_PARAMS[arch]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("reduced", [True, False])
def test_dense_num_params_match_reference(arch, reduced):
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    if reduced:
        cfg, ref_cfg = reduce_config(cfg), ref_configs.reduce_config(ref_cfg)
    model = Transformer(cfg)
    want = ref_models.Transformer(ref_cfg, model_axis=1).num_params
    assert model.num_params == want == sum(p.numel() for p in model.parameters())
    if arch == "llama3.2-3b" and not reduced:
        assert want == 3_212_749_824


def test_init_from_seed():
    _, cfg = _cfgs()
    a = Transformer(cfg).init(seed=3, device="cpu")
    b = Transformer(cfg).init(seed=3, device="cpu")
    c = Transformer(cfg).init(seed=4, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed, c.embed)
    blk = a.blocks[0]
    assert blk["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(blk["ln1"]["scale"], torch.ones(cfg.d_model))
    assert torch.equal(blk["ln1"]["bias"], torch.zeros(cfg.d_model))
    assert torch.equal(a.final_norm["scale"], torch.zeros(cfg.d_model))
    assert blk["time"]["wr"].dtype == torch.bfloat16
    # fan_in init: std scale / sqrt(fan_in) of the reference's P_
    D, F_ = cfg.d_model, cfg.d_ff
    wv = blk["channel"]["wv"].float()
    assert abs(float(wv.std()) * np.sqrt(F_) - 1.0) < 0.05
    assert abs(float(a.embed.float().std()) - 1.0) < 0.05
    assert abs(float(blk["time"]["wa"].float().std()) * np.sqrt(D) - 0.5) < 0.05


# ------------------------------ forward -------------------------------


@pytest.mark.parametrize("changes", [
    {}, {"tie_embeddings": True}, {"scale_embeddings": True},
    {"final_logit_softcap": 3.0}], ids=["untied", "tied", "scaled", "softcap"])
def test_forward_matches_reference_f32(changes):
    ref_cfg, cfg = _cfgs("float32", **changes)
    ref_p, port_p = _params(ref_cfg, cfg, seed=0)
    toks = _tokens(cfg, 2, 16, seed=1)
    want = ref_models.forward(ref_p, ref_cfg, {"tokens": jnp.asarray(toks)})
    got = forward(port_p, cfg, {"tokens": toks})
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference_bf16(seed):
    ref_cfg, cfg = _cfgs("bfloat16")
    ref_p, port_p = _params(ref_cfg, cfg, seed=seed)
    toks = _tokens(cfg, 2, 16, seed=seed + 10)
    want16 = ref_models.forward(ref_p, ref_cfg, {"tokens": jnp.asarray(toks)})
    want32 = ref_models.forward(*reversed(_f32_twin(ref_cfg, ref_p)),
                                {"tokens": jnp.asarray(toks)})
    _assert_bf16_close(port_p({"tokens": toks}), want16, want32)


# ------------------------------ decode --------------------------------


def _cache_close(got, want, check):
    assert got["step"] == want["step"]
    for layer_got, layer_want in zip(got["layers"], want["layers"]):
        assert layer_got.keys() == layer_want.keys()
        for k in layer_got:
            assert layer_got[k].dtype == layer_want[k].dtype, k
            check(layer_got[k].float().numpy(), layer_want[k].float().numpy())


def test_decode_step_and_cache_match_reference_f32():
    ref_cfg, cfg = _cfgs("float32")
    ref_p, port_p = _params(ref_cfg, cfg, seed=2)
    B, steps = 2, 8
    toks = _tokens(cfg, B, steps, seed=3)
    ref_c = ref_models.init_cache(ref_p, ref_cfg, batch=B, max_len=16)
    port_c = init_cache(port_p, cfg, B, 16)
    _cache_close(port_c, cache_from_reference(jax.tree.map(np.asarray, ref_c),
                                              cfg, device="cpu"),
                 np.testing.assert_array_equal)
    for t in range(steps):
        want, ref_c = ref_models.decode_step(ref_p, ref_cfg, ref_c,
                                             jnp.asarray(toks[:, t]))
        got, port_c = decode_step(port_p, cfg, port_c, toks[:, t])
        assert got.shape == (B, cfg.vocab_size) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
    want_c = cache_from_reference(jax.tree.map(np.asarray, ref_c), cfg,
                                  device="cpu")
    _cache_close(port_c, want_c, lambda a, b: np.testing.assert_allclose(
        a, b, rtol=F32_TOL, atol=F32_TOL))


def test_decode_step_and_cache_match_reference_bf16():
    ref_cfg, cfg = _cfgs("bfloat16")
    ref_p, port_p = _params(ref_cfg, cfg, seed=2)
    twin_cfg, twin_p = _f32_twin(ref_cfg, ref_p)
    B, steps = 2, 8
    toks = _tokens(cfg, B, steps, seed=3)
    ref_c = ref_models.init_cache(ref_p, ref_cfg, batch=B, max_len=16)
    twin_c = ref_models.init_cache(twin_p, twin_cfg, batch=B, max_len=16)
    port_c = init_cache(port_p, cfg, B, 16)
    logits = {"port": [], "ref": [], "twin": []}
    for t in range(steps):
        tok = jnp.asarray(toks[:, t])
        want, ref_c = ref_models.decode_step(ref_p, ref_cfg, ref_c, tok)
        want32, twin_c = ref_models.decode_step(twin_p, twin_cfg, twin_c, tok)
        got, port_c = decode_step(port_p, cfg, port_c, toks[:, t])
        for k, v in (("port", got), ("ref", want), ("twin", want32)):
            logits[k].append(np.asarray(v, np.float32))
    _assert_bf16_close(*(np.stack(logits[k]) for k in ("port", "ref", "twin")))
    caches = [cache_from_reference(jax.tree.map(np.asarray, c), cfg,
                                   device="cpu") for c in (ref_c, twin_c)]
    assert port_c["step"] == caches[0]["step"] == steps
    for key, tensor in port_c["layers"][0].items():
        assert tensor.dtype == caches[0]["layers"][0][key].dtype, key
        _assert_bf16_close(*(np.stack([layer[key].float().numpy()
                                       for layer in c["layers"]])
                             for c in (port_c, *caches)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_decode_matches_forward(dtype, tol):
    """Teacher-forced decode logits equal the prefill forward's at every
    position (the reference's test_decode_matches_prefill_for_ssm, at its
    2e-2 in bf16; f32 at 1e-4: the two paths sum in other orders)."""
    cfg = dataclasses.replace(reduce_config(get_config("rwkv6-3b")),
                              dtype=dtype)
    model = Transformer(cfg).init(seed=4, device="cpu")
    B, S = 1, 8
    toks = _tokens(cfg, B, S, seed=6)
    full = forward(model, cfg, {"tokens": toks})
    cache = init_cache(model, cfg, B, 16)
    outs = []
    for t in range(S):
        logits, cache = decode_step(model, cfg, cache, toks[:, t])
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=tol, atol=tol)


# ------------------------------ serving -------------------------------


def test_generator_greedy_matches_reference():
    ref_cfg, cfg = _cfgs("float32")
    ref_p, port_p = _params(ref_cfg, cfg, seed=5)
    prompts = _tokens(cfg, 3, 6, seed=7)
    ref_gen = RefGenerator(ref_cfg, ref_p, max_len=32)
    gen = Generator(cfg, port_p, max_len=32, device="cpu")
    want = ref_gen.generate(prompts, steps=8)
    got = gen.generate(prompts, steps=8)
    np.testing.assert_array_equal(got, want)
    assert gen.last_stats == ref_gen.last_stats


def test_generator_stops_at_eos_like_reference():
    """A slot that emits eos keeps emitting it and stops counting as live;
    the run ends when every slot is done."""
    ref_cfg, cfg = _cfgs("float32")
    ref_p, port_p = _params(ref_cfg, cfg, seed=5)
    prompts = _tokens(cfg, 3, 6, seed=7)
    first = Generator(cfg, port_p, device="cpu").generate(prompts, steps=1)
    eos = int(first[1, 0])
    want = RefGenerator(ref_cfg, ref_p, eos_id=eos).generate(prompts, steps=6)
    gen = Generator(cfg, port_p, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(gen.generate(prompts, steps=6), want)
    assert gen.last_stats["live_tokens"] < gen.last_stats["emitted_tokens"]


def test_generator_temperature_sampling_is_seeded():
    _, cfg = _cfgs("float32")
    model = Transformer(cfg).init(seed=1, device="cpu")
    prompts = _tokens(cfg, 4, 5, seed=8)
    gen = Generator(cfg, model, temperature=1.0, eos_id=-1, device="cpu")
    a = gen.generate(prompts, steps=6, seed=11)
    b = gen.generate(prompts, steps=6, seed=11)
    c = gen.generate(prompts, steps=6, seed=12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (4, 6) and a.min() >= 0 and a.max() < cfg.vocab_size


# ------------------------- dense attention models ---------------------


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_matches_reference_f32(arch):
    ref_cfg, cfg = _cfgs("float32", arch)
    ref_p, port_p = _params(ref_cfg, cfg, seed=0)
    toks = _tokens(cfg, 2, 16, seed=1)
    want = ref_models.forward(ref_p, ref_cfg, {"tokens": jnp.asarray(toks)})
    got = forward(port_p, cfg, {"tokens": toks})
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_matches_reference_bf16(arch):
    ref_cfg, cfg = _cfgs("bfloat16", arch)
    ref_p, port_p = _params(ref_cfg, cfg, seed=3)
    toks = _tokens(cfg, 2, 16, seed=4)
    want16 = ref_models.forward(ref_p, ref_cfg, {"tokens": jnp.asarray(toks)})
    want32 = ref_models.forward(*reversed(_f32_twin(ref_cfg, ref_p)),
                                {"tokens": jnp.asarray(toks)})
    _assert_bf16_close(port_p({"tokens": toks}), want16, want32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_forward_past_chunk_threshold_matches_reference(dtype):
    """2100 tokens: every layer's attention takes the flash route (the
    reference: chunked_attention over 1024-key chunks)."""
    from repro_torch.kernels.flash_attention import flash_attention
    ref_cfg, cfg = _cfgs(dtype, "llama3.2-3b")
    ref_p, port_p = _params(ref_cfg, cfg, seed=6)
    toks = _tokens(cfg, 1, 2100, seed=7)
    batch = {"tokens": jnp.asarray(toks)}
    want = ref_models.forward(ref_p, ref_cfg, batch)
    before = flash_attention.launches
    got = forward(port_p, cfg, {"tokens": toks})
    assert flash_attention.launches == before  # CPU: the plain version
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
    else:
        want32 = ref_models.forward(*reversed(_f32_twin(ref_cfg, ref_p)),
                                    batch)
        _assert_bf16_close(got, want, want32)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_step_and_cache_match_reference_f32(arch):
    ref_cfg, cfg = _cfgs("float32", arch)
    ref_p, port_p = _params(ref_cfg, cfg, seed=2)
    B, steps = 2, 8
    toks = _tokens(cfg, B, steps, seed=3)
    ref_c = ref_models.init_cache(ref_p, ref_cfg, batch=B, max_len=16)
    port_c = init_cache(port_p, cfg, B, 16)
    _cache_close(port_c, cache_from_reference(jax.tree.map(np.asarray, ref_c),
                                              cfg, device="cpu"),
                 np.testing.assert_array_equal)
    for t in range(steps):
        want, ref_c = ref_models.decode_step(ref_p, ref_cfg, ref_c,
                                             jnp.asarray(toks[:, t]))
        got, port_c = decode_step(port_p, cfg, port_c, toks[:, t])
        assert got.shape == (B, cfg.vocab_size) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
    want_c = cache_from_reference(jax.tree.map(np.asarray, ref_c), cfg,
                                  device="cpu")
    _cache_close(port_c, want_c, lambda a, b: np.testing.assert_allclose(
        a, b, rtol=F32_TOL, atol=F32_TOL))


def test_dense_decode_step_and_cache_match_reference_bf16():
    ref_cfg, cfg = _cfgs("bfloat16", "llama3.2-3b")
    ref_p, port_p = _params(ref_cfg, cfg, seed=2)
    twin_cfg, twin_p = _f32_twin(ref_cfg, ref_p)
    B, steps = 2, 8
    toks = _tokens(cfg, B, steps, seed=3)
    ref_c = ref_models.init_cache(ref_p, ref_cfg, batch=B, max_len=steps)
    twin_c = ref_models.init_cache(twin_p, twin_cfg, batch=B, max_len=steps)
    port_c = init_cache(port_p, cfg, B, steps)
    logits = {"port": [], "ref": [], "twin": []}
    for t in range(steps):
        tok = jnp.asarray(toks[:, t])
        want, ref_c = ref_models.decode_step(ref_p, ref_cfg, ref_c, tok)
        want32, twin_c = ref_models.decode_step(twin_p, twin_cfg, twin_c, tok)
        got, port_c = decode_step(port_p, cfg, port_c, toks[:, t])
        for k, v in (("port", got), ("ref", want), ("twin", want32)):
            logits[k].append(np.asarray(v, np.float32))
    _assert_bf16_close(*(np.stack(logits[k]) for k in ("port", "ref", "twin")))
    caches = [cache_from_reference(jax.tree.map(np.asarray, c), cfg,
                                   device="cpu") for c in (ref_c, twin_c)]
    assert port_c["step"] == caches[0]["step"] == steps
    for key in ("k", "v"):
        assert port_c["layers"][0][key].dtype == torch.bfloat16
        _assert_bf16_close(*(np.stack([layer[key].float().numpy()
                                       for layer in c["layers"]])
                             for c in (port_c, *caches)))
    for mine, ref in zip(port_c["layers"], caches[0]["layers"]):
        assert torch.equal(mine["pos"], ref["pos"])


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_matches_forward(arch):
    """Teacher-forced decode logits equal the forward's at every position
    (f32 at 1e-4: the two paths sum in other orders)."""
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32")
    model = Transformer(cfg).init(seed=4, device="cpu")
    B, S = 2, 10
    toks = _tokens(cfg, B, S, seed=6)
    full = forward(model, cfg, {"tokens": toks})
    cache = init_cache(model, cfg, B, S)
    outs = []
    for t in range(S):
        logits, cache = decode_step(model, cfg, cache, toks[:, t])
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_generator_greedy_matches_reference(arch):
    ref_cfg, cfg = _cfgs("float32", arch)
    ref_p, port_p = _params(ref_cfg, cfg, seed=5)
    prompts = _tokens(cfg, 3, 6, seed=7)
    ref_gen = RefGenerator(ref_cfg, ref_p, max_len=32)
    gen = Generator(cfg, port_p, max_len=32, device="cpu")
    want = ref_gen.generate(prompts, steps=8)
    got = gen.generate(prompts, steps=8)
    np.testing.assert_array_equal(got, want)
    assert gen.last_stats == ref_gen.last_stats


# ------------------------------- whisper -------------------------------


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _whisper_batch(cfg, B, S, seed):
    return {"tokens": _tokens(cfg, B, S, seed),
            "frames": _frames(cfg, B, seed + 1)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("reduced", [True, False])
def test_whisper_num_params_match_reference(reduced):
    cfg, ref_cfg = get_config("whisper-tiny"), ref_configs.get_config(
        "whisper-tiny")
    if reduced:
        cfg, ref_cfg = reduce_config(cfg), ref_configs.reduce_config(ref_cfg)
    model = Transformer(cfg)
    want = ref_models.Transformer(ref_cfg, model_axis=1).num_params
    assert model.num_params == want == sum(p.numel() for p in model.parameters())
    if not reduced:
        assert want == 36_439_680


@pytest.mark.parametrize("seed", [0, 1])
def test_whisper_forward_matches_reference_f32(seed):
    """The encoder over 24 frames, then 2 x 16 decoder tokens through
    self- and cross-attention, at 1e-5."""
    ref_cfg, cfg = _cfgs("float32", "whisper-tiny")
    ref_p, port_p = _params(ref_cfg, cfg, seed=seed)
    batch = _whisper_batch(cfg, 2, 16, seed=seed + 2)
    want = ref_models.forward(ref_p, ref_cfg, _jnp(batch))
    got = forward(port_p, cfg, batch)
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_whisper_forward_matches_reference_bf16():
    ref_cfg, cfg = _cfgs("bfloat16", "whisper-tiny")
    ref_p, port_p = _params(ref_cfg, cfg, seed=3)
    batch = _jnp(_whisper_batch(cfg, 2, 16, seed=4))
    want16 = ref_models.forward(ref_p, ref_cfg, batch)
    want32 = ref_models.forward(*reversed(_f32_twin(ref_cfg, ref_p)), batch)
    got = port_p({k: np.asarray(v) for k, v in batch.items()})
    _assert_bf16_close(got, want16, want32)


def test_whisper_forward_past_chunk_threshold_matches_reference():
    """2100 decoder tokens: the decoder's self-attention takes the flash
    route (the plain version here; the reference: chunked_attention),
    its cross-attention over 24 frames the direct one; f32 at 1e-5."""
    from repro_torch.kernels.flash_attention import flash_attention
    ref_cfg, cfg = _cfgs("float32", "whisper-tiny")
    ref_p, port_p = _params(ref_cfg, cfg, seed=6)
    batch = _whisper_batch(cfg, 1, 2100, seed=7)
    want = ref_models.forward(ref_p, ref_cfg, _jnp(batch))
    before = flash_attention.launches
    got = forward(port_p, cfg, batch)
    assert flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_whisper_decode_step_and_cache_match_reference():
    """`init_cache(frames=)` encodes the frames into the cache's memory
    (equal to the reference's, carried by `cache_from_reference`), and
    each decode step cross-attends to it: logits and caches at 1e-5."""
    ref_cfg, cfg = _cfgs("float32", "whisper-tiny")
    ref_p, port_p = _params(ref_cfg, cfg, seed=2)
    B, steps = 2, 8
    toks = _tokens(cfg, B, steps, seed=3)
    frames = _frames(cfg, B, seed=4)
    ref_c = ref_models.init_cache(ref_p, ref_cfg, batch=B, max_len=16,
                                  frames=jnp.asarray(frames))
    port_c = init_cache(port_p, cfg, B, 16, frames=frames)
    carried = cache_from_reference(jax.tree.map(np.asarray, ref_c), cfg,
                                   device="cpu")
    assert port_c["memory"].shape == (B, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(port_c["memory"].numpy(),
                               carried["memory"].numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    for t in range(steps):
        want, ref_c = ref_models.decode_step(ref_p, ref_cfg, ref_c,
                                             jnp.asarray(toks[:, t]))
        got, port_c = decode_step(port_p, cfg, port_c, toks[:, t])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
    want_c = cache_from_reference(jax.tree.map(np.asarray, ref_c), cfg,
                                  device="cpu")
    _cache_close(port_c, want_c, lambda a, b: np.testing.assert_allclose(
        a, b, rtol=F32_TOL, atol=F32_TOL))
    # the reference's cache, carried over, decodes on in the port alike
    got, _ = decode_step(port_p, cfg, want_c, toks[:, 0])
    want, _ = ref_models.decode_step(ref_p, ref_cfg, ref_c,
                                     jnp.asarray(toks[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_whisper_decode_matches_forward():
    """Teacher-forced decode logits equal the forward's at every
    position (f32 at 1e-4, as the other configs)."""
    cfg = dataclasses.replace(reduce_config(get_config("whisper-tiny")),
                              dtype="float32")
    model = Transformer(cfg).init(seed=4, device="cpu")
    batch = _whisper_batch(cfg, 2, 10, seed=6)
    full = forward(model, cfg, batch)
    cache = init_cache(model, cfg, 2, 10, frames=batch["frames"])
    outs = []
    for t in range(10):
        logits, cache = decode_step(model, cfg, cache, batch["tokens"][:, t])
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=1e-4,
                               atol=1e-4)


def test_whisper_generator_greedy_matches_reference():
    ref_cfg, cfg = _cfgs("float32", "whisper-tiny")
    ref_p, port_p = _params(ref_cfg, cfg, seed=5)
    prompts = _tokens(cfg, 3, 6, seed=7)
    frames = _frames(cfg, 3, seed=8)
    ref_gen = RefGenerator(ref_cfg, ref_p, max_len=32)
    gen = Generator(cfg, port_p, max_len=32, device="cpu")
    want = ref_gen.generate(prompts, steps=8, frames=jnp.asarray(frames))
    got = gen.generate(prompts, steps=8, frames=frames)
    np.testing.assert_array_equal(got, want)
    assert gen.last_stats == ref_gen.last_stats


# ---------------------------- qwen2-vl-72b -----------------------------


def _mrope_positions(B, S, grid):
    """M-RoPE ids as the vision stub lays them out: a text prefix at
    t = h = w = i, a grid x grid patch block at one t with h and w its
    row and column, then text again from the grid's largest id + 1."""
    text = S // 8
    pos = np.zeros((B, S, 3), np.int32)
    pos[:, :text] = np.arange(text)[None, :, None]
    r, c = np.divmod(np.arange(grid * grid), grid)
    pos[:, text:text + grid * grid] = np.stack(
        [np.full_like(r, text), text + r, text + c], -1)
    rest = S - text - grid * grid
    pos[:, text + grid * grid:] = (text + grid + np.arange(rest))[None, :,
                                                                   None]
    return pos


def test_qwen2_vl_forward_past_chunk_threshold_matches_reference():
    """2100 tokens at M-RoPE positions: every layer's attention takes
    `chunked_attention` in the port and in the reference (the flash
    kernel masks by index, so it is not reached); f32 at 1e-5."""
    from repro_torch.kernels.flash_attention import flash_attention
    ref_cfg, cfg = _cfgs("float32", "qwen2-vl-72b")
    ref_p, port_p = _params(ref_cfg, cfg, seed=8)
    toks = _tokens(cfg, 1, 2100, seed=9)
    pos = _mrope_positions(1, 2100, grid=16)
    want = ref_models.forward(ref_p, ref_cfg, {"tokens": jnp.asarray(toks),
                                               "positions": jnp.asarray(pos)})
    before = flash_attention.launches
    got = forward(port_p, cfg, {"tokens": toks, "positions": pos})
    assert flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
