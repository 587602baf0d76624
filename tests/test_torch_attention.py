"""The port's attention layer and the layers it needs (RoPE, M-RoPE, the
MLPs) against the reference package on the CPU, on the same inputs and
the reference's initialised parameters, at `reduce_config` sizes.

`attention()` is held on both of its routes with the reference's own
`chunk_threshold`: above it the reference runs `chunked_attention` and
the port its flash op (the plain version on CPU tensors); at the default
both run the direct softmax.  A "local" layer over more keys than its
window takes the reference's `banded_local_attention`, and the port
its flash op with the window (serving) or its own
`banded_local_attention` (training).  All in f32 at 1e-5 (rtol and atol): the
two frameworks sum in other orders.  RoPE is held at 1e-5 up to
position 4200: the port takes theta ** (-i / half) correctly rounded,
the value XLA gives (torch's own f32 pow is an ulp off at some i).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **changes):
    changes = {"dtype": "float32", **changes}
    ref = dataclasses.replace(
        ref_configs.reduce_config(ref_configs.get_config(arch)), **changes)
    port = dataclasses.replace(reduce_config(get_config(arch)), **changes)
    return ref, port


def _attn_params(ref_cfg, seed):
    """The reference's attention parameters, as numpy and as tensors."""
    descr = ref_attn.attn_params(ref_cfg)
    tree = ref_layers.init_tree(descr, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree.map(np.asarray, tree)
    return tree, {k: _t(v) for k, v in tree.items()}


# ------------------------------- layers -------------------------------


@pytest.mark.parametrize("D,theta", [(16, 500_000.0), (128, 500_000.0),
                                     (128, 5_000_000.0), (256, 10_000.0)])
def test_rope_matches_reference(D, theta):
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 2, 4200, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(4200)[None], (2, 4200)).astype(np.int32)
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(layers.rope(_t(x), _t(pos), theta), want)


def test_rope_keeps_dtype_and_rotates_halves():
    x = torch.zeros((1, 1, 1, 8), dtype=torch.bfloat16)
    x[..., 0] = 1.0                        # x1[0] = 1, its pair is x2[0]
    out = layers.rope(x, torch.tensor([[1]]), 10_000.0)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out[0, 0, 0, [0, 4]].float(),
                               torch.tensor([np.cos(1.0), np.sin(1.0)],
                                            dtype=torch.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_mrope_matches_reference(sections):
    D = 2 * sum(sections)
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 3, 300, D)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 300, 3)).astype(np.int32)
    want = ref_layers.mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    _close(layers.mrope(_t(x), _t(pos), 1e6, sections), want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    descr = ref_layers.mlp_params(64, 160, kind)
    tree = ref_layers.init_tree(descr, jax.random.PRNGKey(3), jnp.float32)
    port = layers.mlp_params(64, 160, kind)
    assert {k: v.shape for k, v in port.items()} == {
        k: v.shape for k, v in descr.items()}
    x = np.random.default_rng(4).normal(size=(2, 7, 64)).astype(np.float32)
    want = ref_layers.mlp(jnp.asarray(x), tree, kind)
    got = layers.mlp(_t(x), {k: _t(v) for k, v in tree.items()}, kind)
    _close(got, want)


# ----------------------------- attention() ----------------------------


@pytest.mark.parametrize("threshold", [8, 2047], ids=["flash", "direct"])
@pytest.mark.parametrize("arch,changes", [
    ("llama3.2-3b", {}),                          # GQA 4 / 2
    ("gemma-7b", {}),                             # MHA
    ("llama3.2-3b", {"attn_logit_softcap": 5.0, "query_scale": 0.3}),
], ids=["llama", "gemma", "softcap"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_routes_match_reference(arch, changes, threshold, causal):
    ref_cfg, cfg = _cfgs(arch, **changes)
    tree, params = _attn_params(ref_cfg, seed=1)
    B, S = 2, 40
    x = np.random.default_rng(2).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = ref_attn.attention(tree, ref_cfg, jnp.asarray(x), jnp.asarray(pos),
                              causal=causal, chunk_threshold=threshold)
    before = flash_attention.launches
    # positions=None: index positions 0..S-1, the flash route's only ones
    got = attn.attention(params, cfg, _t(x), None, causal=causal,
                         chunk_threshold=threshold)
    assert flash_attention.launches == before  # CPU tensors: plain version
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)


def test_flash_route_takes_only_index_positions():
    """Above the threshold the kernel masks by index: it takes
    positions=None (0..S-1) only.  Explicit positions, even 0..S-1,
    M-RoPE positions and cross-attention raise there, and the direct
    route below it still takes them."""
    _, cfg = _cfgs("llama3.2-3b")
    _, params = _attn_params(_cfgs("llama3.2-3b")[0], seed=1)
    x = torch.randn((1, 12, cfg.d_model))
    shifted = torch.arange(12)[None] + 5
    for pos in (shifted, torch.arange(12)[None]):
        with pytest.raises(NotImplementedError, match="Queue A, chunked_attention"):
            attn.attention(params, cfg, x, pos, chunk_threshold=4)
        attn.attention(params, cfg, x, pos)
    attn.attention(params, cfg, x, None, chunk_threshold=4)
    with pytest.raises(NotImplementedError, match="Queue A, chunked_attention"):
        attn.attention(params, cfg, x, None,
                       memory=torch.randn((1, 9, cfg.d_model)),
                       chunk_threshold=4)
    _, vl = _cfgs("qwen2-vl-72b")
    _, vl_params = _attn_params(_cfgs("qwen2-vl-72b")[0], seed=1)
    pos3 = torch.arange(12)[None, :, None].expand(1, 12, 3)
    with pytest.raises(NotImplementedError, match="Queue A, chunked_attention"):
        attn.attention(vl_params, vl, torch.randn((1, 12, vl.d_model)), pos3,
                       chunk_threshold=4)
    with pytest.raises(ValueError, match="M-RoPE"):
        attn.attention(vl_params, vl, torch.randn((1, 12, vl.d_model)))


def test_mrope_attention_matches_reference_on_the_direct_route():
    ref_cfg, cfg = _cfgs("qwen2-vl-72b")
    tree, params = _attn_params(ref_cfg, seed=5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    pos = np.sort(rng.integers(0, 50, size=(2, 20, 3)), axis=1).astype(np.int32)
    want = ref_attn.attention(tree, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    _close(attn.attention(params, cfg, _t(x), _t(pos)), want)


@pytest.mark.parametrize("train", [False, True], ids=["flash", "banded"])
@pytest.mark.parametrize("arch,changes", [
    ("gemma2-27b", {}),                                  # softcap 50, GQA
    ("recurrentgemma-9b", {}),                           # MQA
    ("gemma2-27b", {"attn_logit_softcap": None}),
], ids=["gemma2", "recurrentgemma", "no-softcap"])
def test_sliding_window_route_matches_reference(arch, changes, train):
    """A local layer over more keys than its window (16 at this size):
    the reference takes `banded_local_attention`; the port serves
    through the flash op with the window (its plain version on CPU
    tensors) and trains through its own `banded_local_attention`.  Both
    at 1e-5, 2 x 45 tokens (blocks of 16, the last ragged)."""
    ref_cfg, cfg = _cfgs(arch, **changes)
    tree, params = _attn_params(ref_cfg, seed=3)
    B, S = 2, 45
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = ref_attn.attention(tree, ref_cfg, jnp.asarray(x), jnp.asarray(pos),
                              kind="local")
    before = flash_attention.launches
    got = attn.attention(params, cfg, _t(x), None if not train else _t(pos),
                         kind="local", train=train)
    assert flash_attention.launches == before
    _close(got, want)


@pytest.mark.parametrize("softcap", [None, 30.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("S,window,block", [(45, 16, 16), (64, 16, 16),
                                            (50, 24, 8), (10, 16, 16)])
def test_banded_local_attention_matches_reference(S, window, block, softcap):
    """The banded route alone on shifted positions (the band masks by
    position), GQA 4 / 2, blocks that divide S and do not, a window of
    several blocks, and S below one block."""
    rng = np.random.default_rng(S + window)
    q = rng.normal(size=(2, 4, S, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, S, 16)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S)[None] + 7, (2, S)).astype(np.int32)
    kw = dict(window=window, softcap=softcap, scale=0.25, block=block)
    want = ref_attn.banded_local_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), **kw)
    got = attn.banded_local_attention(*map(_t, (q, k, v, pos, pos)), **kw)
    assert got.shape == q.shape
    _close(got, want)
    # the band keeps exactly the keys the window's mask keeps
    bias = attn._mask_bias(_t(pos), _t(pos), causal=True, window=window)
    full = attn.full_attention(*map(_t, (q, k, v)), bias, softcap=softcap,
                               scale=0.25)
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)


def test_local_flash_route_takes_only_index_positions():
    """Beyond the window the serving route is the flash kernel, which
    masks by index: explicit positions raise there, and training (the
    banded route, which masks by position) takes them."""
    _, cfg = _cfgs("gemma2-27b")
    _, params = _attn_params(_cfgs("gemma2-27b")[0], seed=1)
    x = torch.randn((1, cfg.window + 4, cfg.d_model))
    pos = torch.arange(x.shape[1])[None] + 3
    with pytest.raises(NotImplementedError, match="Queue A, chunked_attention"):
        attn.attention(params, cfg, x, pos, kind="local")
    attn.attention(params, cfg, x, pos, kind="local", train=True)
    attn.attention(params, cfg, x, None, kind="local")
    # at or under the window the direct route takes any positions
    attn.attention(params, cfg, x[:, :cfg.window], pos[:, :cfg.window],
                   kind="local")


# ------------------------------- decode -------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_kv_cache_matches_reference(dtype):
    ref_cfg, cfg = _cfgs("llama3.2-3b", dtype=dtype)
    want = ref_attn.init_kv_cache(ref_cfg, "attn", 3, 10)
    got = attn.init_kv_cache(cfg, "attn", 3, 10, "cpu")
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].shape == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32))


@pytest.mark.parametrize("arch,max_len,kind,steps", [
    ("llama3.2-3b", 16, "attn", 10),
    ("gemma-7b", 16, "attn", 10),
    ("llama3.2-3b", 4, "attn", 10),
    ("gemma2-27b", 64, "local", 40),
    ("recurrentgemma-9b", 64, "local", 40),
], ids=["llama", "gemma", "ring", "local", "local-mqa"])
def test_decode_attention_and_cache_match_reference(arch, max_len, kind,
                                                    steps):
    """Token by token through the KV cache; max_len 4 wraps the ring
    (slot = step % L) twice in 10 steps, and a local layer's ring of its
    window (16) wraps twice in 40."""
    ref_cfg, cfg = _cfgs(arch)
    tree, params = _attn_params(ref_cfg, seed=7)
    B = 2
    xs = np.random.default_rng(8).normal(
        size=(steps, B, 1, cfg.d_model)).astype(np.float32)
    ref_c = ref_attn.init_kv_cache(ref_cfg, kind, B, max_len)
    port_c = attn.init_kv_cache(cfg, kind, B, max_len, "cpu")
    assert port_c["k"].shape == ref_c["k"].shape
    for step, x in enumerate(xs):
        want, ref_c = ref_attn.decode_attention(
            tree, ref_cfg, jnp.asarray(x), ref_c, jnp.asarray(step, jnp.int32),
            kind=kind)
        got, port_c = attn.decode_attention(params, cfg, _t(x), port_c, step,
                                            kind=kind)
        assert got.shape == (B, 1, cfg.d_model)
        _close(got, want)
    for key in ("k", "v", "pos"):
        _close(port_c[key], ref_c[key])


def test_decode_attention_matches_prefill_attention():
    """Decode over the cache gives, row by row, the prefill attention of
    the sequence so far (on both routes)."""
    _, cfg = _cfgs("llama3.2-3b")
    _, params = _attn_params(_cfgs("llama3.2-3b")[0], seed=9)
    S = 12
    x = torch.randn((2, S, cfg.d_model), generator=torch.Generator().manual_seed(0))
    cache = attn.init_kv_cache(cfg, "attn", 2, S, "cpu")
    rows = []
    for t in range(S):
        out, cache = attn.decode_attention(params, cfg, x[:, t:t + 1], cache, t)
        rows.append(out)
    dec = torch.cat(rows, 1)
    for threshold in (4, 2047):
        full = attn.attention(params, cfg, x, None, chunk_threshold=threshold)
        torch.testing.assert_close(dec, full, rtol=1e-5, atol=1e-5)


def test_local_decode_attention_matches_prefill_attention():
    """A local layer (window 16) over 40 tokens: decode through its
    rotating cache, which wraps twice, gives row by row the prefill
    attention on both routes beyond the window: the flash op (serving)
    and `banded_local_attention` (training)."""
    _, cfg = _cfgs("gemma2-27b")
    _, params = _attn_params(_cfgs("gemma2-27b")[0], seed=9)
    S = 40
    x = torch.randn((2, S, cfg.d_model), generator=torch.Generator().manual_seed(0))
    cache = attn.init_kv_cache(cfg, "local", 2, S, "cpu")
    assert cache["k"].shape[2] == cfg.window == 16
    rows = []
    for t in range(S):
        out, cache = attn.decode_attention(params, cfg, x[:, t:t + 1], cache,
                                           t, kind="local")
        rows.append(out)
    dec = torch.cat(rows, 1)
    for train in (False, True):
        full = attn.attention(params, cfg, x, None, kind="local", train=train)
        torch.testing.assert_close(dec, full, rtol=1e-5, atol=1e-5)
