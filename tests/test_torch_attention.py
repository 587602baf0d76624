"""The port's attention layer and the layers it needs (RoPE, M-RoPE, the
MLPs) against the reference package on the CPU, on the same inputs and
the reference's initialised parameters, at `reduce_config` sizes.

`attention()` is held on each of its routes with the reference's own
`chunk_threshold`: above it the reference runs `chunked_attention`, and
the port its flash op (the plain version on CPU tensors) for serving
self-attention at `positions=None`, else its own `chunked_attention`
(explicit and M-RoPE positions, cross-attention, training); at the
default both run the direct softmax.  A "local" layer over more keys
than its window takes the reference's `banded_local_attention`, and the
port its flash op with the window (serving at `positions=None`) or its
own `banded_local_attention` (training, explicit positions).
`chunked_attention` alone is held against the reference's over
causal and full masks, windows, softcaps, GQA groups, ragged chunks,
cross shapes and a query row with no kept key, its gradients against
`jax.grad`.  All in f32 at 1e-5 (rtol and atol): the two frameworks sum
in other orders; bf16 by the bf16 rule of `tests/test_torch_models.py`
(mean and largest error 1.5x, each row 2.5x the reference's own
bf16-vs-f32 error).  RoPE is held at 1e-5 up to
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


@pytest.fixture
def flash_calls(monkeypatch):
    """Calls of the flash op from `attention()` (on CPU tensors it runs
    its plain version, so the op's launch count stays 0)."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return flash_attention(*args, **kw)
    monkeypatch.setattr(attn, "flash_attention", spy)
    return calls


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


def _past_threshold_case(case):
    """(reference config, port config, reference params, port params,
    x, positions or None, memory or None) of one `attention()` input
    past a threshold of 4 keys."""
    arch = "qwen2-vl-72b" if case == "mrope" else "llama3.2-3b"
    ref_cfg, cfg = _cfgs(arch)
    tree, params = _attn_params(ref_cfg, seed=11)
    rng = np.random.default_rng(12)
    B, S = 2, 13
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    memory = None
    if case == "shifted":
        pos = np.broadcast_to(np.arange(S)[None] + 5, (B, S))
    elif case == "mrope":
        pos = np.sort(rng.integers(0, 40, size=(B, S, 3)), axis=1)
    else:   # "index": 0..S-1 given explicitly; "cross": the queries' own
        pos = np.broadcast_to(np.arange(S)[None], (B, S))
    if case == "cross":
        memory = rng.normal(size=(B, 19, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, tree, params, x, pos.astype(np.int32), memory


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", ["shifted", "index", "mrope", "cross"])
def test_flash_route_takes_only_index_positions(case, causal, flash_calls):
    """Past the threshold the flash op (which masks by index) serves only
    self-attention at positions=None; explicit positions (shifted, or
    0..S-1 given), M-RoPE positions and cross-attention (19 memory
    keys, not causal) take `chunked_attention` and match the
    reference's `attention(chunk_threshold=4)` at 1e-5, serving and
    training alike.  The direct route below the threshold takes them
    too."""
    ref_cfg, cfg, tree, params, x, pos, memory = _past_threshold_case(case)
    mem = None if memory is None else jnp.asarray(memory)
    for threshold in (4, 2047):
        want = ref_attn.attention(tree, ref_cfg, jnp.asarray(x),
                                  jnp.asarray(pos), causal=causal,
                                  memory=mem, chunk_threshold=threshold)
        for train in (False, True):
            got = attn.attention(
                params, cfg, _t(x), _t(pos), causal=causal,
                memory=None if memory is None else _t(memory),
                chunk_threshold=threshold, train=train)
            _close(got, want)
    assert flash_calls == []
    if case == "index":
        attn.attention(params, cfg, _t(x), None, causal=causal,
                       chunk_threshold=4)
        assert len(flash_calls) == 1
    if case == "mrope":
        with pytest.raises(ValueError, match="M-RoPE"):
            attn.attention(params, cfg, _t(x))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_index_route_past_threshold_matches_chunked(causal, flash_calls):
    """At positions=None past the threshold, serving takes the flash op
    and training `chunked_attention`: both equal the reference's
    chunked route at 1e-5."""
    ref_cfg, cfg, tree, params, x, pos, _ = _past_threshold_case("index")
    want = ref_attn.attention(tree, ref_cfg, jnp.asarray(x), jnp.asarray(pos),
                              causal=causal, chunk_threshold=4)
    for train, flashed in ((False, 1), (True, 1)):
        got = attn.attention(params, cfg, _t(x), None, causal=causal,
                             chunk_threshold=4, train=train)
        _close(got, want)
        assert len(flash_calls) == flashed


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


@pytest.mark.parametrize("arch", ["gemma2-27b", "recurrentgemma-9b"])
def test_local_flash_route_takes_only_index_positions(arch, flash_calls):
    """Beyond the window the serving route is the flash kernel, which
    masks by index: it takes positions=None only.  Explicit positions
    (shifted by 3) take `banded_local_attention` when serving and when
    training, and match the reference (its banded route) at 1e-5; at or
    under the window the direct route takes them."""
    ref_cfg, cfg = _cfgs(arch)
    tree, params = _attn_params(ref_cfg, seed=1)
    S = cfg.window + 4
    x = np.random.default_rng(2).normal(size=(1, S, cfg.d_model)).astype(
        np.float32)
    pos = (np.arange(S)[None] + 3).astype(np.int32)
    for n in (S, cfg.window):
        want = ref_attn.attention(tree, ref_cfg, jnp.asarray(x[:, :n]),
                                  jnp.asarray(pos[:, :n]), kind="local")
        for train in (False, True):
            got = attn.attention(params, cfg, _t(x[:, :n]), _t(pos[:, :n]),
                                 kind="local", train=train)
            _close(got, want)
    assert flash_calls == []
    attn.attention(params, cfg, _t(x), None, kind="local")
    assert len(flash_calls) == 1 and flash_calls[0]["window"] == cfg.window


# ------------------------- chunked_attention --------------------------


def _chunked_inputs(B, H, Hkv, Sq, Sk, dh, q_shift, k_shift, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, Sk, dh)).astype(np.float32)
            for _ in range(2))
    q_pos = np.broadcast_to(np.arange(Sq)[None] + q_shift, (B, Sq))
    k_pos = np.broadcast_to(np.arange(Sk)[None] + k_shift, (B, Sk))
    cot = rng.normal(size=(B, H, Sq, dh)).astype(np.float32)
    return q, k, v, q_pos.astype(np.int32), k_pos.astype(np.int32), cot


def _chunked_both(inputs, kw):
    """(port output, port grads of q, k, v) and the reference's, for the
    loss sum(out * cot)."""
    q, k, v, q_pos, k_pos, cot = inputs

    def ref_loss(q, k, v):
        out = ref_attn.chunked_attention(q, k, v, jnp.asarray(q_pos),
                                         jnp.asarray(k_pos), **kw)
        return jnp.sum(out * cot), out
    (_, want), want_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    got = attn.chunked_attention(*ts, _t(q_pos), _t(k_pos), **kw)
    got_g = torch.autograd.grad((got * _t(cot)).sum(), ts)
    return (got.detach(), got_g), (want, want_g)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("softcap", [None, 20.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("window", [None, 3], ids=["nowin", "win3"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_chunked_attention_matches_reference(causal, window, softcap, groups,
                                             chunk):
    """13 keys in chunks of 4 or 8 (the last padded), queries at positions
    2..14 and keys at 5..17: causal, queries 2..4 keep no key, so their
    rows end as the mean of every masked and padded value, as the
    reference's finite -1e30 makes them.  Output and the gradients of
    q, k and v at 1e-5."""
    inputs = _chunked_inputs(2, 2 * groups, 2, 13, 13, 8, 2, 5, seed=chunk)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=0.4,
              chunk=chunk)
    (got, got_g), (want, want_g) = _chunked_both(inputs, kw)
    assert got.shape == inputs[0].shape and got.dtype == torch.float32
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)
    if causal:
        # the rows with no kept key: the mean over all 16 padded keys
        v = np.pad(inputs[2], ((0, 0), (0, 0), (0, 16 - 13), (0, 0)))
        mean = np.repeat(v.mean(2, keepdims=True), groups, axis=1)
        want_rows = np.broadcast_to(mean, got[:, :, :3].shape)
        _close(got[:, :, :3], want_rows)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Sq,Sk,chunk", [(5, 19, 4), (30, 9, 8), (1, 12, 8)])
def test_chunked_cross_attention_matches_reference(Sq, Sk, chunk, causal):
    """Queries and keys of other lengths (cross-attention shapes, and
    the decode step's one query), GQA 3, at 1e-5 with gradients."""
    inputs = _chunked_inputs(2, 6, 2, Sq, Sk, 8, 0, 0, seed=Sq + Sk)
    kw = dict(causal=causal, window=None, softcap=None, scale=0.35,
              chunk=chunk)
    (got, got_g), (want, want_g) = _chunked_both(inputs, kw)
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_chunked_attention_bf16_by_the_bf16_rule(causal, groups):
    """bf16 q, k, v: upcast to f32, summed in f32, rounded to bf16 once.
    Held to the reference's own bf16 error against its f32 run on the
    same bf16 values (mean and largest 1.5x, each row 2.5x)."""
    q, k, v, q_pos, k_pos, _ = _chunked_inputs(2, 4 * groups, 4, 40, 40, 16,
                                               0, 0, seed=groups)
    q, k, v = (_bf16(a) for a in (q, k, v))
    kw = dict(causal=causal, window=None, softcap=None, scale=0.25, chunk=16)
    pos = (jnp.asarray(q_pos), jnp.asarray(k_pos))
    ref16 = ref_attn.chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), *pos, **kw)
    ref32 = ref_attn.chunked_attention(*map(jnp.asarray, (q, k, v)), *pos,
                                       **kw)
    port = attn.chunked_attention(*(_t(a).to(torch.bfloat16)
                                    for a in (q, k, v)),
                                  _t(q_pos), _t(k_pos), **kw)
    assert port.dtype == torch.bfloat16
    port, ref16, ref32 = (np.asarray(a, np.float32).reshape(-1, 16)
                          for a in (port.float(), ref16, ref32))
    port_err, ref_err = np.abs(port - ref32), np.abs(ref16 - ref32)
    assert port_err.mean() <= 1.5 * ref_err.mean()
    assert port_err.max() <= 1.5 * ref_err.max()
    assert (port_err.mean(1) <= 2.5 * ref_err.mean(1)).all()


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


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-tiny"])
def test_decode_attention_over_memory_kv_matches_reference(arch):
    """`decode_attention(memory_kv=)`: the token attends over precomputed
    cross keys and values (GQA 4 / 2 for llama, 4 / 4 for whisper at
    this size), no rotary, no mask; the cache comes back untouched."""
    ref_cfg, cfg = _cfgs(arch)
    tree, params = _attn_params(ref_cfg, seed=13)
    rng = np.random.default_rng(14)
    B, Sm = 2, 11
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(B, cfg.kv_heads, Sm, cfg.head_width)).astype(
        np.float32) for _ in range(2))
    k_pos = np.broadcast_to(np.arange(Sm)[None], (B, Sm)).astype(np.int32)
    ref_c = ref_attn.init_kv_cache(ref_cfg, "attn", B, 4)
    port_c = attn.init_kv_cache(cfg, "attn", B, 4, "cpu")
    want, _ = ref_attn.decode_attention(
        tree, ref_cfg, jnp.asarray(x), ref_c, jnp.asarray(3, jnp.int32),
        memory_kv=tuple(map(jnp.asarray, (k, v, k_pos))))
    got, cache = attn.decode_attention(params, cfg, _t(x), port_c, 3,
                                       memory_kv=tuple(map(_t, (k, v, k_pos))))
    assert got.shape == (B, 1, cfg.d_model)
    _close(got, want)
    assert cache is port_c and bool((cache["pos"] == -1).all())
    assert attn.attn_params(cfg, cross=True) == attn.attn_params(cfg)


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
