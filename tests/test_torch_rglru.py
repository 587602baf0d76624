"""The port's RG-LRU block (`repro_torch.models.rglru`) against the
reference's on the CPU, on the same inputs and the reference's
initialised parameters, at recurrentgemma's `reduce_config` width
(d 64, conv width 4).

The port scans each chunk by doubling where the reference runs
`jax.lax.associative_scan`, so the sums come in another order: f32 at
1e-5 (rtol and atol), for the block, decode and the gradients.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

TOL = 1e-5
ARCH = "recurrentgemma-9b"


@pytest.fixture(autouse=True)
def _older_threefry():
    with jax.threefry_partitionable(False):
        yield


def _cfgs(dtype="float32"):
    ref = dataclasses.replace(
        ref_configs.reduce_config(ref_configs.get_config(ARCH)), dtype=dtype)
    port = dataclasses.replace(reduce_config(get_config(ARCH)), dtype=dtype)
    return ref, port


def _params(ref_cfg, seed, dtype=jnp.float32):
    """The reference's parameters as numpy, and as tensors of the same
    values and dtype."""
    descr = ref_rglru.rglru_params(ref_cfg)
    tree = ref_layers.init_tree(descr, jax.random.PRNGKey(seed), dtype)
    tree = jax.tree.map(np.asarray, tree)
    port = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        for k, v in tree.items()}
    return tree, port


def _x(B, S, D, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_params_match_reference():
    ref_cfg, cfg = _cfgs()
    want = ref_rglru.rglru_params(ref_cfg)
    got = rglru.rglru_params(cfg)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k].shape, got[k].init, got[k].scale) == (
            want[k].shape, want[k].init, want[k].scale), k


@pytest.mark.parametrize("S", [1, 7, 512, 1300])
def test_block_matches_reference(S):
    """At the reference's chunk of 512: one short chunk, one full, and
    three with a ragged last one (1300)."""
    ref_cfg, cfg = _cfgs()
    tree, params = _params(ref_cfg, seed=S)
    x = _x(2, S, cfg.d_model, seed=S + 1)
    want = ref_rglru.rglru_block(tree, ref_cfg, jnp.asarray(x), dp=None)
    got = rglru.rglru_block(params, cfg, torch.from_numpy(x))
    assert got.shape == (2, S, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("chunk", [2, 8, 512])
def test_block_chunks_match_reference(chunk):
    """The state carried between chunks as the reference carries it, at
    chunks that divide S and do not."""
    ref_cfg, cfg = _cfgs()
    tree, params = _params(ref_cfg, seed=chunk)
    x = _x(2, 77, cfg.d_model, seed=3)
    want = ref_rglru.rglru_block(tree, ref_cfg, jnp.asarray(x), dp=None,
                                 chunk=chunk)
    got = rglru.rglru_block(params, cfg, torch.from_numpy(x), chunk=chunk)
    _close(got, want)
    # the chunk only splits the scan: the result is the unchunked one
    _close(got, rglru.rglru_block(params, cfg, torch.from_numpy(x),
                                  chunk=10_000).numpy())


def test_bf16_block_close_to_reference():
    """bf16 weights and input: the port and the reference each against
    the f32 computation on the same bf16 values, within 1.5x of the
    reference's own error."""
    ref_cfg, cfg = _cfgs("bfloat16")
    tree, params = _params(ref_cfg, seed=4, dtype=jnp.bfloat16)
    x = _x(2, 40, cfg.d_model, seed=5)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(ref_rglru.rglru_block(tree, ref_cfg, x16, dp=None),
                        np.float32)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    want32 = np.asarray(ref_rglru.rglru_block(
        tree32, dataclasses.replace(ref_cfg, dtype="float32"),
        x16.astype(jnp.float32), dp=None), np.float32)
    got = rglru.rglru_block(params, cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    port_err = np.abs(got.float().numpy() - want32)
    ref_err = np.abs(want16 - want32)
    assert port_err.mean() <= 1.5 * ref_err.mean()
    assert port_err.max() <= 1.5 * ref_err.max()


def test_init_state_matches_reference():
    for dtype in ("float32", "bfloat16"):
        ref_cfg, cfg = _cfgs(dtype)
        want = ref_rglru.init_rglru_state(ref_cfg, 3)
        got = rglru.init_rglru_state(cfg, 3, "cpu")
        assert got.keys() == want.keys()
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert not got[k].any()


def test_decode_matches_block_and_reference():
    """Token by token: the output at every step equals the block's at
    that position and the reference's decode, and the state (h and the
    conv's trailing inputs) the reference's."""
    ref_cfg, cfg = _cfgs()
    tree, params = _params(ref_cfg, seed=6)
    S = 20
    x = _x(2, S, cfg.d_model, seed=7)
    full = rglru.rglru_block(params, cfg, torch.from_numpy(x), chunk=8)
    ref_state = ref_rglru.init_rglru_state(ref_cfg, 2)
    state = rglru.init_rglru_state(cfg, 2, "cpu")
    for t in range(S):
        xt = x[:, t:t + 1]
        want, ref_state = ref_rglru.rglru_decode(tree, ref_cfg,
                                                 jnp.asarray(xt), ref_state)
        got, state = rglru.rglru_decode(params, cfg, torch.from_numpy(xt),
                                        state)
        _close(got, want)
        _close(got[:, 0], full[:, t].numpy())
        for k in ("h", "conv"):
            _close(state[k], ref_state[k])


def test_grads_match_reference():
    """Gradients of a weighted sum of the block's output with respect to
    every parameter and the input, against `jax.grad` of the reference,
    across chunks of 8."""
    ref_cfg, cfg = _cfgs()
    tree, params = _params(ref_cfg, seed=8)
    x = _x(2, 30, cfg.d_model, seed=9)
    w = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)

    def ref_loss(tree, x):
        return (ref_rglru.rglru_block(tree, ref_cfg, x, dp=None, chunk=8)
                * w).sum()

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(
        tree, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    loss = (rglru.rglru_block(leaves, cfg, xt, chunk=8)
            * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    for (k, _), g in zip(leaves.items(), grads):
        _close(g, want_p[k])
    _close(grads[-1], want_x)
