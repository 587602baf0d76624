"""The port's mixture-of-experts FFN (`repro_torch.models.moe`) against
the reference's on the CPU, on the same inputs and the reference's
initialised parameters, at `reduce_config` width (d 64, d_ff 128).

Routing is compared exactly (which tokens each expert takes, which are
dropped past the capacity); the outputs and the gradients in f32 at
1e-5 (rtol and atol): the two frameworks sum in other orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _older_threefry():
    with jax.threefry_partitionable(False):
        yield


def _cfgs(E, K, dtype="float32"):
    changes = dict(dtype=dtype, num_experts=E, experts_per_token=K)
    arch = "grok-1-314b"
    ref = dataclasses.replace(
        ref_configs.reduce_config(ref_configs.get_config(arch)), **changes)
    port = dataclasses.replace(reduce_config(get_config(arch)), **changes)
    return ref, port


def _params(ref_cfg, seed, skew=False):
    """The reference's parameters as numpy and as tensors; with `skew`,
    input feature 0 drives the router strongly toward expert 0 (see
    `_x`)."""
    descr = ref_moe.moe_params(ref_cfg, model_axis=1)
    tree = ref_layers.init_tree(descr, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree.map(np.asarray, tree)
    if skew:
        tree["router"] = tree["router"].copy()
        tree["router"][0, 0] += 2.0
    return tree, {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _x(B, S, D, seed, skew=False):
    """Normal inputs; with `skew`, feature 0 is |x| + 1."""
    x = np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)
    if skew:
        x[..., 0] = np.abs(x[..., 0]) + 1.0
    return x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_params_match_reference():
    ref_cfg, cfg = _cfgs(4, 2)
    want = ref_moe.moe_params(ref_cfg, model_axis=1)
    got = moe.moe_params(cfg)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k].shape, got[k].init, got[k].scale) == (
            want[k].shape, want[k].init, want[k].scale), k


@pytest.mark.parametrize("E,K", [(4, 1), (4, 2), (128, 1), (128, 2)])
def test_moe_ffn_matches_reference(E, K):
    ref_cfg, cfg = _cfgs(E, K)
    tree, params = _params(ref_cfg, seed=E + K)
    x = _x(2, 37, cfg.d_model, seed=E * K)
    want = ref_moe.moe_ffn(tree, ref_cfg, jnp.asarray(x), dp=None)
    got = moe.moe_ffn(params, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("K", [1, 2])
def test_capacity_drops_match_reference(K):
    """300 tokens over 4 experts, the router skewed to expert 0: it is
    picked by more than its capacity of 256 tokens, and the assignments
    past the capacity (the last in token order, by the stable sort) are
    dropped on both sides.  With K = 1 a dropped token's output is
    zero."""
    ref_cfg, cfg = _cfgs(4, K)
    tree, params = _params(ref_cfg, seed=11, skew=True)
    x = _x(1, 300, cfg.d_model, seed=12, skew=True)
    xt = torch.from_numpy(x).reshape(300, -1)
    top = moe._top_k(torch.softmax(xt @ params["router"], -1), K)[1]
    to_first = torch.nonzero((top == 0).any(-1))[:, 0]
    assert len(to_first) > moe.capacity(cfg, 300) == 256
    want = ref_moe.moe_ffn(tree, ref_cfg, jnp.asarray(x), dp=None)
    got = moe.moe_ffn(params, cfg, torch.from_numpy(x))
    _close(got, want)
    zero = torch.nonzero(~got[0].any(-1))[:, 0]
    if K == 1:
        assert torch.equal(zero, to_first[256:])
    else:
        assert len(zero) == 0


@pytest.mark.parametrize("S,token_chunk", [(24, 12), (24, 16)],
                         ids=["divides", "one-chunk"])
def test_token_chunks_match_reference(S, token_chunk):
    """token_chunk below T: 2 x 24 = 48 tokens in chunks of 12, each
    routed with its own capacity, or (16 does not divide 48) in one."""
    ref_cfg, cfg = _cfgs(4, 2)
    tree, params = _params(ref_cfg, seed=13)
    x = _x(2, S, cfg.d_model, seed=14)
    want = ref_moe.moe_ffn(tree, ref_cfg, jnp.asarray(x), dp=None,
                           token_chunk=token_chunk)
    got = moe.moe_ffn(params, cfg, torch.from_numpy(x),
                      token_chunk=token_chunk)
    _close(got, want)
    if token_chunk == 12:  # chunks route alone: each chunk's own result
        parts = [moe.moe_ffn(params, cfg, c) for c in
                 torch.from_numpy(x).reshape(4, 1, 12, -1)]
        torch.testing.assert_close(got.reshape(4, 1, 12, -1),
                                   torch.stack(parts), rtol=0, atol=0)


def test_ties_pick_the_lower_expert():
    """Equal gates: both sides take the lower expert first."""
    ref_cfg, cfg = _cfgs(4, 2)
    tree, params = _params(ref_cfg, seed=15)
    tree["router"] = np.zeros_like(tree["router"])
    tree["router"][:, 3] = 1.0
    params["router"] = torch.from_numpy(tree["router"].copy())
    x = _x(1, 9, cfg.d_model, seed=16)
    x[0, ::2] = 0.0  # these rows give four equal gates
    want = ref_moe.moe_ffn(tree, ref_cfg, jnp.asarray(x), dp=None)
    got = moe.moe_ffn(params, cfg, torch.from_numpy(x))
    _close(got, want)
    _, experts = moe._top_k(torch.full((1, 4), 0.25), 2)
    assert experts.tolist() == [[0, 1]]


def test_bf16_close_to_reference():
    """bf16 weights and input: the port and the reference each against
    the f32 computation on the same bf16 values, within 1.5x of the
    reference's own error (mean and largest element)."""
    ref_cfg, cfg = _cfgs(4, 2, "bfloat16")
    tree, _ = _params(ref_cfg, seed=17)
    tree16 = jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16), tree)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree16)
    params = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in tree32.items()}
    x16 = jnp.asarray(_x(2, 40, cfg.d_model, seed=18), jnp.bfloat16)
    want16 = np.asarray(ref_moe.moe_ffn(tree16, ref_cfg, x16, dp=None),
                        np.float32)
    want32 = np.asarray(ref_moe.moe_ffn(
        tree32, dataclasses.replace(ref_cfg, dtype="float32"),
        x16.astype(jnp.float32), dp=None), np.float32)
    got = moe.moe_ffn(params, cfg,
                      torch.from_numpy(np.asarray(x16, np.float32)).to(
                          torch.bfloat16))
    assert got.dtype == torch.bfloat16
    port_err = np.abs(got.float().numpy() - want32)
    ref_err = np.abs(want16 - want32)
    assert port_err.mean() <= 1.5 * ref_err.mean()
    assert port_err.max() <= 1.5 * ref_err.max()


@pytest.mark.parametrize("skew", [False, True], ids=["kept", "dropped"])
def test_grads_match_reference(skew):
    """Gradients of a weighted sum of the output with respect to every
    parameter and the input, against `jax.grad` of the reference; with
    the skew, through the dropped tokens too."""
    ref_cfg, cfg = _cfgs(4, 2)
    tree, params = _params(ref_cfg, seed=19, skew=skew)
    x = _x(1, 300 if skew else 30, cfg.d_model, seed=20, skew=skew)
    w = np.random.default_rng(21).normal(size=x.shape).astype(np.float32)

    def ref_loss(tree, x):
        return (ref_moe.moe_ffn(tree, ref_cfg, x, dp=None) * w).sum()

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(tree, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    loss = (moe.moe_ffn(leaves, cfg, xt) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    for (k, _), g in zip(leaves.items(), grads):
        _close(g, want_p[k])
    _close(grads[-1], want_x)
