"""The port's threefry (`repro_torch.core.prng`) against `jax.random`,
bitwise, in the counter layout the port draws with (jax's
``jax_threefry_partitionable=False``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 7, 123456, 2**31 - 1, 2**32 - 1]
SHAPES = [(1,), (7,), (64,), (8, 4), (5, 3, 3)]


@pytest.fixture(autouse=True)
def _port_layout():
    with jax.threefry_partitionable(False):
        yield


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a.astype(np.uint64)


def _eq(jax_out, torch_out):
    got = torch_out.numpy()
    if got.dtype == np.float32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(_bits(jax_out), got.astype(_bits(jax_out).dtype))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    _eq(key, kt)
    for data in (0, 1, 5, 1663, 2**31 - 1, 2**32 - 1):
        _eq(jax.random.fold_in(key, data), prng.fold_in(kt, data))


@pytest.mark.parametrize("num", [2, 3, 4])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split(seed, num):
    _eq(jax.random.split(jax.random.PRNGKey(seed), num),
        prng.split(prng.PRNGKey(seed), num))


@pytest.mark.parametrize("data", [3, 1663])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_bits_and_uniform(seed, shape, data):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    kt = prng.fold_in(prng.PRNGKey(seed), data)
    _eq(jax.random.bits(key, shape), prng.random_bits(kt, shape))
    u = prng.uniform(kt, shape)
    _eq(jax.random.uniform(key, shape), u)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize("level", [2, 5])
def test_keys_batched_over_ticks_and_trials(level):
    """The schedule's key path: a (trials,) batch of keys, each folded
    with a level and a chunk of tick indices, split four ways, drawn."""
    B = 37
    seeds = jnp.arange(3)
    ts = jnp.arange(64) + 128

    def ref(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), level)

        def tick(t):
            ks = jax.random.split(jax.random.fold_in(key, t), 4)
            return jnp.stack([jax.random.uniform(k, (B,)) for k in ks])

        return jax.vmap(tick)(ts)                    # (T, 4, B)

    want = np.asarray(jax.vmap(ref)(seeds))          # (R, T, 4, B)
    keys = prng.fold_in(torch.stack([prng.PRNGKey(s) for s in range(3)]),
                        level)
    kt = prng.fold_in(keys[None], torch.arange(64)[:, None] + 128)  # (T, R, 2)
    ks = prng.split(kt, 4)                                          # (T, R, 4, 2)
    got = prng.uniform(ks, (B,))                                    # (T, R, 4, B)
    np.testing.assert_array_equal(
        want.view(np.uint32), got.permute(1, 0, 2, 3).numpy().view(np.uint32))
