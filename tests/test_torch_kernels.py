"""The port's kernels' plain versions against the reference's oracles,
on the CPU.  The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cell_mixing import cell_mixing as cell_mixing_jax  # noqa: E402
from repro.kernels.cell_mixing import mixing_matrix as mixing_matrix_jax  # noqa: E402
from repro.kernels.cell_mixing import pad_mixing as pad_mixing_jax  # noqa: E402
from repro.kernels.pair_apply import pair_apply_ref as pair_apply_jax  # noqa: E402
from repro_torch.kernels.cell_mixing import (  # noqa: E402
    cell_mixing,
    cell_mixing_ref,
    mixing_matrix,
    pad_mixing,
)
from repro_torch.kernels.cell_mixing.ops import launch_config as mix_config  # noqa: E402
from repro_torch.kernels.pair_apply import pair_apply, pair_apply_ref  # noqa: E402
from repro_torch.kernels.pair_apply.ops import launch_config as pair_config  # noqa: E402

# the shape matrix of tests/test_schedule_parity.py's pair_apply tests
PAIR_SHAPES = [(1, 8, 1, 16), (3, 13, 2, 64), (7, 5, 1, 32), (16, 9, 2, 48)]


def _schedule(rng, B, C, T, same=0.1):
    i = rng.integers(0, C, (T, B)).astype(np.int32)
    j = rng.integers(0, C, (T, B)).astype(np.int32)
    j = np.where(rng.uniform(size=(T, B)) < same, i, j)  # i == j ticks
    ui = rng.uniform(size=(T, B)) < 0.8
    uj = rng.uniform(size=(T, B)) < 0.9
    return i, j, ui, uj


@pytest.mark.parametrize("B,C,V,T", PAIR_SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_apply_ref_bitwise_vs_reference(B, C, V, T, seed):
    rng = np.random.default_rng(B * T + seed)
    x = rng.normal(size=(B, C, V)).astype(np.float32)
    sched = _schedule(rng, B, C, T)
    want = np.asarray(pair_apply_jax(jnp.asarray(x),
                                     *map(jnp.asarray, sched)))
    args = [torch.from_numpy(a) for a in (x, *sched)]
    for fn in (pair_apply_ref, pair_apply):  # the op takes ref on the CPU
        got = fn(*args).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pair_apply_masked_is_identity():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 9, 1)).astype(np.float32))
    i, j, _, _ = _schedule(rng, 2, 9, 16)
    off = torch.zeros((16, 2), dtype=torch.bool)
    got = pair_apply(x, torch.from_numpy(i), torch.from_numpy(j), off, off)
    assert torch.equal(got, x)


def _random_mixing(rng, B, m):
    """Symmetric doubly-stochastic Metropolis matrices of random graphs."""
    w = np.zeros((B, m, m), np.float32)
    for b in range(B):
        adj = rng.uniform(size=(m, m)) < 0.3
        adj = np.triu(adj, 1)
        adj = adj | adj.T
        deg = adj.sum(1)
        for i in range(m):
            for j in range(m):
                if adj[i, j]:
                    w[b, i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        np.fill_diagonal(w[b], 1.0 - w[b].sum(1))
    return w


@pytest.mark.parametrize("B,m,d", [(1, 8, 128), (3, 16, 256), (2, 40, 384),
                                   (5, 9, 2)])
@pytest.mark.parametrize("rounds", [1, 4])
def test_cell_mixing_ref_matches_reference(B, m, d, rounds):
    rng = np.random.default_rng(B * 100 + m + rounds)
    w = _random_mixing(rng, B, m)
    x = rng.normal(size=(B, m, d)).astype(np.float32)
    want = np.asarray(cell_mixing_jax(jnp.asarray(w), jnp.asarray(x),
                                      rounds=rounds, use_pallas=False))
    for fn in (cell_mixing_ref, cell_mixing):
        got = fn(torch.from_numpy(w), torch.from_numpy(x), rounds=rounds)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cell_mixing_preserves_mass_and_consensus():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(_random_mixing(rng, 2, 16))
    x = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    y = cell_mixing(w, x, rounds=64)
    np.testing.assert_allclose(y.sum(1).numpy(), x.sum(1).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        y.numpy(), (x.mean(1, keepdim=True) * torch.ones_like(x)).numpy(),
        rtol=1e-2, atol=1e-2)


def test_mixing_matrix_and_padding_match_reference():
    from repro.core import batched_graphs, random_geometric_graph

    g = random_geometric_graph(40, seed=5)
    nbr, deg, n_nodes, _ = batched_graphs([g, g])
    want = mixing_matrix_jax(nbr, deg, n_nodes)
    got = mixing_matrix(nbr, deg, n_nodes)
    np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(1).normal(size=(2, 40, 3)).astype(np.float32)
    wj, xj, dims = pad_mixing_jax(want, x)
    wt, xt, dims_t = pad_mixing(torch.from_numpy(got), torch.from_numpy(x))
    assert dims == dims_t
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())


@pytest.mark.parametrize("C,V,T,want", [
    (9, 2, 50, (8, True)), (49, 2, 64, (8, True)), (130, 2, 1, (1, True)),
    (1000, 1, 200, (8, True)), (20000, 2, 64, (8, False))])
def test_pair_apply_launch_config(C, V, T, want):
    """32 cells a block; the schedule staged in tiles of up to 8 ticks,
    two in flight (a spare row beside them); the state in shared memory
    while it fits beside them in the H100's 227 KB a block."""
    assert pair_config(C, V, T) == want
    tile, in_smem = want
    ring = 128 + (2 * tile + 1) * (2 * 144 + 2 * 48)
    assert ((32 * C * V * 4 if in_smem else 0) + ring) <= 227 * 1024


@pytest.mark.parametrize("m,d,want", [
    (15, 2, (2, True)), (1, 1, (1, True)), (32, 33, (33, True)),
    (33, 1, (1, True)), (49, 2, (2, True)), (49, 33, (33, True)),
    (130, 2, (2, True)), (300, 2, (2, False)), (400, 2, (2, False))])
def test_cell_mixing_launch_config(m, d, want):
    """The block path's d-tile and W's place; the warp path (m <= 32)
    reads neither.  Two state tiles always fit, and W beside them when
    it is placed in shared memory (rows of m | 1 floats)."""
    assert mix_config(m, d) == want
    dt, w_in_smem = want
    smem = ((m * (m | 1) if w_in_smem else 0) + 2 * m * dt) * 4
    assert smem <= 200 * 1024
