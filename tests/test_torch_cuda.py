"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test skips (the kernels
have no CPU mode).  The file imports no jax, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cell_mixing import cell_mixing, cell_mixing_ref  # noqa: E402
from repro_torch.kernels.pair_apply import pair_apply, pair_apply_ref  # noqa: E402


def _schedule(rng, B, C, T, same=0.1):
    i = rng.integers(0, C, (T, B)).astype(np.int32)
    j = rng.integers(0, C, (T, B)).astype(np.int32)
    j = np.where(rng.uniform(size=(T, B)) < same, i, j)  # i == j ticks
    ui = rng.uniform(size=(T, B)) < 0.8
    uj = rng.uniform(size=(T, B)) < 0.9
    return i, j, ui, uj


def _random_mixing(rng, B, m):
    """Symmetric doubly-stochastic Metropolis matrices of random graphs."""
    w = np.zeros((B, m, m), np.float32)
    for b in range(B):
        adj = np.triu(rng.uniform(size=(m, m)) < 0.3, 1)
        adj = adj | adj.T
        deg = adj.sum(1)
        ii, jj = np.nonzero(adj)
        w[b, ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
        np.fill_diagonal(w[b], 1.0 - w[b].sum(1))
    return w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 9, 16, 49, 130])
@pytest.mark.parametrize("smem_cap", [96 * 1024, 0])
def test_pair_apply_kernel_bitwise_on_card(cuda_device, C, smem_cap):
    rng = np.random.default_rng(C)
    B, V, T = 1031, 2, 64
    x = rng.normal(size=(B, C, V)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (x, *_schedule(rng, B, C, T))]
    got = pair_apply(*args, smem_cap=smem_cap)
    want = pair_apply_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("m,d", [(9, 2), (49, 33), (300, 2)])
def test_cell_mixing_kernel_on_card(cuda_device, m, d, rounds):
    rng = np.random.default_rng(m + d)
    w = torch.from_numpy(_random_mixing(rng, 7, m)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(7, m, d)).astype(np.float32)).to(
        cuda_device)
    got = cell_mixing(w, x, rounds=rounds)
    torch.testing.assert_close(got, cell_mixing_ref(w, x, rounds=rounds),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.sum(1), x.sum(1), rtol=1e-4, atol=1e-4)
