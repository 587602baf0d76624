"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test skips (the kernels
have no CPU mode).  The file imports no jax, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cell_mixing import (  # noqa: E402
    cell_mixing,
    cell_mixing_ref,
    pad_mixing,
)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import KERNELS  # noqa: E402
from repro_torch.kernels.pair_apply import pair_apply, pair_apply_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv6_wkv  # noqa: E402
from repro_torch.kernels.sample_chunk import (  # noqa: E402
    sample_chunk,
    sample_chunk_ref,
)
from repro_torch.core import dense_to_csr, prng  # noqa: E402


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
@pytest.mark.parametrize("smem_cap", [200 * 1024, 0])
def test_pair_apply_kernel_top_level_on_card(cuda_device, smem_cap):
    """The top level of a hierarchy: one cell of 49 slots walked for 64
    ticks, a single lane a channel."""
    rng = np.random.default_rng(49)
    B, C, V, T = 1, 49, 2, 64
    x = rng.normal(size=(B, C, V)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (x, *_schedule(rng, B, C, T))]
    before = pair_apply.launches
    got = pair_apply(*args, smem_cap=smem_cap)
    torch.cuda.synchronize()
    assert pair_apply.launches == before + 1
    want = pair_apply_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("smem_cap", [200 * 1024, 0])
@pytest.mark.parametrize("V,offset", [(1, 0), (3, 0), (2, 1)])
def test_pair_apply_kernel_channel_layouts_on_card(cuda_device, V, offset,
                                                   smem_cap):
    """One channel (a float a row), three (channel by channel), and two
    from a state that starts 4 bytes past an 8-byte boundary (which the
    kernel then walks channel by channel, not as float2 rows)."""
    rng = np.random.default_rng(V * 10 + offset)
    B, C, T = 777, 9, 50
    x = rng.normal(size=(B, C, V)).astype(np.float32)
    flat = torch.zeros(B * C * V + offset, device=cuda_device)
    xt = flat[offset:].view(B, C, V)
    xt.copy_(torch.from_numpy(x))
    sched = [torch.from_numpy(a).to(cuda_device)
             for a in _schedule(rng, B, C, T)]
    got = pair_apply(xt, *sched, smem_cap=smem_cap)
    want = pair_apply_ref(xt, *sched)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _random_csr(rng, B, C=9, D=5):
    """B padded random graphs (some of one node, some nodes of degree 0,
    hops 1..3) packed as CSR."""
    n_nodes = rng.integers(1, C + 1, B).astype(np.int32)
    degrees = np.zeros((B, C), np.int32)
    neighbors = np.full((B, C, D), -1, np.int32)
    for b in range(B):
        n = int(n_nodes[b])
        degrees[b, :n] = rng.integers(0, min(D, n - 1) + 1, n) if n > 1 else 0
        neighbors[b, :n] = rng.integers(0, n, (n, D))
    hops = rng.integers(1, 4, (B, C, D)).astype(np.int32)
    return dense_to_csr(neighbors, degrees, n_nodes, hops)


@pytest.mark.cuda
@pytest.mark.parametrize("loss_p", [None, 0.9])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("T", [1, 50, 64])
@pytest.mark.parametrize("B", [1, 2, 7, 4099])
def test_sample_chunk_kernel_bitwise_on_card(cuda_device, B, T, R, loss_p):
    """Every output of the kernel (pairs, update bits, the counts added
    into usage and msgs) equals the plain version's bitwise: odd and
    even B, one tick to a full chunk, a `done` freeze partly set."""
    rng = np.random.default_rng(B * 1000 + T * 10 + R)
    adj = _random_csr(rng, B).to_device(cuda_device)
    nflat = adj.nbr.shape[0]
    keys = prng.fold_in(torch.stack(
        [prng.PRNGKey(int(s), cuda_device)
         for s in rng.integers(0, 2**32, R)]), 3)
    done = torch.from_numpy(rng.uniform(size=(R, B)) < 0.3).to(cuda_device)
    usage = torch.from_numpy(
        rng.integers(0, 100, R * nflat).astype(np.int32)).to(cuda_device)
    msgs = torch.from_numpy(
        rng.integers(0, 100, (R, B)).astype(np.int32)).to(cuda_device)
    t0 = int(rng.integers(0, 2**20))
    got_u, got_m = usage.clone(), msgs.clone()
    before = sample_chunk.launches
    got = sample_chunk(t0, T, keys, adj, loss_p, done, got_u, got_m)
    torch.cuda.synchronize()
    assert sample_chunk.launches == before + 1
    want = sample_chunk_ref(t0, T, keys, adj, loss_p, done, usage, msgs)
    for a, b in zip((*got, got_u, got_m), (*want, usage, msgs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sample_chunk_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(0)
    adj = _random_csr(rng, 5).to_device(cuda_device)
    keys = prng.PRNGKey(0, cuda_device)[None]
    done = torch.zeros((1, 5), dtype=torch.bool, device=cuda_device)
    usage = torch.zeros(adj.nbr.shape[0], dtype=torch.int32,
                        device=cuda_device)
    msgs = torch.zeros((1, 5), dtype=torch.int32, device=cuda_device)
    before = sample_chunk.launches
    with pytest.raises(ValueError, match="msgs"):
        sample_chunk(0, 8, keys, adj, None, done, usage, msgs.long())
    with pytest.raises(ValueError, match="usage"):
        sample_chunk(0, 8, keys, adj, None, done, usage[:-1], msgs)
    with pytest.raises(ValueError, match="keys is on cpu"):
        sample_chunk(0, 8, keys.cpu(), adj, None, done, usage, msgs)
    assert sample_chunk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scenario", "cost", "both"])
@pytest.mark.parametrize("loss_p", [None, 0.9])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("T", [1, 49, 50, 63])
@pytest.mark.parametrize("B", [1, 2, 7, 4099])
def test_sample_chunk_kernel_scenario_bitwise_on_card(cuda_device, B, T, R,
                                                      loss_p, mode):
    """Under a scenario (a quarter of the slots churned, straggling,
    Byzantine and regional, the event ticks inside the chunk), a cost
    model (retransmissions over hops 1..3, congestion), or both, every
    output of the kernel equals the plain version's bitwise: pairs, bits,
    usage, msgs, retx and congestion pairs.  T=63 with odd B makes the
    straggler stream's size odd; T=49 and T=1 draw each tagged word from
    its own counter, even T two words a counter."""
    from repro_torch.core import CostModel, FailureCtx

    rng = np.random.default_rng(B * 1000 + T * 10 + R + 7)
    adj = _random_csr(rng, B).to_device(cuda_device)
    C = adj.degrees.shape[1]
    nflat = adj.nbr.shape[0]
    keys = prng.fold_in(torch.stack(
        [prng.PRNGKey(int(s), cuda_device)
         for s in rng.integers(0, 2**32, R)]), 2)
    done = torch.from_numpy(rng.uniform(size=(R, B)) < 0.2).to(cuda_device)
    t0 = int(rng.integers(0, 2**20))
    ctx = cost = None
    if mode != "cost":
        ctx = FailureCtx.from_masks(
            *[rng.uniform(size=(B, C)) < 0.25 for _ in range(4)],
            t0 + T // 2, t0 + T // 4, t0 + 3 * T // 4 + 1, 0.25,
            device=cuda_device)
    if mode != "scenario":
        cost = CostModel(retransmit_p=0.9, congestion_alpha=0.01)
    counts = {name: torch.from_numpy(rng.integers(0, 100, shape).astype(
        dtype)).to(cuda_device) for name, shape, dtype in (
            ("usage", R * nflat, np.int32), ("msgs", (R, B), np.int32),
            ("retx", (R, B), np.int32), ("congp", (R, B), np.float32))}
    got_c = {k: v.clone() for k, v in counts.items()}
    before = sample_chunk.launches
    got = sample_chunk(t0, T, keys, adj, loss_p, done, got_c["usage"],
                       got_c["msgs"], failure_ctx=ctx, cost=cost, hop_cap=3,
                       retx=got_c["retx"], congp=got_c["congp"])
    torch.cuda.synchronize()
    assert sample_chunk.launches == before + 1
    want = sample_chunk_ref(t0, T, keys, adj, loss_p, done, counts["usage"],
                            counts["msgs"], failure_ctx=ctx, cost=cost,
                            hop_cap=3, retx=counts["retx"],
                            congp=counts["congp"])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    for name in counts:
        assert torch.equal(got_c[name], counts[name]), name


def _permuted_csr(csr, rng):
    """The same graphs with each graph's run of edges moved to a random
    place in the flat arrays: a block's draws then fall outside its
    window of edges and take the kernel's global-atomic branch."""
    start, nbr, hops, degrees, n_nodes = (np.asarray(a) for a in csr)
    total = degrees.sum(1)
    first = start[:, 0]
    new_start = np.empty_like(start)
    runs_nbr, runs_hops, off = [], [], 0
    for b in rng.permutation(len(total)):
        new_start[b] = start[b] - first[b] + off
        runs_nbr.append(nbr[first[b]:first[b] + total[b]])
        runs_hops.append(hops[first[b]:first[b] + total[b]])
        off += total[b]
    return type(csr)(new_start, np.concatenate(runs_nbr + [[0]]).astype(
        np.int32), np.concatenate(runs_hops + [[1]]).astype(np.int32),
        degrees, n_nodes)


def _wide_csr(rng, B=3, C=130, D=60):
    """B graphs of C nodes each of degree D: 7800 edges a graph, more
    than the kernel's shared-memory window of a graph run."""
    neighbors = rng.integers(0, C, (B, C, D)).astype(np.int32)
    degrees = np.full((B, C), D, np.int32)
    n_nodes = np.full(B, C, np.int32)
    hops = rng.integers(1, 4, (B, C, D)).astype(np.int32)
    return dense_to_csr(neighbors, degrees, n_nodes, hops)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,B,T,R,mode,loss_p", [
    ("permuted", 300, 64, 2, "both", None),
    ("permuted", 300, 50, 2, "plain", 0.9),
    ("permuted", 4099, 49, 1, "both", 0.9),
    ("wide", 3, 50, 2, "both", None),
    ("wide", 3, 49, 1, "plain", 0.9),
    ("wide", 3, 64, 3, "cost", 0.9),
    ("wide", 3, 50, 140, "both", None),
    ("wide", 3, 64, 140, "plain", None),
    ("long", 300, 64, 2, "both", None),
    ("long", 77, 49, 3, "plain", 0.9),
    ("control", 485, 64, 260, "plain", None),
    ("control", 485, 64, 260, "both", None),
    ("tiles", 77, 130, 2, "plain", None),
    ("tiles", 77, 130, 2, "both", None),
])
def test_sample_chunk_kernel_layouts_on_card(cuda_device, layout, B, T, R,
                                             mode, loss_p):
    """A block counts usage in shared memory over each graph run's
    window of edges, [start[first, 0], start[end, 0]), and any other
    position in device memory.  Every output equals the plain version's
    bitwise where the graphs' edges are permuted (most outside the
    window), where a graph run has more edges than its window (R=140
    fills the card, so its blocks keep windows; at R <= 3 they keep
    none), at C=20, at a control-plane shape (R=260, B=485 graphs of at
    most 7 nodes, half the graphs frozen by `done`), and over T=130,
    more ticks than a block holds keys for at once."""
    from repro_torch.core import CostModel, FailureCtx

    rng = np.random.default_rng(B * 100 + T + R)
    if layout == "permuted":
        base = _random_csr(rng, B)
        csr = _permuted_csr(base, rng)
        assert not np.array_equal(csr.start, base.start)
    elif layout == "wide":
        csr = _wide_csr(rng)
        assert int(np.asarray(csr.degrees)[0].sum()) > 2048
        if R > 100:  # the first run's edges overflow its window
            from repro_torch.kernels.sample_chunk.ops import (_sms,
                                                              launch_shape)
            shape = launch_shape(T, R, B, 130, csr.nbr.shape[0],
                                 _sms(cuda_device.index or 0),
                                 0 if mode == "plain" else 1)
            run0 = int(np.asarray(csr.degrees)[:shape.G].sum())
            assert 0 < shape.window < run0
    elif layout in ("long", "tiles"):
        csr = _random_csr(rng, B, C=20 if layout == "long" else 9, D=6)
    else:
        csr = _random_csr(rng, B, C=7, D=6)
    adj = csr.to_device(cuda_device)
    C = adj.degrees.shape[1]
    nflat = adj.nbr.shape[0]
    keys = prng.fold_in(torch.stack(
        [prng.PRNGKey(int(s), cuda_device)
         for s in rng.integers(0, 2**32, R)]), 1)
    frozen = 0.5 if layout == "control" else 0.2
    done = torch.from_numpy(rng.uniform(size=(R, B)) < frozen).to(
        cuda_device)
    t0 = int(rng.integers(0, 2**20))
    ctx = cost = None
    if mode == "both":
        ctx = FailureCtx.from_masks(
            *[rng.uniform(size=(B, C)) < 0.25 for _ in range(4)],
            t0 + T // 2, t0 + T // 4, t0 + 3 * T // 4 + 1, 0.25,
            device=cuda_device)
    if mode != "plain":
        cost = CostModel(retransmit_p=0.9, congestion_alpha=0.01)
    counts = {name: torch.from_numpy(rng.integers(0, 100, shape).astype(
        dtype)).to(cuda_device) for name, shape, dtype in (
            ("usage", R * nflat, np.int32), ("msgs", (R, B), np.int32),
            ("retx", (R, B), np.int32), ("congp", (R, B), np.float32))}
    got_c = {k: v.clone() for k, v in counts.items()}
    kw = dict(failure_ctx=ctx, cost=cost, hop_cap=3)
    before = sample_chunk.launches
    got = sample_chunk(t0, T, keys, adj, loss_p, done, got_c["usage"],
                       got_c["msgs"], retx=got_c["retx"],
                       congp=got_c["congp"], **kw)
    torch.cuda.synchronize()
    assert sample_chunk.launches == before + 1
    want = sample_chunk_ref(t0, T, keys, adj, loss_p, done, counts["usage"],
                            counts["msgs"], retx=counts["retx"],
                            congp=counts["congp"], **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    for name in counts:
        assert torch.equal(got_c[name], counts[name]), name


@pytest.mark.cuda
def test_sample_chunk_kernel_scenario_refusals(cuda_device):
    from repro_torch.core import CostModel, FailureCtx

    rng = np.random.default_rng(1)
    adj = _random_csr(rng, 5).to_device(cuda_device)
    keys = prng.PRNGKey(0, cuda_device)[None]
    done = torch.zeros((1, 5), dtype=torch.bool, device=cuda_device)
    usage = torch.zeros(adj.nbr.shape[0], dtype=torch.int32,
                        device=cuda_device)
    msgs = torch.zeros((1, 5), dtype=torch.int32, device=cuda_device)
    retx = torch.zeros((1, 5), dtype=torch.int32, device=cuda_device)
    cost = CostModel(retransmit_p=0.9)
    ctx = FailureCtx.from_masks(*[np.zeros((5, 9), bool)] * 4, 0, 0, 0, 0.25,
                                device=cuda_device)
    before = sample_chunk.launches
    with pytest.raises(ValueError, match="retx is needed"):
        sample_chunk(0, 8, keys, adj, None, done, usage, msgs, cost=cost)
    with pytest.raises(ValueError, match="congp is needed"):
        sample_chunk(0, 8, keys, adj, None, done, usage, msgs,
                     cost=CostModel(congestion_alpha=0.1))
    with pytest.raises(ValueError, match="failure_ctx.bits"):
        sample_chunk(0, 8, keys, adj, None, done, usage, msgs,
                     failure_ctx=ctx._replace(bits=ctx.bits.bool()))
    with pytest.raises(ValueError, match="2\\*\\*32 - 1"):
        sample_chunk(0, 8, keys, adj, None, done, usage, msgs, cost=cost,
                     hop_cap=2**26, retx=retx)
    with pytest.raises(ValueError, match="rounds q"):
        sample_chunk(0, 8, keys, adj, None, done, usage, msgs,
                     cost=CostModel(retransmit_p=1e-9), retx=retx)
    with pytest.raises(ValueError, match="hop_cap"):
        sample_chunk(0, 8, keys, adj, None, done, usage, msgs, cost=cost,
                     hop_cap=0, retx=retx)
    assert sample_chunk.launches == before


# cell_mixing: a warp a cell for m <= 32 (8, 16 or 32 rows a warp, 16-byte
# W loads where m is 8, 16 or 32), a block a cell above (W in shared
# memory up to m=130 at these widths, from device memory at m=300); B=13
# is not a multiple of the 8 cells of a warp-path block
@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [0, 1, 8])
@pytest.mark.parametrize("d", [1, 2, 33])
@pytest.mark.parametrize("m", [1, 8, 9, 15, 16, 32, 33, 49, 300])
def test_cell_mixing_kernel_on_card(cuda_device, m, d, rounds):
    rng = np.random.default_rng(m + d)
    w = torch.from_numpy(_random_mixing(rng, 13, m)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(13, m, d)).astype(np.float32)).to(
        cuda_device)
    before = cell_mixing.launches
    got = cell_mixing(w, x, rounds=rounds)
    torch.cuda.synchronize()
    assert cell_mixing.launches == before + 1
    torch.testing.assert_close(got, cell_mixing_ref(w, x, rounds=rounds),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.sum(1), x.sum(1), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [15, 49])
def test_cell_mixing_kernel_takes_numpy_rounds_on_card(cuda_device, m):
    """`rounds` as a numpy integer, as a caller holding a schedule in
    numpy passes it, on both kernel paths."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy(_random_mixing(rng, 9, m)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(9, m, 2)).astype(np.float32)).to(
        cuda_device)
    got = cell_mixing(w, x, rounds=np.int64(3))
    torch.testing.assert_close(got, cell_mixing_ref(w, x, rounds=3),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cell_mixing_launch_entry_refuses_bad_arguments(cuda_device):
    """The extension module's launch entry takes ten integers that fit
    its C types and raises, launching nothing, on anything else."""
    from repro_torch.kernels.cell_mixing.ops import _lib

    launch = _lib()
    w = torch.zeros((1, 4, 4), device=cuda_device)
    x = torch.zeros((1, 4, 2), device=cuda_device)
    y = torch.full_like(x, 7.0)
    ptrs = (w.data_ptr(), x.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(TypeError, match="10 arguments"):
        launch(*ptrs)
    with pytest.raises(OverflowError):
        launch(*ptrs, 2**31, 4, 2, 1, 0, 0, stream)
    with pytest.raises(TypeError):
        launch(*ptrs, 1, 4, 2, 1.5, 0, 0, stream)
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())
    assert launch(*ptrs, 1, 4, 2, 1, 0, 0, stream) == 0
    torch.cuda.synchronize()
    assert bool((y == 0.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(15, 2), (30, 3), (49, 33)])
def test_cell_mixing_kernel_padded_layout_on_card(cuda_device, m, d):
    """pad_mixing's identity-padded layout (m to a multiple of 8, d of
    128): the padded rows stay zero and the live block equals the
    unpadded product."""
    rng = np.random.default_rng(m * d)
    w = torch.from_numpy(_random_mixing(rng, 21, m)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(21, m, d)).astype(np.float32)).to(
        cuda_device)
    wp, xp, dims = pad_mixing(w, x)
    assert dims == (m, d) and xp.shape[1] % 8 == 0 and xp.shape[2] == 128
    got = cell_mixing(wp.contiguous(), xp.contiguous(), rounds=8)
    torch.testing.assert_close(got, cell_mixing_ref(wp, xp, rounds=8),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[:, :m, :d], cell_mixing_ref(w, x, rounds=8),
                               rtol=1e-5, atol=1e-5)
    assert not got[:, m:].any() and not got[:, :, d:].any()


# rwkv6: allclose in the working type.  f32 sums run in another order
# than the plain version (3e-4, the reference kernel test's f32
# tolerance); in bf16 the output rounds to bf16, whose ulp is 2^-8 of
# the value (2e-2 rtol and atol).
_RWKV_TYPES = {"f32": (torch.float32, torch.float32, 3e-4),
               "bf16": (torch.bfloat16, torch.bfloat16, 2e-2),
               "mixed": (torch.bfloat16, torch.float32, 2e-2)}


# odd shapes, then every head size (each compiled with its one split of
# value columns and keys) at T below, at and past the 32-step chunk and
# with the last chunk's tail batch, for BH from one b*h to the prefill's
_RWKV_SHAPES = [(2, 64, 32), (1, 130, 64), (3, 96, 16), (5, 77, 64),
                (160, 300, 64)] + [(BH, T, N) for BH in (1, 7, 160)
                                   for T in (1, 31, 33, 1000)
                                   for N in (16, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "mixed"])
@pytest.mark.parametrize("BH,T,N", _RWKV_SHAPES)
def test_rwkv6_kernel_on_card(cuda_device, BH, T, N, kind):
    dt, wdt, tol = _RWKV_TYPES[kind]
    rng = np.random.default_rng(BH * T + N)
    arrays = [rng.normal(size=(BH, T, N)), rng.normal(size=(BH, T, N)) * 0.3,
              rng.normal(size=(BH, T, N)),
              rng.uniform(0.85, 0.999, size=(BH, T, N)),
              rng.normal(size=(BH, N)) * 0.2]
    r, k, v, w, u = (torch.from_numpy(a.astype(np.float32)).to(
        cuda_device, t) for a, t in zip(arrays, (dt, dt, dt, wdt, dt)))
    before = rwkv6_wkv.launches
    got = rwkv6_wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert rwkv6_wkv.launches == before + 1
    assert got.dtype == dt and got.shape == (BH, T, N)
    torch.testing.assert_close(got.float(), rwkv6_ref(r, k, v, w, u).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_rwkv6_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 8, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_wkv(x, x, x, x, torch.zeros((2, 48), device=cuda_device))
    y = torch.zeros((2, 16, 8), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_wkv(y, y, y, y, torch.zeros((2, 16), device=cuda_device))
    h = torch.zeros((2, 8, 16), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        rwkv6_wkv(h, h, h, h, torch.zeros((2, 16), device=cuda_device,
                                          dtype=torch.float16))
    b = torch.zeros(2 * 8 * 16 + 1, device=cuda_device)[1:].view(2, 8, 16)
    assert b.is_contiguous() and b.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_wkv(b, b, b, b, torch.zeros((2, 16), device=cuda_device))


# flash_attention: allclose to the plain version at the reference kernel
# tests' tolerances, f32 2e-5 and bf16 3e-2 (the kernel and the plain
# version sum in other orders; a bf16 output rounds to 2^-8 of itself).
# bf16 runs on the wgmma kernel, f32 on the FMA kernel: each case checks
# that its dtype's kernel, and only it, launched.
_FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype,opts", [
    (2, 4, 2, 256, 64, _BF16, {}),
    (1, 8, 1, 128, 128, _F32, {}),
    (1, 2, 2, 200, 64, _F32, {}),
    (1, 2, 2, 384, 64, _F32, {"window": 64}),
    (1, 2, 2, 384, 64, _F32, {"window": 128}),
    (1, 2, 2, 256, 64, _F32, {"softcap": 30.0}),
    (1, 2, 2, 256, 64, _F32, {"causal": False}),
    (1, 4, 4, 300, 256, _BF16, {}),
    (1, 24, 8, 1000, 128, _BF16, {}),
    (1, 8, 1, 128, 128, _BF16, {}),
    (1, 2, 2, 200, 64, _BF16, {}),
    (1, 2, 2, 384, 64, _BF16, {"window": 64}),
    (1, 2, 2, 384, 64, _BF16, {"window": 128}),
    (1, 2, 2, 256, 64, _BF16, {"softcap": 30.0}),
    (1, 2, 2, 256, 64, _BF16, {"causal": False}),
    (1, 4, 4, 300, 64, _BF16, {}),
    (1, 4, 2, 300, 128, _BF16, {"causal": False, "window": 100}),
    (2, 6, 2, 130, 128, _BF16, {}),
    (1, 2, 1, 64, 128, _BF16, {}),
    (2, 16, 1, 700, 256, _BF16, {"window": 256}),
    (2, 16, 1, 700, 256, _F32, {"window": 256}),
    (1, 8, 4, 600, 128, _BF16, {"window": 200, "softcap": 50.0}),
    (1, 8, 4, 600, 128, _F32, {"window": 200, "softcap": 50.0}),
    # the f32 kernel's tiles (`Tiles<D>` in csrc/flash_attention.cu):
    # query tiles of 256 / 128 / 64 rows and key tiles of 64 / 128 / 256
    # keys at D = 64 / 128 / 256, one row or key short of and past each;
    # GQA groups 1, 3 and 8
    (1, 2, 2, 255, 64, _F32, {}),
    (1, 2, 2, 257, 64, _F32, {}),
    (1, 2, 2, 63, 64, _F32, {}),
    (1, 2, 2, 65, 64, _F32, {}),
    (1, 3, 1, 127, 128, _F32, {}),
    (1, 3, 1, 129, 128, _F32, {}),
    (2, 8, 1, 257, 128, _F32, {}),
    (1, 2, 1, 63, 256, _F32, {}),
    (1, 2, 1, 65, 256, _F32, {}),
    (1, 2, 1, 255, 256, _F32, {}),
    (1, 6, 2, 257, 256, _F32, {}),
    (1, 4, 2, 300, 128, _F32, {"window": 50}),
    (1, 4, 2, 300, 128, _F32, {"window": 500}),
    (1, 4, 2, 300, 128, _F32, {"causal": False, "window": 100}),
    (1, 2, 1, 300, 256, _F32, {"causal": False, "window": 70}),
    (1, 4, 2, 260, 128, _F32, {"softcap": 50.0}),
    (1, 24, 8, 1000, 128, _F32, {}),
], ids=["gqa-bf16", "mqa-f32", "unaligned", "window64", "window128",
        "softcap", "noncausal", "d256", "llama-heads", "mqa-bf16",
        "unaligned-bf16", "window64-bf16", "window128-bf16", "softcap-bf16",
        "noncausal-bf16", "d64-bf16", "window-noncausal-bf16",
        "tile-tail-bf16", "short-bf16", "window-d256-mqa-bf16",
        "window-d256-mqa-f32", "window-softcap-bf16", "window-softcap-f32",
        "f32-d64-short-of-rows", "f32-d64-past-rows", "f32-d64-short-of-keys",
        "f32-d64-past-keys", "f32-d128-gqa3-short", "f32-d128-gqa3-past",
        "f32-d128-gqa8-past", "f32-d256-short-of-rows", "f32-d256-past-rows",
        "f32-d256-short-of-keys", "f32-d256-gqa3-past-keys",
        "f32-window-below-a-tile", "f32-window-past-sq",
        "f32-noncausal-window", "f32-d256-noncausal-window", "f32-softcap-d128",
        "f32-llama-heads"])
def test_flash_attention_kernel_on_card(cuda_device, B, Hq, Hkv, S, D, dtype,
                                        opts):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, h, S, D)).astype(
        np.float32)).to(cuda_device, dtype) for h in (Hq, Hkv, Hkv))
    before = flash_attention.launches
    by_kernel = dict(flash_attention.kernel_launches)
    got = flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    name = KERNELS[dtype]
    assert flash_attention.kernel_launches == {
        **by_kernel, name: by_kernel[name] + 1}
    assert got.dtype == dtype and got.shape == (B, Hq, S, D)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, **opts).float(),
                               rtol=tol, atol=tol)


_OTHER_LENGTHS = [(100, 300, {"causal": False}), (300, 100, {"causal": False}),
                  (257, 129, {}), (129, 300, {"window": 50})]
# the f32 kernel's tile edges with Sq != Sk: rows and keys one short of
# and past a tile at each D
_F32_EDGES = [(255, 65, 64, {}), (257, 63, 64, {"causal": False}),
              (127, 129, 128, {}), (129, 127, 128, {"causal": False,
                                                    "window": 60}),
              (63, 257, 256, {"causal": False}), (65, 255, 256,
                                                  {"window": 300})]


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,opts,dtype", [
    (Sq, Sk, 128, opts, dt) for dt in (_BF16, _F32)
    for Sq, Sk, opts in _OTHER_LENGTHS] + [
    (*edge, _F32) for edge in _F32_EDGES])
def test_flash_attention_kernel_other_key_lengths_on_card(cuda_device, Sq,
                                                          Sk, D, opts, dtype):
    """Sq != Sk: query i sees key j by index, keys past Sk are masked."""
    rng = np.random.default_rng(Sq * Sk)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda_device, dtype) for s in ((2, 4, Sq, D), (2, 2, Sk, D),
                                      (2, 2, Sk, D)))
    got = flash_attention(q, k, v, **opts)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, **opts).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 2, 16, 96), device=cuda_device)
    with pytest.raises(ValueError, match="head size"):
        flash_attention(x, x, x)
    h = torch.zeros((1, 2, 16, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(h, h, h)
    y = torch.zeros((1, 16, 2, 64), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(y, y, y)
    q = torch.zeros((1, 3, 16, 64), device=cuda_device)
    kv = torch.zeros((1, 2, 16, 64), device=cuda_device)
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, kv, kv)
    b = torch.zeros(2 * 16 * 64 + 1, device=cuda_device,
                    dtype=torch.bfloat16)[1:].view(1, 2, 16, 64)
    assert b.is_contiguous() and b.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(b, b, b)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="window"):
        flash_attention(kv, kv, kv, window=0)
    assert flash_attention.launches == before


# ------------------------------ training ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["rwkv6", "flash_attention", "cell_mixing",
                                "pair_apply"])
def test_kernel_ops_refuse_autograd_on_card(cuda_device, op):
    """Each forward-only kernel raises before its launch when a floating
    input asks for a gradient."""
    def grad(*shape):
        return torch.zeros(shape, device=cuda_device, requires_grad=True)
    i = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    u = torch.zeros((4, 2), dtype=torch.bool, device=cuda_device)
    calls = {
        "rwkv6": (rwkv6_wkv, lambda: rwkv6_wkv(
            *[grad(2, 8, 16) for _ in range(4)], grad(2, 16))),
        "flash_attention": (flash_attention, lambda: flash_attention(
            *[grad(1, 2, 8, 64) for _ in range(3)])),
        "cell_mixing": (cell_mixing, lambda: cell_mixing(grad(2, 3, 3),
                                                         grad(2, 3, 1))),
        "pair_apply": (pair_apply, lambda: pair_apply(grad(2, 3, 1), i, i,
                                                      u, u)),
    }
    fn, call = calls[op]
    before = fn.launches
    with pytest.raises(RuntimeError, match="forward only"):
        call()
    assert fn.launches == before


def _small_llama(dtype="float32"):
    import dataclasses

    from repro_torch.configs import get_config, reduce_config

    return dataclasses.replace(reduce_config(get_config("llama3.2-3b")),
                               dtype=dtype, vocab_size=256)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """Three sgdm steps of a small llama in f32 on the card and on the
    CPU from the same weights: losses at 1e-5, parameters at 1e-5; no
    kernel launches."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Transformer, param_dict
    from repro_torch.optim import sgdm
    from repro_torch.train import init_train_state, make_train_step

    cfg = _small_llama()
    card = param_dict(Transformer(cfg).init(seed=0, device=cuda_device))
    host = {k: v.to("cpu", copy=True) for k, v in card.items()}
    data = SyntheticLM(cfg.vocab_size, 32, 2, seed=1)
    before = (rwkv6_wkv.launches, flash_attention.launches)
    runs = {}
    for where, params in (("cuda", card), ("cpu", host)):
        state = init_train_state(params, sgdm())
        step = make_train_step(cfg, sgdm(), lambda s: 1e-2, device=where)
        losses = []
        for s in range(3):
            state, m = step(state, data.batch_at(s))
            losses.append(float(m["loss"]))
        runs[where] = (state, losses)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-5)
    for k in host:
        np.testing.assert_allclose(runs["cuda"][0]["params"][k].cpu().numpy(),
                                   runs["cpu"][0]["params"][k].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert (rwkv6_wkv.launches, flash_attention.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(strategy="allreduce"), dict(strategy="hierarchical"),
    dict(strategy="multiscale", rotation_period=3),
    dict(strategy="ring", rounds=(5,), compression="int8"),
    dict(strategy="multiscale", compression="topk",
         failures=dict(churn_fraction=0.25, seed=1),
         aggregation="survivor_weighted"),
    dict(strategy="multiscale", aggregation="trimmed_mean",
         failures=dict(byzantine_fraction=0.125, seed=2)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_execute_sync_on_card_matches_cpu(cuda_device, kw, dtype):
    """The sync on the card against the same code on the CPU: the fault
    masks bitwise; the mix within a rounding of the leaf's dtype (each
    replica mean sums in one fixed order on both)."""
    from repro_torch.dist import (
        SyncConfig, SyncFailureModel, build_sync_plan, execute_sync,
        replica_fault_masks,
    )

    kw = dict(kw)
    fm = kw.pop("failures", None)
    sync = SyncConfig(failures=fm and SyncFailureModel(**fm), **kw)
    plan = build_sync_plan(sync, 8)
    rng = np.random.default_rng(3)
    g = {"a": torch.tensor(rng.normal(size=(8, 300, 7)), dtype=dtype),
         "b": torch.tensor(rng.normal(size=(8, 33)), dtype=dtype)}
    res = {k: 0.1 * v for k, v in g.items()}
    for step in (0, 5):
        if plan.faulty:
            for x, y in zip(replica_fault_masks(plan.failures, 8, step,
                                                cuda_device),
                            replica_fault_masks(plan.failures, 8, step)):
                assert torch.equal(x.cpu(), y)
        cm, cr = execute_sync(plan, {k: v.to(cuda_device) for k, v in
                                     g.items()},
                              {k: v.to(cuda_device) for k, v in res.items()},
                              step)
        hm, hr = execute_sync(plan, g, res, step)
        rtol = 2.0**-8 if dtype == torch.bfloat16 else 1e-6
        for k in g:
            np.testing.assert_allclose(cm[k].cpu().float().numpy(),
                                       hm[k].float().numpy(), rtol=rtol,
                                       atol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("loss_p", [None, 0.8])
def test_per_tick_cuda_matches_ref_on_card(cuda_device, loss_p):
    """Per-tick backend "cuda" (one cell_mixing launch a chunk) against
    per-tick "ref" on the card: integer accounting bitwise, values at the
    matmul tolerance; per-tick "ref" bitwise to presampled "cuda"."""
    import repro_torch.core as P

    g = P.random_geometric_graph(500, seed=7)
    x0 = np.random.default_rng(3).normal(0, 1, 500)
    plan = P.build_plan(g, seed=0)
    kw = dict(eps=1e-3, fixed_ticks_scale=0.2, seeds=(0, 1), weighted=True,
              failures=None if loss_p is None else P.FailureModel(
                  loss_p=loss_p))
    runs = {}
    for backend, schedule in (("ref", "per_tick"), ("cuda", "per_tick"),
                              ("cuda", "presampled")):
        before = cell_mixing.launches
        runs[backend, schedule] = P.execute_plan(
            plan, x0, options=P.ExecOptions(backend=backend,
                                            schedule=schedule), **kw)
        runs[backend, schedule].mixing = cell_mixing.launches - before
    ref, cu, pre = (runs["ref", "per_tick"], runs["cuda", "per_tick"],
                    runs["cuda", "presampled"])
    for f in ("messages", "node_sends", "level_messages", "level_ticks"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(cu, f))
        np.testing.assert_array_equal(getattr(ref, f), getattr(pre, f))
    np.testing.assert_array_equal(ref.x_final.view(np.int32),
                                  pre.x_final.view(np.int32))
    np.testing.assert_allclose(cu.x_final, ref.x_final, rtol=1e-4, atol=2e-4)
    assert cu.mixing > 0 and ref.mixing == pre.mixing == 0


@pytest.mark.cuda
def test_control_plane_round_cuda_bitwise_to_ref(cuda_device):
    import repro_torch.core as P
    from repro_torch.serve import LOAD_FIELDS, ControlPlane

    R = 64
    rng = np.random.default_rng(0)
    loads = rng.uniform(0.0, 10.0, (R, len(LOAD_FIELDS)))
    scores = rng.uniform(0.0, 2.0, R)
    out = {}
    for backend in ("cuda", "ref"):
        cp = ControlPlane(R, seed=0, options=P.ExecOptions(backend=backend))
        before = (pair_apply.launches, sample_chunk.launches)
        out[backend] = cp.round(loads, scores, round_idx=1)
        out[backend + " launches"] = (pair_apply.launches - before[0],
                                      sample_chunk.launches - before[1])
    a, b = out["cuda"], out["ref"]
    for f in ("summary", "table", "level_messages", "level_ticks"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.messages, a.control_bytes) == (b.messages, b.control_bytes)
    launches = out["cuda launches"]
    assert launches[0] == launches[1] > 0 and out["ref launches"] == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b"])
def test_paged_decode_bitwise_to_dense_on_card(cuda_device, arch):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import (
        Transformer, decode_step, init_cache, init_paged_cache,
        paged_decode_step,
    )

    cfg = reduce_config(get_config(arch))
    model = Transformer(cfg).init(seed=3, device=cuda_device)
    B, ps, P = 4, 4, 6
    dense = init_cache(model, cfg, B, P * ps)
    paged = init_paged_cache(model, cfg, B, B * P, ps)
    page_map = torch.arange(B * P, device=cuda_device).reshape(B, P)
    live = torch.ones(B, dtype=torch.bool, device=cuda_device)
    toks = np.random.default_rng(4).integers(2, cfg.vocab_size, (B, P * ps))
    for t in range(P * ps):
        want, dense = decode_step(model, cfg, dense, toks[:, t])
        steps = torch.full((B,), t, dtype=torch.int32, device=cuda_device)
        got, paged = paged_decode_step(model, cfg, paged, toks[:, t],
                                       page_map, steps, live)
        assert torch.equal(got, want), t


# the local route of `attention()`: a recurrentgemma-like layer (MQA, head
# 256) and a gemma2-like one (GQA, softcap 50), each at a width of 256
# with a window of 64 over 300 tokens, on the card (the flash kernel of
# the dtype, once) against the same call on the CPU (the plain version)
_LOCAL_CFGS = {
    "mqa-d256": dict(num_heads=4, num_kv_heads=1, head_dim=256),
    "gqa-softcap": dict(num_heads=4, num_kv_heads=2, head_dim=128,
                        attn_logit_softcap=50.0, query_scale=0.1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [_BF16, _F32])
@pytest.mark.parametrize("layer", list(_LOCAL_CFGS))
def test_local_attention_route_on_card(cuda_device, layer, dtype):
    import dataclasses

    from repro_torch._tf32 import no_tf32
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.attention import attention, attn_params

    cfg = dataclasses.replace(
        reduce_config(get_config("gemma2-27b")), d_model=256, window=64,
        dtype=str(dtype).split(".")[-1],
        **{"attn_logit_softcap": None, **_LOCAL_CFGS[layer]})
    gen = torch.Generator().manual_seed(0)
    params = {k: (torch.randn(d.shape, generator=gen) * d.std()).to(dtype)
              for k, d in attn_params(cfg).items()}
    x = torch.randn((2, 300, cfg.d_model), generator=gen).to(dtype)
    with no_tf32():
        want = attention(params, cfg, x, kind="local")
        before = dict(flash_attention.kernel_launches)
        got = attention({k: v.to(cuda_device) for k, v in params.items()},
                        cfg, x.to(cuda_device), kind="local")
        torch.cuda.synchronize()
    name = KERNELS[dtype]
    assert flash_attention.kernel_launches == {**before,
                                               name: before[name] + 1}
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_recurrentgemma_paged_decode_bitwise_to_dense_on_card(cuda_device):
    """A reduced recurrentgemma (rglru and local blocks, window 16): the
    paged step through an identity page map of 16 positions, the
    window, is the dense step bit for bit, and no kernel launches."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import (
        Transformer, decode_step, init_cache, init_paged_cache,
        paged_decode_step,
    )

    cfg = reduce_config(get_config("recurrentgemma-9b"))
    model = Transformer(cfg).init(seed=3, device=cuda_device)
    B, ps, P = 4, 4, 4
    dense = init_cache(model, cfg, B, P * ps)
    paged = init_paged_cache(model, cfg, B, B * P, ps)
    page_map = torch.arange(B * P, device=cuda_device).reshape(B, P)
    live = torch.ones(B, dtype=torch.bool, device=cuda_device)
    toks = np.random.default_rng(4).integers(2, cfg.vocab_size, (B, P * ps))
    before = flash_attention.launches
    for t in range(P * ps):
        want, dense = decode_step(model, cfg, dense, toks[:, t])
        steps = torch.full((B,), t, dtype=torch.int32, device=cuda_device)
        got, paged = paged_decode_step(model, cfg, paged, toks[:, t],
                                       page_map, steps, live)
        assert torch.equal(got, want), t
    assert flash_attention.launches == before


# chunked_attention on the card (plain tensor code, no kernel): against
# full_attention with the same masks as a bias, f32 with TF32 off, at
# 2e-5; the gradients of q, k and v within 1e-4 of their largest element
@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,H,Hkv,causal,window,shift", [
    (300, 300, 6, 2, True, None, 5),        # self, shifted positions
    (300, 300, 4, 4, True, 64, 0),          # a window inside the chunks
    (70, 513, 6, 6, False, None, 0),        # cross over ragged chunks
])
def test_chunked_attention_on_card_matches_full(cuda_device, Sq, Sk, H, Hkv,
                                                causal, window, shift):
    from repro_torch._tf32 import no_tf32
    from repro_torch.models.attention import (
        _mask_bias, chunked_attention, full_attention)

    gen = torch.Generator(device=cuda_device).manual_seed(Sq + Sk)
    q = torch.randn((2, H, Sq, 64), generator=gen, device=cuda_device)
    k, v = (torch.randn((2, Hkv, Sk, 64), generator=gen, device=cuda_device)
            for _ in range(2))
    cot = torch.randn((2, H, Sq, 64), generator=gen, device=cuda_device)
    q_pos = (torch.arange(Sq, device=cuda_device) + shift)[None].expand(2, Sq)
    k_pos = torch.arange(Sk, device=cuda_device)[None].expand(2, Sk)
    kw = dict(softcap=None, scale=0.125)
    outs = []
    with no_tf32():
        for chunked in (True, False):
            leaves = [a.clone().requires_grad_() for a in (q, k, v)]
            if chunked:
                o = chunked_attention(*leaves, q_pos, k_pos, causal=causal,
                                      window=window, chunk=128, **kw)
            else:
                bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
                o = full_attention(*leaves, bias, **kw)
            outs.append((o.detach(), torch.autograd.grad((o * cot).sum(),
                                                         leaves)))
    (got, got_g), (want, want_g) = outs
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for g, w in zip(got_g, want_g):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _collectives_rank(rank, world):
    """CUDA tensors through the collective layer on a gloo group: every
    rank on cuda:0, the results and this rank's account."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import collectives as C

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("replica",))
    x = torch.arange(6, dtype=torch.float32, device=dev) + 10.0 * rank
    C.reset_account()
    swapped = C.ppermute(x, mesh, "replica", [(0, 1), (1, 0)])
    mean = C.pmean(x.to(torch.bfloat16), mesh, "replica")
    gathered = C.all_gather(x[None], mesh, "replica")
    zero = C.bcast_from_zero(x, mesh, "replica")
    devices = {t.device.type for t in (swapped, mean, gathered, zero)}
    return dict(swapped=swapped.cpu(), mean=mean.float().cpu(),
                gathered=gathered.cpu(), zero=zero.cpu(), devices=devices,
                account=C.account())


@pytest.mark.cuda
def test_collectives_move_cuda_tensors_over_gloo(cuda_device):
    from repro_torch.dist.ranks import run_ranks

    out = run_ranks(_collectives_rank, 2, backend="gloo", timeout=120)
    xs = [torch.arange(6, dtype=torch.float32) + 10.0 * r for r in range(2)]
    want_mean = ((xs[0].to(torch.bfloat16).float()
                  + xs[1].to(torch.bfloat16).float()) / 2).to(torch.bfloat16)
    for rank, res in enumerate(out):
        assert res["devices"] == {"cuda"}
        assert torch.equal(res["swapped"], xs[1 - rank])
        assert torch.equal(res["mean"], want_mean.float())
        assert torch.equal(res["gathered"], torch.stack(xs))
        assert torch.equal(res["zero"], xs[0])
        # p2p and gathers go through the host, counted both ways
        assert res["account"]["host_copy"]["calls"] >= 4
        assert res["account"]["ppermute"]["calls"] == 1
