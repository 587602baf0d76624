"""The port's flash-attention op on CPU tensors (its plain version,
`attention_ref`) against the reference's oracle and its Pallas kernel in
interpret mode, on the same inputs, at the shapes and options of the
reference's own kernel tests.  The CUDA kernel is held against the plain
version on the card by tests/test_torch_cuda.py; the op's route and
checks, which need no card, are tested here on CPU tensors.

Tolerances are the reference kernel tests': f32 2e-5, bf16 3e-2 (rtol
and atol).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as attention_ref_jax  # noqa: E402
from repro.kernels.flash_attention import flash_attention as flash_jax  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._build import SOURCES  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import KERNELS, _check_cuda, kernel_for  # noqa: E402

TOL = {"f32": 2e-5, "bf16": 3e-2}
_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, Hq, Hkv, S, D, kind, seed):
    """q, k, v drawn with numpy, rounded to the working type once, handed
    to both packages."""
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))
    jax_args = [jnp.asarray(rng.normal(size=s), _JNP[kind]) for s in shapes]
    torch_args = [torch.from_numpy(np.array(a, np.float32)).to(_TORCH[kind])
                  for a in jax_args]
    return jax_args, torch_args


def _check(B, Hq, Hkv, S, D, kind, seed, **opts):
    jargs, targs = _inputs(B, Hq, Hkv, S, D, kind, seed)
    before = flash_attention.launches
    got = flash_attention(*targs, **opts)
    assert flash_attention.launches == before  # the CPU runs no kernel
    assert got.dtype == _TORCH[kind] and got.shape == (B, Hq, S, D)
    got = got.float().numpy()
    tol = TOL[kind]
    oracle = attention_ref_jax(*jargs, **opts)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                               rtol=tol, atol=tol)
    pallas = flash_jax(*jargs, **opts, block_q=128, block_k=128,
                       use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64),
                                          (1, 8, 1, 128, 128)])
def test_causal_matches_reference(B, Hq, Hkv, S, D, kind):
    _check(B, Hq, Hkv, S, D, kind, seed=S + Hq, causal=True)


@pytest.mark.parametrize("window", [64, 128])
def test_sliding_window_matches_reference(window):
    _check(1, 2, 2, 384, 64, "f32", seed=window, causal=True, window=window)


def test_softcap_matches_reference():
    _check(1, 2, 2, 256, 64, "f32", seed=9, causal=True, softcap=30.0)


def test_unaligned_sequence_matches_reference():
    _check(1, 2, 2, 200, 64, "f32", seed=11, causal=True)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_noncausal_matches_reference(kind):
    _check(1, 2, 2, 256, 64, kind, seed=13, causal=False)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_gqa_groups_match_reference(group):
    _check(2, 8, 8 // group, 200, 64, "f32", seed=group, causal=True)


def test_scale_and_window_without_causal_match_reference():
    _check(1, 4, 2, 300, 128, "f32", seed=17, causal=False, window=100,
           scale=0.05)


@pytest.mark.parametrize("S,D", [(255, 64), (257, 64), (127, 128),
                                 (129, 128), (63, 256), (65, 256),
                                 (257, 256)])
def test_f32_tile_edges_match_reference(S, D):
    """One row or key short of and past the f32 kernel's query and key
    tiles (`Tiles<D>` in csrc/flash_attention.cu: 256 / 128 / 64 rows,
    64 / 128 / 256 keys at D = 64 / 128 / 256): the plain version that
    the card tests hold the kernel to, against the reference there."""
    _check(1, 2, 1, S, D, "f32", seed=S + D, causal=True)


def test_attention_ref_is_the_plain_softmax():
    """The plain version by hand: one head, every row's softmax over the
    keys it may see."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 1, 5, 4)).astype(
        np.float32)) for _ in range(3))
    got = attention_ref(q, k, v, causal=True, window=2)
    s = (q[0, 0] @ k[0, 0].T) / 2.0
    for i in range(5):
        keep = [j for j in range(5) if i - 2 < j <= i]
        p = torch.softmax(s[i, keep], 0)
        torch.testing.assert_close(got[0, 0, i], p @ v[0, 0, keep])


def test_op_rejects_other_devices():
    q = torch.zeros((1, 2, 8, 64), device="meta")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(torch.zeros((1, 2, 8, 64)), q, q)
    assert flash_attention.launches == before


# The op's route and its checks, on CPU tensors: what the CUDA route
# would launch, and what it refuses before any launch.

def test_route_takes_one_kernel_per_dtype():
    assert kernel_for("cpu", torch.bfloat16) is None
    assert kernel_for("cpu", torch.float32) is None
    assert kernel_for("cuda", torch.bfloat16) == "flash_attention_sm90"
    assert kernel_for("cuda", torch.float32) == "flash_attention"
    assert set(flash_attention.kernel_launches) == set(KERNELS.values())
    assert set(KERNELS.values()) <= set(SOURCES)


@pytest.mark.parametrize("device,dtype,match", [
    ("cuda", torch.float16, "dtype"),
    ("cuda", torch.float64, "dtype"),
    ("meta", torch.bfloat16, "cpu or cuda"),
])
def test_route_refuses_what_no_kernel_takes(device, dtype, match):
    with pytest.raises(ValueError, match=match):
        kernel_for(device, dtype)


def test_every_kernel_source_is_in_the_tree():
    csrc = Path(_build.__file__).resolve().parent.parent / "csrc"
    for name in SOURCES:
        assert (csrc / f"{name}.cu").is_file(), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [
    (1, 2, 2, 200, 200, 64), (4, 24, 8, 130, 130, 128),
    (1, 4, 4, 300, 300, 256), (2, 3, 1, 64, 97, 128)])
def test_checks_accept_what_the_kernels_take(B, Hq, Hkv, Sq, Sk, D, dtype):
    q = torch.zeros((B, Hq, Sq, D), dtype=dtype)
    k = torch.zeros((B, Hkv, Sk, D), dtype=dtype)
    _check_cuda(q, k, k.clone(), window=None, softcap=None)
    _check_cuda(q, k, k, window=64, softcap=30.0)


def _misaligned(shape, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("case,match", [
    ("head size 96", "head size"),
    ("3-d", r"\(B, H, S, D\)"),
    ("v shape", "k and v"),
    ("batch", "k and v"),
    ("groups", "group"),
    ("mixed dtype", "dtype"),
    ("float16", "dtype"),
    ("not contiguous", "contiguous"),
    ("misaligned q", "16-byte"),
    ("misaligned v", "16-byte"),
    ("window 0", "window"),
    ("softcap 0", "softcap"),
    ("softcap negative", "softcap"),
])
def test_checks_refuse_what_the_kernels_do_not_take(case, match):
    q = torch.zeros((1, 4, 16, 64), dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16)
    args = {"q": q, "k": kv, "v": kv, "window": None, "softcap": None}
    if case == "head size 96":
        args.update(q=torch.zeros((1, 4, 16, 96), dtype=torch.bfloat16),
                    k=torch.zeros((1, 2, 16, 96), dtype=torch.bfloat16),
                    v=torch.zeros((1, 2, 16, 96), dtype=torch.bfloat16))
    elif case == "3-d":
        args.update(q=q[0])
    elif case == "v shape":
        args.update(v=torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16))
    elif case == "batch":
        args.update(k=torch.zeros((2, 2, 16, 64), dtype=torch.bfloat16),
                    v=torch.zeros((2, 2, 16, 64), dtype=torch.bfloat16))
    elif case == "groups":
        args.update(k=torch.zeros((1, 3, 16, 64), dtype=torch.bfloat16),
                    v=torch.zeros((1, 3, 16, 64), dtype=torch.bfloat16))
    elif case == "mixed dtype":
        args.update(k=kv.float())
    elif case == "float16":
        args.update(q=q.half(), k=kv.half(), v=kv.half())
    elif case == "not contiguous":
        args.update(q=torch.zeros((1, 16, 4, 64),
                                  dtype=torch.bfloat16).transpose(1, 2))
    elif case == "misaligned q":
        args.update(q=_misaligned((1, 4, 16, 64)))
        assert args["q"].is_contiguous() and args["q"].data_ptr() % 16
    elif case == "misaligned v":
        args.update(v=_misaligned((1, 2, 16, 64)))
    elif case == "window 0":
        args.update(window=0)
    elif case == "softcap 0":
        args.update(softcap=0.0)
    elif case == "softcap negative":
        args.update(softcap=-1.0)
    with pytest.raises(ValueError, match=match):
        _check_cuda(**args)


def test_cpu_route_counts_no_launch():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    before = dict(flash_attention.kernel_launches)
    total = flash_attention.launches
    flash_attention(q, q, q)
    assert flash_attention.kernel_launches == before
    assert flash_attention.launches == total
