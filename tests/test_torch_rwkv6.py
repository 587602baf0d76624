"""The port's plain rwkv6 wkv (`rwkv6_ref`, and `rwkv6_wkv` on CPU
tensors) against the reference's oracle and its Pallas kernel in
interpret mode, on the same inputs.  The CUDA kernel is held against the
plain version on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6 import rwkv6_ref as rwkv6_ref_jax  # noqa: E402
from repro.kernels.rwkv6 import rwkv6_wkv as rwkv6_wkv_jax  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv6_wkv  # noqa: E402

# the reference's own tolerances (tests/test_kernels.py): f32 vs bf16
# working type; "mixed" is the model's call, bf16 r/k/v/u with f32 w
TOL = {"f32": 3e-4, "bf16": 5e-2, "mixed": 5e-2}
_TYPES = {"f32": (np.float32, np.float32), "bf16": ("bf16", "bf16"),
          "mixed": ("bf16", np.float32)}


def _inputs(BH, T, N, kind, seed=None):
    rng = np.random.default_rng(BH * T if seed is None else seed)
    arrays = [rng.normal(size=(BH, T, N)),
              rng.normal(size=(BH, T, N)) * 0.3,
              rng.normal(size=(BH, T, N)),
              rng.uniform(0.85, 0.999, size=(BH, T, N)),
              rng.normal(size=(BH, N)) * 0.2]
    work, wdt = _TYPES[kind]
    types = [work, work, work, wdt, work]
    jax_args = [jnp.asarray(a, jnp.bfloat16 if t == "bf16" else t)
                for a, t in zip(arrays, types)]
    torch_args = [torch.from_numpy(np.array(j, np.float32)).to(
        torch.bfloat16 if t == "bf16" else torch.float32)
        for j, t in zip(jax_args, types)]
    return jax_args, torch_args


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("BH,T,N", [(2, 64, 32), (1, 130, 64), (3, 96, 16)])
@pytest.mark.parametrize("kind", ["f32", "bf16", "mixed"])
def test_rwkv6_wkv_matches_reference_oracle(BH, T, N, kind):
    jargs, targs = _inputs(BH, T, N, kind)
    got = rwkv6_wkv(*targs)
    assert got.dtype == targs[0].dtype and got.shape == (BH, T, N)
    _close(got, rwkv6_ref_jax(*jargs), TOL[kind])


@pytest.mark.parametrize("BH,T,N", [(2, 64, 32), (1, 130, 64), (3, 96, 16)])
@pytest.mark.parametrize("kind", ["f32", "bf16", "mixed"])
def test_rwkv6_wkv_matches_reference_pallas_interpret(BH, T, N, kind):
    """What the card computes: the reference's kernel (padded to its time
    blocks) in interpret mode."""
    jargs, targs = _inputs(BH, T, N, kind)
    want = rwkv6_wkv_jax(*jargs, block_t=64, use_pallas=True, interpret=True)
    _close(rwkv6_wkv(*targs), want, TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "mixed"])
def test_rwkv6_ref_state_matches_reference(kind):
    """s0 in, final state out: the chunk interface both ops build on."""
    BH, T, N = 3, 40, 16
    jargs, targs = _inputs(BH, T, N, kind, seed=5)
    s0 = np.random.default_rng(6).normal(size=(BH, N, N)).astype(np.float32)
    want, want_s = rwkv6_ref_jax(*jargs, s0=jnp.asarray(s0), return_state=True)
    got, got_s = rwkv6_ref(*targs, s0=torch.from_numpy(s0), return_state=True)
    assert got_s.dtype == torch.float32
    _close(got, want, TOL[kind])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("kind", ["f32", "mixed"])
def test_rwkv6_wkv_chunked_matches_reference_chunked(kind):
    """The reference op runs T=512 as two 256-step chunks; the port's one
    pass must give the same output."""
    jargs, targs = _inputs(2, 512, 16, kind, seed=7)
    want = rwkv6_wkv_jax(*jargs, use_pallas=False)
    _close(rwkv6_wkv(*targs), want, TOL[kind])


def test_rwkv6_state_streaming_across_chunks():
    """Splitting T into chunks, each started from the last one's state,
    must not reset the state (the reference's one-block vs four-block
    check), and gives the op's one pass exactly."""
    _, targs = _inputs(1, 128, 32, "f32", seed=21)
    r, k, v, w, u = targs
    s, outs = None, []
    for t0 in range(0, 128, 32):
        part = slice(t0, t0 + 32)
        out, s = rwkv6_ref(r[:, part], k[:, part], v[:, part], w[:, part], u,
                           s0=s, return_state=True)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, 1), rwkv6_wkv(*targs),
                               rtol=0, atol=0)


def test_rwkv6_wkv_rejects_other_devices():
    x = torch.zeros((2, 8, 16), device="meta")
    u = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError):
        rwkv6_wkv(x, x, x, x, u)
    cpu = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError):
        rwkv6_wkv(cpu, cpu, cpu, x, torch.zeros((2, 16)))
    assert rwkv6_wkv.launches == 0
