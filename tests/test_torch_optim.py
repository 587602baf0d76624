"""The port's optimizers against the reference's on the same gradients.

f32 trees of a few shapes (a matrix, a vector, a 3-d leaf, a bf16
matrix), gradients drawn from a numpy seed, three updates each:
`update` (functional) allclose at 1e-6 to the reference; `update_` (in
place) bitwise equal to `update`; the replica-stacked update equal to
the reference's `jax.vmap` of it.  Also `global_norm`,
`clip_by_global_norm` and `cosine_schedule`.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.optim as R  # noqa: E402
import repro_torch.optim as T  # noqa: E402

TOL = 1e-6
OPTS = [("adamw", {}), ("adamw", {"weight_decay": 0.01}), ("sgdm", {}),
        ("sgdm", {"momentum": 0.5}), ("adafactor", {}),
        ("adafactor", {"momentum": True})]
SHAPES = {"w": (6, 5), "b": (7,), "t": (2, 3, 4)}


def _tree(rng, stack=()):
    return {k: rng.normal(size=stack + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("name,kw", OPTS)
def test_update_matches_reference(name, kw):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    ro, to = R.make_optimizer(name, **kw), T.make_optimizer(name, **kw)
    rp, tp = _jax(p0), _torch(p0)
    rs, ts = ro.init(rp), to.init(tp)
    for lr in (0.01, 0.003, 0.02):
        g = _tree(rng)
        ru, rs = ro.update(_jax(g), rs, rp, lr)
        tp_in, ts_in = {k: v.clone() for k, v in tp.items()}, copy.deepcopy(ts)
        tu, ts = to.update(_torch(g), ts, tp, lr)
        to.update_(_torch(g), ts_in, tp_in, lr)
        rp, tp = R.apply_updates(rp, ru), T.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ru[k]),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       rtol=TOL, atol=TOL)
            assert torch.equal(tp_in[k], tp[k]), k
    assert int(ts["count"]) == 3 and int(ts_in["count"]) == 3


@pytest.mark.parametrize("name,kw", OPTS)
def test_stacked_update_matches_vmapped_reference(name, kw):
    rng = np.random.default_rng(1)
    Rn = 3
    p0 = _tree(rng, (Rn,))
    ro, to = R.make_optimizer(name, **kw), T.make_optimizer(name, **kw)
    rp, tp = _jax(p0), _torch(p0)
    rs, ts = jax.vmap(ro.init)(rp), to.init(tp, stacked=True)
    assert tuple(ts["count"].shape) == (Rn,)
    for _ in range(2):
        g = _tree(rng, (Rn,))
        ru, rs = jax.vmap(lambda g_, s_, p_: ro.update(g_, s_, p_, 0.01))(
            _jax(g), rs, rp)
        rp = R.apply_updates(rp, ru)
        to.update_(_torch(g), ts, tp, 0.01, stacked=True)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ts["count"].numpy(), np.asarray(rs["count"]))


def test_bf16_parameters_update_in_bf16():
    """A bf16 parameter takes its f32 update rounded to bf16, as the
    reference's `p + u.astype(p.dtype)`; the moments stay f32."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=(8, 4)).astype(np.float32)
    g = rng.normal(size=(8, 4)).astype(np.float32)
    ro, to = R.adamw(weight_decay=0.01), T.adamw(weight_decay=0.01)
    rp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.tensor(p).to(torch.bfloat16)}
    rs, ts = ro.init(rp), to.init(tp)
    assert ts["m"]["w"].dtype == torch.float32
    ru, rs = ro.update({"w": jnp.asarray(g, jnp.bfloat16)}, rs, rp, 0.01)
    to.update_({"w": torch.tensor(g).to(torch.bfloat16)}, ts, tp, 0.01)
    want = np.asarray(R.apply_updates(rp, ru)["w"].astype(jnp.float32))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["w"].float().numpy(), want, rtol=2**-8,
                               atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    rng = np.random.default_rng(3)
    g = _tree(rng)
    rc, rn = R.clip_by_global_norm(_jax(g), max_norm)
    tc, tn = T.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(rn), rtol=TOL)
    np.testing.assert_allclose(float(T.global_norm(_torch(g))),
                               float(R.global_norm(_jax(g))), rtol=TOL)
    inplace = _torch(g)
    T.clip_by_global_norm(inplace, max_norm, inplace=True)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]),
                                   rtol=TOL, atol=TOL)
        assert torch.equal(inplace[k], tc[k])


def test_global_norm_in_pieces(monkeypatch):
    """A leaf above the piece size sums its squares piece by piece."""
    from repro_torch.optim import optimizers

    x = torch.tensor(np.random.default_rng(4).normal(size=(50, 7)),
                     dtype=torch.float32)
    whole = T.global_norm({"x": x})
    monkeypatch.setattr(optimizers, "_NORM_PIECE", 64)
    np.testing.assert_allclose(float(T.global_norm({"x": x})), float(whole),
                               rtol=1e-6)


@pytest.mark.parametrize("base,warmup,total", [(1e-3, 10, 100),
                                               (3e-4, 0, 50), (0.1, 5, 5)])
def test_cosine_schedule_matches_reference(base, warmup, total):
    ref = R.cosine_schedule(base, warmup, total)
    port = T.cosine_schedule(base, warmup, total)
    for step in range(0, total + 20):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=TOL,
                                   atol=1e-12)
    assert port(0) == 0.0 or warmup == 0


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        T.make_optimizer("lion")
