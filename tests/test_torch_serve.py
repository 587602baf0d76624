"""The port's serving fleet (`repro_torch.serve`: the page table, the
paged decode step, continuous batching, the gossip control plane, the
routers and the fleet simulation) against the reference's, on the CPU.

Models run at `reduce_config` size (2 layers, d 64, vocab 512) on the
reference's initialised parameters (`params_from_reference`).
Tolerances, as `tests/test_torch_models.py` sets them out: f32 logits
and caches at 1e-5; bf16 held to the reference's own bf16-vs-f32 error
(the mean and the largest element at most 1.5x, each row at most 2.5x).
Paged and dense decode in the port are bitwise equal with an identity
page map.  The control plane and the fleet run the reference inside
``jax.threefry_partitionable(False)``, the port's threefry layout, and
are held bitwise; the R=16 fleet also to the recorded
`BENCH_serve.json` entry.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.serve as ref_serve  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import ExecOptions  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Transformer,
    cache_from_reference,
    decode_step,
    init_cache,
    init_paged_cache,
    paged_decode_step,
    params_from_reference,
)
from repro_torch.serve import (  # noqa: E402
    LOAD_FIELDS,
    ROUTERS,
    BatchingEngine,
    ControlPlane,
    FleetConfig,
    ModelBackend,
    PageTable,
    SimBackend,
    run_fleet,
)

F32_TOL = 1e-5
BF16_MEAN_RATIO = 1.5
BF16_MAX_RATIO = 1.5
BF16_ROW_RATIO = 2.5
CPU = ExecOptions(backend="ref", device="cpu")
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(arch, dtype):
    ref = dataclasses.replace(
        ref_configs.reduce_config(ref_configs.get_config(arch)), dtype=dtype)
    port = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    return ref, port


def _params(ref_cfg, port_cfg, seed):
    ref = ref_models.Transformer(ref_cfg, model_axis=1).init(
        jax.random.PRNGKey(seed))
    port = params_from_reference(jax.tree.map(np.asarray, ref), port_cfg,
                                 device="cpu")
    return ref, port


def _assert_bf16_close(port, ref16, ref32):
    port, ref16, ref32 = (np.asarray(a, np.float32)
                          for a in (port, ref16, ref32))
    port_err, ref_err = np.abs(port - ref32), np.abs(ref16 - ref32)
    assert port_err.mean() <= BF16_MEAN_RATIO * ref_err.mean(), (
        port_err.mean(), ref_err.mean())
    assert port_err.max() <= BF16_MAX_RATIO * ref_err.max(), (
        port_err.max(), ref_err.max())
    rows = port.shape[0] * port.shape[1]
    port_rows = port_err.reshape(rows, -1).mean(1)
    ref_rows = ref_err.reshape(rows, -1).mean(1)
    assert (port_rows <= BF16_ROW_RATIO * ref_rows).all(), (
        port_rows / ref_rows).max()


# ------------------------------ page table ------------------------------


def test_page_table_matches_reference():
    """A random alloc / free trace: page maps, free counts and every
    refusal equal the reference allocator's at each step."""
    kw = dict(num_pages=20, page_size=4, num_slots=5, pages_per_slot=6)
    mine, ref = PageTable(**kw), ref_serve.PageTable(**kw)
    rng = np.random.default_rng(0)
    for _ in range(300):
        slot = int(rng.integers(5))
        if rng.random() < 0.6:
            n = int(rng.integers(1, 30))
            assert mine.can_alloc(n) == ref.can_alloc(n)
            outcome = []
            for t in (mine, ref):
                try:
                    t.alloc(slot, n)
                    outcome.append(None)
                except ValueError as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1]
        else:
            assert mine.free(slot) == ref.free(slot)
        np.testing.assert_array_equal(mine.page_map, ref.page_map)
        assert mine.page_map.dtype == ref.page_map.dtype == np.int32
        assert (mine.free_pages, mine.used_pages, mine.utilization) == (
            ref.free_pages, ref.used_pages, ref.utilization)
        assert [mine.slot_pages(s) for s in range(5)] == [
            ref.slot_pages(s) for s in range(5)]
    with pytest.raises(ValueError):
        PageTable(num_pages=0, page_size=4, num_slots=1, pages_per_slot=1)


# --------------------------- paged decode step ---------------------------

# three slots that start at iterations 0, 2 and 5 through scattered
# pages; the trash page stands where a slot holds no page
_STARTS = np.array([0, 2, 5])
_PS, _NUM_PAGES, _ITERS = 4, 10, 12


def _page_map():
    T = _NUM_PAGES
    return np.array([[3, 7, 1, T], [0, 9, 4, 2], [8, 5, T, T]], np.int32)


def _trace(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (_ITERS, 3)).astype(np.int32)
    for it in range(_ITERS):
        live = it >= _STARTS
        steps = np.where(live, it - _STARTS, 0).astype(np.int32)
        yield toks[it], steps, live


def _ref_paged(ref_cfg, ref_p, seed):
    cache = ref_models.init_paged_cache(ref_cfg, 3, _NUM_PAGES, _PS)
    step = jax.jit(lambda p, c, t, m, s, w: ref_models.paged_decode_step(
        p, ref_cfg, c, t, m, s, w))
    pm = jnp.asarray(_page_map())
    out = []
    for tok, steps, live in _trace(ref_cfg, seed):
        logits, cache = step(ref_p, cache, jnp.asarray(tok), pm,
                             jnp.asarray(steps), jnp.asarray(live))
        out.append(np.asarray(logits, np.float32))
    return np.stack(out), cache


def _port_paged(cfg, port_p, seed):
    cache = init_paged_cache(port_p, cfg, 3, _NUM_PAGES, _PS)
    out = []
    for tok, steps, live in _trace(cfg, seed):
        logits, cache = paged_decode_step(port_p, cfg, cache, tok,
                                          _page_map(), steps, live)
        assert logits.shape == (3, cfg.vocab_size)
        assert logits.dtype == torch.float32
        out.append(logits.float().numpy())
    return np.stack(out), cache


def _ref_layers(cache, cfg):
    """The reference's stacked paged cache as the port's per-layer list,
    the trash page left out (its writes race by design)."""
    conv = cache_from_reference(
        {"groups": jax.tree.map(np.asarray, cache["groups"]), "step": 0},
        cfg, device="cpu")["layers"]
    return [_no_trash(layer) for layer in conv]


def _no_trash(layer):
    return {k: (v[:-1] if k.endswith("_pages") else v).float().numpy()
            for k, v in layer.items()}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b",
                                  "recurrentgemma-9b", "grok-1-314b"])
def test_paged_decode_step_matches_reference_f32(arch):
    ref_cfg, cfg = _cfgs(arch, "float32")
    ref_p, port_p = _params(ref_cfg, cfg, seed=1)
    want, ref_cache = _ref_paged(ref_cfg, ref_p, seed=2)
    got, port_cache = _port_paged(cfg, port_p, seed=2)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    for mine, ref in zip(port_cache["layers"], _ref_layers(ref_cache, cfg)):
        mine = _no_trash(mine)
        assert mine.keys() == ref.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k], ref[k], rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b"])
def test_paged_decode_step_matches_reference_bf16(arch):
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    ref_p, port_p = _params(ref_cfg, cfg, seed=1)
    twin_cfg = dataclasses.replace(ref_cfg, dtype="float32")
    twin_p = jax.tree.map(lambda a: a.astype(jnp.float32), ref_p)
    want16, _ = _ref_paged(ref_cfg, ref_p, seed=2)
    want32, _ = _ref_paged(twin_cfg, twin_p, seed=2)
    got, _ = _port_paged(cfg, port_p, seed=2)
    _assert_bf16_close(got, want16, want32)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_bitwise_to_dense(arch, dtype):
    """With an identity page map and P * page_size = max_len the paged
    step is the dense `decode_step` bit for bit."""
    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    model = Transformer(cfg).init(seed=3, device="cpu")
    B, ps, P = 3, 4, 5
    dense = init_cache(model, cfg, B, P * ps)
    paged = init_paged_cache(model, cfg, B, B * P, ps)
    page_map = np.arange(B * P, dtype=np.int32).reshape(B, P)
    toks = np.random.default_rng(4).integers(2, cfg.vocab_size, (B, P * ps))
    for t in range(P * ps):
        want, dense = decode_step(model, cfg, dense, toks[:, t])
        got, paged = paged_decode_step(model, cfg, paged, toks[:, t],
                                       page_map, np.full(B, t),
                                       np.ones(B, bool))
        assert torch.equal(got, want), t


def test_paged_cache_refuses_encoder_configs():
    cfg = reduce_config(get_config("whisper-tiny"))
    with pytest.raises(ValueError, match="decoder-only"):
        init_paged_cache({"embed": torch.zeros(1)}, cfg, 1, 1, 1)


# -------------------------- continuous batching -------------------------


def _ref_engine(cfg, params, num_slots, *, page_size=4, pages_per_slot=8,
                max_prompt_len=8):
    num_pages = num_slots * pages_per_slot
    table = ref_serve.PageTable(num_pages=num_pages, page_size=page_size,
                                num_slots=num_slots,
                                pages_per_slot=pages_per_slot)
    backend = ref_serve.ModelBackend(
        cfg, params, num_slots=num_slots, num_pages=num_pages,
        page_size=page_size, max_prompt_len=max_prompt_len)
    return ref_serve.BatchingEngine(backend, table, eos_id=-1)


def _engine(cfg, params, num_slots, *, page_size=4, pages_per_slot=8,
            max_prompt_len=8, **kw):
    num_pages = num_slots * pages_per_slot
    table = PageTable(num_pages=num_pages, page_size=page_size,
                      num_slots=num_slots, pages_per_slot=pages_per_slot)
    backend = ModelBackend(cfg, params, num_slots=num_slots,
                           num_pages=num_pages, page_size=page_size,
                           max_prompt_len=max_prompt_len, device="cpu", **kw)
    return BatchingEngine(backend, table, eos_id=-1)


def _lifecycle(r):
    return (r.rid, r.slot, r.arrived, r.admitted, r.finished, r.tokens)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_engine_retire_refill_matches_reference(arch):
    """2 slots, 5 requests of uneven prompts and budgets: slots retire
    and refill mid-stream; every request's tokens, slot and step stamps
    equal the reference engine's, and a request replayed alone gives
    the same tokens."""
    ref_cfg, cfg = _cfgs(arch, "float32")
    ref_p, port_p = _params(ref_cfg, cfg, seed=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 7, 2, 5, 8)]
    budgets = [5, 3, 7, 4, 6]
    ref_eng = _ref_engine(ref_cfg, ref_p, 2)
    eng = _engine(cfg, port_p, 2)
    for p, n in zip(prompts, budgets):
        ref_eng.submit(p, n)
        eng.submit(p, n)
    want = [_lifecycle(r) for r in ref_eng.run()]
    got = [_lifecycle(r) for r in eng.run()]
    assert got == want
    done = eng.completed
    assert max(r.slot for r in done) <= 1 and max(r.admitted for r in done) > 0
    assert eng.table.free_pages == eng.table.num_pages
    for r in done:
        solo = _engine(cfg, port_p, 2)
        solo.submit(r.prompt, r.max_new_tokens)
        (alone,) = solo.run()
        assert alone.tokens == r.tokens, r.rid


def test_model_backend_warmup_and_sampling():
    _, cfg = _cfgs("llama3.2-3b", "float32")
    model = Transformer(cfg).init(seed=1, device="cpu")
    eng = _engine(cfg, model, 2, temperature=1.0)
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in eng.backend.cache["layers"]]
    seconds = eng.backend.warmup(eng.table)
    assert isinstance(seconds, float) and seconds > 0
    for old, new in zip(before, eng.backend.cache["layers"]):
        for k in old:   # every page but the trash page as it was
            assert torch.equal(old[k][:-1], new[k][:-1])
    prompt = np.arange(2, 6, dtype=np.int32)
    runs = []
    for seed in (7, 7, 8):
        e = _engine(cfg, model, 2, temperature=1.0)
        e.seed = seed
        e.submit(prompt, 6)
        runs.append(e.run()[0].tokens)
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(0 <= t < cfg.vocab_size for t in runs[0])


def test_sim_backend_steps_match_reference():
    """Admission back-pressure and streaming submissions through the
    model-free backend: every step's event dict, load vector and load
    score equal the reference's."""
    kw = dict(num_pages=8, page_size=4, num_slots=4, pages_per_slot=4)
    mine = BatchingEngine(SimBackend(4), PageTable(**kw), eos_id=-1, seed=3)
    ref = ref_serve.BatchingEngine(ref_serve.SimBackend(4),
                                   ref_serve.PageTable(**kw), eos_id=-1,
                                   seed=3)
    rng = np.random.default_rng(1)
    for step in range(60):
        for _ in range(int(rng.poisson(0.8))):
            plen, budget = int(rng.integers(1, 9)), int(rng.integers(1, 9))
            mine.submit(np.zeros(plen, np.int32), budget)
            ref.submit(np.zeros(plen, np.int32), budget)
        if step < 50 or not ref.idle:
            assert mine.step() == ref.step()
        assert mine.load_vector() == ref.load_vector()
        assert mine.load_score() == ref.load_score()
    assert [_lifecycle(r) for r in mine.completed] == [
        _lifecycle(r) for r in ref.completed]
    assert mine.tokens_generated == ref.tokens_generated > 0
    with pytest.raises(ValueError, match="empty prompt"):
        mine.submit(np.zeros(0, np.int32), 1)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        mine.submit(np.zeros(8, np.int32), 20)


# ---------------------------- control plane -----------------------------


def _round_equal(a, b):
    for f in ("summary", "table", "level_messages", "level_ticks"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("messages", "control_bytes", "payload_values"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("R", [8, 16, 64])
@pytest.mark.parametrize("full_view", [True, False])
def test_control_plane_bitwise_to_reference(R, full_view):
    rng = np.random.default_rng(R)
    loads = rng.uniform(0.0, 10.0, (R, len(LOAD_FIELDS)))
    scores = rng.uniform(0.0, 2.0, R)
    with jax.threefry_partitionable(False):
        ref = ref_serve.ControlPlane(R, full_view=full_view, seed=0)
        want = [ref.round(loads, scores, round_idx=i) for i in (0, 1)]
    mine = ControlPlane(R, full_view=full_view, seed=0, options=CPU)
    assert mine.levels == ref.levels
    assert len(mine.plan.levels) == len(ref.plan.levels)
    got = [mine.round(loads, scores, round_idx=i) for i in (0, 1)]
    for a, b in zip(want, got):
        _round_equal(a, b)
    assert (mine.rounds_run, mine.total_messages, mine.total_bytes) == (
        ref.rounds_run, ref.total_messages, ref.total_bytes)
    if full_view:
        assert np.abs(got[0].table - scores[None, :]).max() < 1e-2


def test_control_plane_refusals():
    cp = ControlPlane(8, full_view=True, seed=0, options=CPU)
    with pytest.raises(ValueError, match="loads must be"):
        cp.round(np.zeros((4, len(LOAD_FIELDS))), np.zeros(8))
    with pytest.raises(ValueError, match="needs per-replica scores"):
        cp.round(np.zeros((8, len(LOAD_FIELDS))), None)
    with pytest.raises(ValueError, match="fixed_ticks_scale"):
        ControlPlane(8, fixed_ticks_scale=0.0, options=CPU)
    with pytest.raises(ValueError, match=">= 2 replicas"):
        ControlPlane(1, options=CPU)


def test_control_plane_1024_messages():
    """R=1024 on the CPU: the 5-level plan and the reference's counts for
    its second round (round_idx 1).  Messages do not depend on the
    payload, so 4 fields (full_view off) stand for the 1028 of the full
    view here."""
    R = 1024
    cp = ControlPlane(R, full_view=False, seed=0, eps=1e-4, options=CPU)
    assert cp.levels == (8, 4, 4, 2, 4)
    rr = cp.round(np.ones((R, len(LOAD_FIELDS))), round_idx=1)
    assert rr.messages == 249826
    assert rr.level_messages.tolist() == [195840, 36096, 10310, 4182, 2374]
    assert rr.level_ticks.tolist() == [320, 128, 128, 128, 384]
    assert rr.control_bytes == 249826 * 4 * 4


# ------------------------------- fleet ----------------------------------


def _recorded_fleet():
    entry = json.loads((ROOT / "BENCH_serve.json").read_text())[-1]["fleet"]
    assert (entry["replicas"], entry["ticks"], entry["seed"]) == (16, 120, 0)
    return entry


@pytest.mark.parametrize("router", ROUTERS)
def test_fleet_matches_reference_and_record(router):
    cfg = FleetConfig(replicas=16, ticks=120, router=router, seed=0)
    got = run_fleet(cfg, options=CPU)
    with jax.threefry_partitionable(False):
        want = ref_serve.run_fleet(ref_serve.FleetConfig(
            replicas=16, ticks=120, router=router, seed=0))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    rec = _recorded_fleet()[router]
    assert got.throughput == rec["throughput_tok_per_tick"]
    for f in ("completed", "admission_latency_mean", "page_utilization_mean",
              "control_rounds", "control_messages", "control_bytes",
              "bytes_per_round"):
        assert getattr(got, f) == rec[f], f


def test_fleet_gossip_tracks_oracle():
    res = {r: run_fleet(FleetConfig(replicas=16, ticks=120, router=r,
                                    seed=0), options=CPU) for r in ROUTERS}
    assert res["p2c_gossip"].throughput >= 0.9 * res["oracle"].throughput
    ratio = res["p2c_gossip"].throughput / res["oracle"].throughput
    assert ratio == _recorded_fleet()["p2c_over_oracle"]
    with pytest.raises(ValueError, match="unknown router"):
        run_fleet(FleetConfig(router="nearest"), options=CPU)
