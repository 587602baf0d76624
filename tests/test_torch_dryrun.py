"""The port's dry run (`launch.dryrun`, `launch.trace_analysis`) against
the reference's (`launch/dryrun.py`, `launch/hlo_analysis.py`), on the
CPU.

* `active_params`, `model_flops` and `roofline_terms` (given the
  reference's `HW`) equal the reference's; `CollectiveStats`' arithmetic
  and `secant_totals` too, on the same inputs; `device_pod_map` follows
  the reference's ``id // pod_size`` rule on a mesh without "pod", and
  the "pod" coordinate on one with it.
* A rank's argument bytes (`argument_bytes`) of every runnable cell on
  both production meshes equal the sum of the reference's
  `NamedSharding(AbstractMesh, spec).shard_shape` bytes over its
  `build_cell` arguments, less what the port holds differently by
  design: the reference's scalar steps (host integers in the port) and
  Adafactor's moments of the leaves that are 1-D in a layer (the
  reference factors them over its stacked layer axis;
  `tests/test_torch_launch.py` leaves them out the same way).
* The trace against real ranks: a reduced llama3.2-3b prefill on a
  (2, 2) mesh as 4 gloo CPU ranks (`dist.ranks.run_ranks`) against
  `trace_cell(..., device="cpu")` of the same cell on a fake group of
  4: the collective account is equal call for call and byte for byte,
  and the traced flops equal `FlopCounterMode`'s count of rank 0's real
  run.  The full-depth trace's flops, bytes and collectives equal
  `secant_totals` over its 1- and 2-layer variants.  A sharded MoE cell
  traces with its buffer at the capacity, and `run_cell` records
  ``moe_rows == "capacity"`` for a MoE config.  The reduced train and
  prefill steps reduce-scatter their hidden state over "model" once for
  the embedding and twice a layer; the fake backend counts a
  reduce-scatter and moves nothing; `collective_stats` reports it under
  its kind.
* The flash and wkv ops' fake branch: output shapes and dtypes, one
  fake launch each with the `work` counts of `PERF.md`'s bound column
  (412.4 GFLOP at llama3.2-3b's prefill shape, 13.63 GFLOP at
  rwkv6-3b's); a fake input that the real launch's checks refuse (head
  size, gradient, dtype) raises there too; a real CPU tensor never
  takes it.
"""
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.launch.hlo_analysis as RH  # noqa: E402
import repro.launch.specs as RS  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    ARCH_IDS, SHAPES, cell_is_runnable,
)
from repro_torch.dist.ranks import run_ranks  # noqa: E402
from repro_torch.kernels import _fake  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import trace_analysis as TA  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402


def _reference_dryrun():
    """The reference's `launch.dryrun`, whose import sets XLA_FLAGS to
    512 host devices: the variable is put back at once, so no backend
    of this process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as R
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return R


R = _reference_dryrun()
PRODUCTION = {"pod16x16": {"data": 16, "model": 16},
              "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if cell_is_runnable(get_config(a), s)[0]]
HOST = {"data": 2, "model": 2}
PREFILL = (64, 4, "prefill")        # (S, B, mode): under chunk_threshold


# ----------------------- analytic flops, roofline ----------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    cfg, rcfg = get_config(arch), RC.get_config(arch)
    assert D.active_params(cfg) == R.active_params(rcfg)
    for shape in SHAPES:
        assert D.model_flops(cfg, shape) == R.model_flops(rcfg, shape)


def _stats(mod, total, cross, by_kind, count):
    return mod.CollectiveStats(total_bytes=total, cross_pod_bytes=cross,
                               by_kind=dict(by_kind), count=count)


TOTALS = [
    (3.5e15, 2.0e12, 7_000_000, 1_000_000,
     {"all-gather": 5_000_000, "all-reduce": 2_000_000}, 12, 256),
    (1.0e12, 9.0e13, 10, 0, {"psum": 10}, 1, 512),
    (-5.0, -3.0, -7, -2, {"psum": -7}, -1, 256),     # clamped wiggles
    (2.0e9, 1.0e6, 5.0e12, 0, {"ppermute": int(5e12)}, 4, 256),
]


@pytest.mark.parametrize("row", TOTALS)
def test_roofline_terms_match_reference(row):
    flops, nbytes, total, cross, by_kind, count, chips = row

    def totals(mod):
        return {"flops": flops, "bytes": nbytes,
                "collectives": _stats(mod, total, cross, by_kind, count)}

    want = R.roofline_terms(totals(RH), chips)
    assert D.roofline_terms(totals(TA), chips, hw=R.HW) == want
    # the port's own rates: the H100's, none of the reference's
    assert D.HW.keys() == R.HW.keys()
    assert not set(D.HW.values()) & set(R.HW.values())


def test_collective_stats_arithmetic_matches_reference():
    a = (7, 3, {"all_gather": 4, "psum": 3}, 5)
    b = (20, 9, {"psum": 11, "ppermute": 9}, 8)
    for op in (lambda x, y: x + y, lambda x, y: x - y,
               lambda x, y: x.scaled(2.5), lambda x, y: y.scaled(0.3)):
        got = op(_stats(TA, *a), _stats(TA, *b))
        want = op(_stats(RH, *a), _stats(RH, *b))
        assert got.asdict() == want.asdict()
    got, want = TA.CollectiveStats(), RH.CollectiveStats()
    for kind, n, cross in (("psum", 8, False), ("psum", 2, True),
                           ("all_gather", 5, True)):
        got.add(kind, n, cross)
        want.add(kind, n, cross)
    assert got.asdict() == want.asdict()


@pytest.mark.parametrize("repeats", (1, 4, 28))
def test_secant_totals_match_reference(repeats):
    c1 = {"flops": 10.0, "bytes": 7.0}
    c2 = {"flops": 16.5, "bytes": 9.0}
    s1, s2 = (12, 4, {"psum": 12}, 3), (30, 10, {"psum": 20, "x": 10}, 7)
    got = TA.secant_totals({**c1, "c": _stats(TA, *s1)},
                           {**c2, "c": _stats(TA, *s2)}, repeats)
    want = RH.secant_totals({**c1, "c": _stats(RH, *s1)},
                            {**c2, "c": _stats(RH, *s2)}, repeats)
    assert got["flops"] == want["flops"] and got["bytes"] == want["bytes"]
    assert got["c"].asdict() == want["c"].asdict()


@pytest.mark.parametrize("pod_size", (4, 64, 256))
def test_device_pod_map_matches_reference_rule(pod_size):
    sizes = PRODUCTION["pod16x16"]
    want = RH.device_pod_map(list(range(256)), pod_size)
    assert TA.device_pod_map(sizes, pod_size) == want
    assert TA.device_pod_map(sizes, pod_size) == [r // pod_size
                                                  for r in range(256)]
    # with "pod", its coordinate: the first 256 ranks are pod 0
    pods = TA.device_pod_map(PRODUCTION["pod2x16x16"], pod_size)
    assert pods == [r // 256 for r in range(512)]


def test_collective_stats_of_an_account():
    account = {
        "psum": {"calls": 3, "bytes": 60, "result_bytes": 60, "groups": [
            {"dims": ["model"], "ranks": [0, 1], "calls": 2, "bytes": 40,
             "result_bytes": 40},
            {"dims": ["pod"], "ranks": [0, 4], "calls": 1, "bytes": 20,
             "result_bytes": 20}]},
        "all_gather": {"calls": 1, "bytes": 8, "result_bytes": 32,
                       "groups": [{"dims": ["data"], "ranks": [0, 2],
                                   "calls": 1, "bytes": 8,
                                   "result_bytes": 32}]},
        "host_copy": {"calls": 5, "bytes": 99, "result_bytes": 99,
                      "groups": [{"dims": [], "ranks": [], "calls": 5,
                                  "bytes": 99, "result_bytes": 99}]},
    }
    pods = TA.device_pod_map({"pod": 2, "data": 2, "model": 2}, 256)
    got = TA.collective_stats(account, pods)
    assert got.asdict() == {"total_bytes": 92, "cross_pod_bytes": 20,
                            "by_kind": {"psum": 60, "all_gather": 32},
                            "count": 4}


# ------------------------------ arguments ------------------------------


def _ref_arg_bytes(arch, shape, sizes):
    """The reference's shard bytes over its cell's arguments, without its
    scalar steps and the Adafactor moments of 1-D-per-layer leaves."""
    rcfg = RC.get_config(arch)
    cell = RS.build_cell(rcfg, shape,
                         AbstractMesh(tuple(sizes.values()), tuple(sizes)))
    shardings = jax.tree_util.tree_flatten_with_path(
        cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    leaves = jax.tree_util.tree_flatten_with_path(cell.args_abs)[0]
    assert len(leaves) == len(shardings)
    params = cell.args_abs[0]["params"] if cell.mode == "train" else None
    total = 0
    for (path, leaf), (_, sh) in zip(leaves, shardings):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] == "step":
            continue                  # a host integer in the port
        if keys[:3] == [0, "opt", "v"] and keys[-1] in ("vr", "vc"):
            p = params
            for k in keys[3:-1]:
                p = p[k]
            if p.ndim == 2 and keys[3] in ("groups", "encoder"):
                continue              # factored over the stacked layers
        total += math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
    return total


def _port_arg_bytes(arch, shape, sizes):
    """The port's, without Adafactor's `v` of 1-D-per-layer leaves."""
    cell = build_cell(get_config(arch), shape, sizes, device="cpu")
    total = D.argument_bytes(cell, sizes)
    if cell.mode == "train":
        state, specs = cell.args_abs[0], cell.in_shardings[0]
        for name, v in state["opt"].get("v", {}).items():
            p = state["params"][name]
            if (isinstance(v, dict) and "v" in v and p.dim() == 1
                    and name.startswith(("blocks.", "encoder."))):
                total -= math.prod(D.local_shape(
                    v["v"].shape, specs["opt"]["v"][name]["v"], sizes)) * (
                    v["v"].element_size())
    return total


@pytest.mark.parametrize("mesh", list(PRODUCTION))
@pytest.mark.parametrize(("arch", "shape"), CELLS)
def test_argument_bytes_match_reference(arch, shape, mesh):
    sizes = PRODUCTION[mesh]
    assert _port_arg_bytes(arch, shape, sizes) == _ref_arg_bytes(
        arch, shape, sizes)


def test_local_shape():
    sizes = PRODUCTION["pod2x16x16"]
    assert D.local_shape((64, 3072), (("pod", "data"), "model"),
                         sizes) == (2, 192)
    assert D.local_shape((5, 7), (None, None), sizes) == (5, 7)
    assert D.local_shape((32, 9), ("data",), sizes) == (2, 9)


# ------------------------- real ranks vs trace -------------------------


def _small(arch, **changes):
    return dataclasses.replace(reduce_config(get_config(arch)),
                               dtype="float32", **changes)


def _real_rank(rank, world, cfg, shape):
    """The cell's step on this rank's blocks of real arguments (random
    parameters, token 1 everywhere) under `FlopCounterMode`."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import collectives as C
    from repro_torch.launch import set_mesh

    mesh = init_device_mesh("cpu", tuple(HOST.values()),
                            mesh_dim_names=tuple(HOST))
    cell = build_cell(cfg, shape, mesh, device="cpu")
    gen = torch.Generator().manual_seed(rank)

    def make(shape_, dt):
        if dt.is_floating_point:
            return 0.02 * torch.randn(shape_, generator=gen).to(dt)
        return torch.ones(shape_, dtype=dt)

    args = D._local_args(cell.args_abs, cell.in_shardings, mesh, make)
    C.reset_account()
    flops = FlopCounterMode(display=False)
    with set_mesh(mesh), flops, torch.no_grad():
        out = cell.fn(*args)
    return {"flops": flops.get_total_flops(), "account": C.account(),
            "finite": bool(torch.isfinite(out).all()),
            "shape": tuple(out.shape)}


def _real_train_rank(rank, world, cfg, shape):
    """The cell's train step on this rank's blocks of real arguments (as
    `_real_rank`'s), with gradients: its account and metrics."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.launch import set_mesh

    mesh = init_device_mesh("cpu", tuple(HOST.values()),
                            mesh_dim_names=tuple(HOST))
    cell = build_cell(cfg, shape, mesh, device="cpu")
    gen = torch.Generator().manual_seed(rank)

    def make(shape_, dt):
        if dt.is_floating_point:
            return 0.02 * torch.randn(shape_, generator=gen).to(dt)
        return torch.ones(shape_, dtype=dt)

    state, batch = D._local_args(cell.args_abs, cell.in_shardings, mesh,
                                 make)
    C.reset_account()
    with set_mesh(mesh):
        _, metrics = cell.fn(state, batch)
    return {"account": C.account(), "loss": float(metrics["loss"])}


@pytest.fixture(scope="module")
def traced():
    """The traces this module holds, made in one trace process."""
    import torch.distributed as dist

    cfg = _small("llama3.2-3b", num_layers=3)
    out = {"prefill": D.trace_cell(cfg, PREFILL, HOST, device="cpu")}
    for n in (1, 2):
        out[n] = D.trace_cell(dataclasses.replace(cfg, num_layers=n),
                              PREFILL, HOST, device="cpu")
    out["moe"] = D.trace_cell(_small("llama4-maverick-400b-a17b"), PREFILL,
                              HOST, device="cpu")
    out["train"] = D.trace_cell(cfg, (64, 4, "train"), HOST, device="cpu")
    D.close()
    out["caller_group"] = dist.is_initialized()
    return cfg, out


def test_trace_matches_real_ranks(traced):
    cfg, out = traced
    real = run_ranks(_real_rank, 4, cfg, PREFILL, backend="gloo",
                     timeout=240, threads=1)
    r0, got = real[0], out["prefill"]
    assert r0["finite"] and r0["account"]
    assert "host_copy" not in r0["account"]
    assert got["account"] == r0["account"]
    assert got["flops"] == r0["flops"] > 0
    assert got["kernels"] == {}
    mem = got["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["output_bytes"] == 4 * math.prod(r0["shape"])
    assert not out["caller_group"]


def test_trace_is_linear_in_depth(traced):
    """The full-depth trace equals the reference's secant extrapolation
    over its 1- and 2-layer variants."""
    cfg, out = traced
    pods = TA.device_pod_map(HOST, 2)

    def cost(tr):
        return {"flops": tr["flops"], "bytes": tr["bytes"],
                "collectives": TA.collective_stats(tr["account"], pods)}

    full = cost(out["prefill"])
    want = TA.secant_totals(cost(out[1]), cost(out[2]), cfg.num_layers)
    assert full["flops"] == want["flops"]
    assert full["bytes"] == want["bytes"]
    assert full["collectives"].asdict() == want["collectives"].asdict()
    assert full["collectives"].count > cost(out[1])["collectives"].count


def test_moe_traces_at_capacity(traced, monkeypatch, tmp_path):
    """The sharded MoE traces on fake tensors (its buffer at the
    capacity: a row count read off the data would raise there), and
    `run_cell`'s record of a MoE config says so; a dense one's does
    not."""
    _, out = traced
    moe = out["moe"]
    assert moe["account"]["pmax"]["calls"] >= 1
    assert moe["memory"]["temp_bytes"] > 0
    for arch, tr in (("llama4-maverick-400b-a17b", moe),
                     ("llama3.2-3b", out["prefill"])):
        monkeypatch.setattr(D, "trace_cell", lambda *a, tr=tr, **k: tr)
        rec = D.run_cell(arch, "prefill_32k", False, out_dir=str(tmp_path))
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec.get("moe_rows") == ("capacity" if arch.startswith(
            "llama4") else None)


def test_train_trace_counts_the_backward(traced):
    """The backward's sums over "model" (`copy_to_model`'s) are psums,
    which the prefill, whose branch sums are reduce-scatters, has none
    of."""
    _, out = traced
    train, fwd = out["train"], out["prefill"]
    assert train["mode"] == "train" and train["flops"] > 2 * fwd["flops"]
    assert train["account"]["psum"]["calls"] > fwd["account"].get(
        "psum", {"calls": 0})["calls"]


def test_train_trace_reduce_scatters_the_hidden_state(traced):
    """On the fake (2, 2) group the step's hidden state is the rank's
    block of D ("model" 2 divides d_model 64): the embedding's sum and
    each layer's attention and MLP outputs are reduce-scattered over
    "model", once each, in the train step as in the prefill, each
    giving half the bytes it takes."""
    cfg, out = traced
    for mode in ("train", "prefill"):
        rs = out[mode]["account"]["reduce_scatter"]
        assert rs["calls"] == 1 + 2 * cfg.num_layers, (mode, rs)
        assert {tuple(g["dims"]) for g in rs["groups"]} == {("model",)}
        assert 2 * rs["result_bytes"] == rs["bytes"] > 0
    pods = TA.device_pod_map(HOST, 2)
    stats = TA.collective_stats(out["train"]["account"], pods)
    assert stats.by_kind["reduce_scatter"] == out["train"]["account"][
        "reduce_scatter"]["result_bytes"]


def test_train_trace_matches_real_ranks(traced):
    """The reduced train step on 4 gloo ranks makes the collectives its
    trace on the fake group of 4 predicts, call for call and byte for
    byte (what the card's D1(c) holds S2 to)."""
    cfg, out = traced
    real = run_ranks(_real_train_rank, 4, cfg, (64, 4, "train"),
                     backend="gloo", timeout=240, threads=1)
    assert math.isfinite(real[0]["loss"])
    assert "host_copy" not in real[0]["account"]
    assert out["train"]["account"] == real[0]["account"]


def _fake_rank_reduce_scatter():
    """`collectives.reduce_scatter` on rank 1 of a fake group of 4 over
    a (2, 2) mesh, on real CPU tensors: its result and account."""
    from repro_torch.dist import collectives as C

    D._fake_group(4, 1)
    mesh = D._mesh(HOST, "cpu")
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    C.reset_account()
    got = {"model": C.reduce_scatter(x, mesh, "model", -1),
           "both": C.reduce_scatter(x, mesh, ("data", "model"), 0)}
    return {"x": x, "got": got, "account": C.account()}


def test_fake_backend_counts_reduce_scatter_and_moves_nothing():
    """On the fake backend a reduce-scatter is counted (one call a dim of
    the group, bytes in and the block's bytes out) and moves nothing:
    rank 1 keeps the block of its own x, unsummed."""
    out = D._pool().submit(_fake_rank_reduce_scatter).result()
    x, got = out["x"], out["got"]
    # rank 1 of the (2, 2) mesh is ("data" 0, "model" 1)
    assert torch.equal(got["model"], x[:, 3:])
    assert torch.equal(got["both"], x[1:2])
    rs = out["account"]["reduce_scatter"]
    assert rs["calls"] == 3
    rows = {tuple(g["dims"]): (g["calls"], g["bytes"], g["result_bytes"])
            for g in rs["groups"]}
    assert rows == {("model",): (2, 96 + 96, 48 + 48),
                    ("data",): (1, 48, 24)}
    assert set(out["account"]) == {"reduce_scatter"}


def test_collective_stats_knows_reduce_scatter():
    """A reduce-scatter is counted by its result bytes under its own
    kind, as the reference's HLO count reads "reduce-scatter"; a kind
    the account does not make raises."""
    row = {"dims": ["model"], "ranks": [0, 1], "calls": 3, "bytes": 96,
           "result_bytes": 48}
    account = {"reduce_scatter": {"calls": 3, "bytes": 96,
                                  "result_bytes": 48, "groups": [row]}}
    pods = TA.device_pod_map(HOST, 256)
    got = TA.collective_stats(account, pods)
    assert got.asdict() == {"total_bytes": 48, "cross_pod_bytes": 0,
                            "by_kind": {"reduce_scatter": 48}, "count": 3}
    assert "reduce_scatter" in TA.COLLECTIVES
    assert "reduce-scatter" in RH._COLLECTIVES
    with pytest.raises(ValueError, match="all_to_all"):
        TA.collective_stats({"all_to_all": account["reduce_scatter"]}, pods)


# ---------------------------- kernel ops -------------------------------


def test_fake_branch_of_the_kernel_ops():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.rwkv6 import ops as WO

    _fake.reset()
    before = (FO.flash_attention.launches, WO.rwkv6_wkv.launches)
    with FakeTensorMode():
        q = torch.empty((4, 24, 4096, 128), dtype=torch.bfloat16,
                        device="cuda")
        k = torch.empty((4, 8, 4096, 128), dtype=torch.bfloat16,
                        device="cuda")
        o = FO.flash_attention(q, k, k)
        o32 = FO.flash_attention(q.float(), k.float(), k.float(), window=64,
                                 causal=True)
        r = torch.empty((160, 4096, 64), dtype=torch.bfloat16, device="cuda")
        y = WO.rwkv6_wkv(r, r, r, r.float(),
                         torch.empty((160, 64), dtype=torch.bfloat16,
                                     device="cuda"))
    assert (o.shape, o.dtype) == (q.shape, torch.bfloat16)
    assert (o32.shape, o32.dtype) == (q.shape, torch.float32)
    assert (y.shape, y.dtype) == (r.shape, torch.bfloat16)
    rec = _fake.fake_launches()
    flash = FO.work(4, 24, 8, 4096, 4096, 128)
    assert flash["flops"] == 4 * 4 * 24 * 128 * 4096 * 4097 // 2
    assert round(flash["flops"] / 1e9, 1) == 412.4
    assert flash["bytes"] == 2 * (2 * 4 * 24 * 4096 * 128
                                  + 2 * 4 * 8 * 4096 * 128)
    assert rec["flash_attention_sm90"] == {"launches": 1, **flash}
    W = 64
    pairs = 4 * 24 * (W * (W + 1) // 2 + (4096 - W) * W)
    assert rec["flash_attention"]["flops"] == 4 * 128 * pairs
    assert rec["flash_attention"]["bytes"] == 2 * flash["bytes"]
    wkv = WO.work(160, 4096, 64)
    assert wkv["flops"] == (5 * 64 * 64 + 5 * 64) * 4096 * 160
    assert round(wkv["flops"] / 1e9, 2) == 13.63
    assert rec["rwkv6"] == {"launches": 1, **wkv}
    assert (FO.flash_attention.launches, WO.rwkv6_wkv.launches) == before
    _fake.reset()
    assert _fake.fake_launches() == {}


def _fake_case(case):
    """The kernel op of `case` on fake CUDA tensors that break one of the
    real launch's checks (flash: (4, 8, 256, D) q over 2 KV heads; wkv:
    (8, 256, N) streams)."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.rwkv6 import ops as WO

    op, fault = case
    D = N = 96 if fault == "head size" else 64
    grad = fault == "gradient"
    kv_dtype = torch.float32 if fault == "dtype" else torch.bfloat16

    def t(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="cuda",
                           requires_grad=grad)

    if op == "flash":
        FO.flash_attention(t((4, 8, 256, D)), t((4, 2, 256, D), kv_dtype),
                           t((4, 2, 256, D), kv_dtype))
    else:
        r = t((8, 256, N))
        WO.rwkv6_wkv(r, t((8, 256, N), kv_dtype), t((8, 256, N)),
                     t((8, 256, N), torch.float32), t((8, N)))


@pytest.mark.parametrize("case", [
    (op, fault) for op in ("flash", "wkv")
    for fault in ("head size", "gradient", "dtype")])
def test_fake_branch_makes_the_real_checks(case):
    """A fake input that the real launch would refuse raises as the
    real one does, and records no fake launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _fake.reset()
    with FakeTensorMode():
        with pytest.raises((ValueError, RuntimeError),
                           match="head size|forward only|dtype"):
            _fake_case(case)
        _fake_case((case[0], None))         # the same call, faultless
    assert sum(k["launches"] for k in _fake.fake_launches().values()) == 1
    _fake.reset()


def test_work_counts_the_masks():
    from repro_torch.kernels.flash_attention.ops import work

    i = np.arange(37)[:, None]
    j = np.arange(53)[None]
    for causal, window in ((True, None), (True, 5), (False, 7),
                           (False, None)):
        keep = np.ones((37, 53), bool)
        if causal:
            keep &= j <= i
        if window is not None:
            keep &= j > i - window
        got = work(1, 1, 1, 37, 53, 64, causal=causal, window=window)
        assert got["flops"] == 4 * 64 * int(keep.sum())


def test_real_cpu_tensors_never_take_the_fake_branch(monkeypatch):
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.rwkv6 import ops as WO
    from repro_torch.kernels.rwkv6 import rwkv6_ref

    def refuse(*args, **kwargs):
        raise AssertionError("a real tensor took the fake branch")

    monkeypatch.setattr(FO, "fake_launch", refuse)
    monkeypatch.setattr(WO, "fake_launch", refuse)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 9, 16), generator=gen) for _ in range(3))
    assert torch.equal(FO.flash_attention(q, k, v), attention_ref(q, k, v))
    r, kk, vv = (torch.randn((2, 5, 16), generator=gen) for _ in range(3))
    w = torch.rand((2, 5, 16), generator=gen)
    u = torch.randn((2, 16), generator=gen)
    assert torch.equal(WO.rwkv6_wkv(r, kk, vv, w, u),
                       rwkv6_ref(r, kk, vv, w, u))
