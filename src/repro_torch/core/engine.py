"""Executor for a `HierarchyPlan` (the execute half of the plan/execute
simulation core), on the card.

One call runs all K levels of multiscale gossip: per-level batched
gossip (`gossip_core`), Alg.-1 line-16 reweighting and value promotion
as gathers/scatters, send attribution as gathers through the plan's
route-incidence CSR plus one scatter-add, and the dissemination
down-pass as a gather.  State stays on the device between levels;
counters come to the host once, at the end, and are summed there in
int64.

`execute_plan(plan, x0, seeds=[s0..sT])` simulates T independent
Monte-Carlo trials, written out as a batch axis: the trials fold into
each level's graph batch, so one value-pass launch per chunk serves all
of them, and trial t equals a single run with seed ``seeds[t]``.

Backends (`ExecOptions.backend`): ``"ref"`` runs the plain tick loop,
``"cuda"`` the `pair_apply` kernel (bitwise equal to ``"ref"``),
``"matmul"`` composes each chunk's mixing matrix and applies it with the
`cell_mixing` kernel (values agree up to f32 rounding).  Schedule
``"per_tick"`` (`ExecOptions.schedule`) runs the legacy sequential path
of `core.gossip` with backend ``"ref"`` or ``"cuda"``, without failure
scenarios or pricing.

Process meshes (`ExecOptions.mesh`, a `torch.distributed` `DeviceMesh`;
every rank calls `execute_plan` with the same arguments and gets the
whole result, each trial bitwise the unsharded run's):

* trial sharding (a 1-dim mesh): T is padded up to a multiple of the
  mesh size with copies of the first trial, each rank runs its
  contiguous block of trials through the unsharded path (its trials
  still fold into one graph batch, one launch of each kernel a chunk),
  and every output is gathered to every rank with the padding dropped;
* node sharding (the ``("trials", "nodes")`` mesh): within its trial
  block a rank owns ``ceil(B / nd)`` contiguous graphs of each level
  (`gossip_core`'s ``node_shard``; the draw stays global), promotion
  and the final assembly scatter into a trash-rowed global buffer
  summed over ``"nodes"``, node sends are summed, level ticks maximised,
  and per-graph messages and convergence gathered by column before the
  host's int64 sums.

`failures` (`FailureModel`) carries the paper's message loss and the
scenarios (churn, stragglers, regional outage, Byzantine drops): each
level gets a `FailureCtx` of its slots' flags, drawn on the host from
`failure_sets`, and the chunk draw perturbs the schedule with it.
`cost` (`CostModel`) prices the run into `EngineResult.cost` without
perturbing the trajectory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..dist import collectives as C
from . import prng
from .gossip import GOSSIP_BACKENDS, gossip_core
from .medium import (
    CostModel,
    FailureCtx,
    FailureModel,
    MediumCost,
    expected_retransmissions,
    failure_sets,
)
from .options import ExecOptions, resolve_device
from .plan import HierarchyPlan
from .schedule import CsrGraphs

__all__ = ["EngineResult", "execute_plan", "fi_ticks", "trials_error"]


def fi_ticks(size: int, eps: float, scale: float, quadratic: bool) -> int:
    """Fixed-iterations budget (paper §VII): the theoretical
    epsilon-averaging-time bound for the worst-case graph size at the
    level — Theta(p^2 log 1/eps) ticks for p-node grids, Theta(p log
    1/eps) for the (near-complete) finest cells (Boyd et al. [2])."""
    ln = math.log(1.0 / eps)
    if quadratic:
        budget = 0.5 * size * size * ln
    else:
        budget = 4.0 * size * ln
    return max(32, math.ceil(scale * budget))


def trials_error(x_final: np.ndarray, x0: np.ndarray) -> np.ndarray:
    """(T,) relative error per trial (paper eq. 1); x0 may be (n,)
    shared or (T, n) per-trial."""
    x0 = np.asarray(x0)
    avg = x0.mean(axis=-1, keepdims=True)
    num = np.linalg.norm(x_final - avg, axis=-1)
    den = np.linalg.norm(np.broadcast_to(x0, x_final.shape), axis=-1)
    return num / den


@dataclasses.dataclass
class EngineResult:
    """Per-trial outputs of one plan execution (T trials)."""

    x_final: np.ndarray          # (T, n) estimates at every node
    messages: np.ndarray         # (T,) total single-hop transmissions
    node_sends: np.ndarray       # (T, n) transmissions attributed per node
    level_messages: np.ndarray   # (T, L) per executed level
    level_ticks: np.ndarray      # (T, L) max ticks over the level's graphs
    level_converged: np.ndarray  # (T, L) fraction of graphs converged
    edge_usage: list             # L flat (T, nnz+1) exchange counters
    #                              (collect_usage=True only)
    backend: str
    cost: Optional[MediumCost] = None  # priced medium cost (CostModel runs)

    @property
    def trials(self) -> int:
        return int(self.x_final.shape[0])

    def error(self, x0: np.ndarray) -> np.ndarray:
        """(T,) relative error per trial; see `trials_error`."""
        return trials_error(self.x_final, x0)


def _level_consts(lp, device):
    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(
            dtype)

    c = {
        "adj": CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat,
                         lp.degrees, lp.n_nodes).to_device(device),
        "node_mask": t(lp.node_mask, torch.bool),
        "slot_node": t(lp.slot_node, torch.int64),
    }
    if lp.kind == "cells":
        # per-flat-entry owner/partner global ids (sentinel = trash slot n)
        c["row_node"] = t(lp.row_node, torch.int64)
        c["partner_flat"] = t(lp.partner_flat, torch.int64)
    else:
        for name in ("edge_pos_i", "edge_pos_j", "inc_node", "inc_edge"):
            c[name] = t(getattr(lp, name), torch.int64)
        c["inc_count"] = t(lp.inc_count)
    if lp.rep_slot is not None:
        for name in ("rep_slot", "next_graph", "next_slot"):
            c[name] = t(getattr(lp, name), torch.int64)
        c["line16"] = t(lp.line16, torch.float32)
    return c


def _estimate(x):
    """(T, B, C) per-slot estimates of (T, B, C, V) state: the value, or
    the ratio of the two channels of the mass-weighted variant."""
    if x.shape[-1] == 1:
        return x[..., 0]
    return x[..., 0] / torch.clamp_min(x[..., 1], 1e-30)


def _check_models(failures: Optional[FailureModel],
                  cost: Optional[CostModel], fixed_ticks_scale: float):
    if failures is not None and failures.heterogeneous:
        raise ValueError(
            "per-edge loss_p is closed-form pricing only — the trajectory "
            "engine needs a scalar; price heterogeneous links with "
            "level_edge_messages + price_edge_messages")
    if cost is not None and cost.heterogeneous:
        raise ValueError(
            "per-edge hop_energy is closed-form pricing only — price "
            "heterogeneous links with level_edge_messages + "
            "price_edge_messages")
    if (failures is not None and failures.has_scenario
            and fixed_ticks_scale <= 0):
        raise ValueError(
            "failure scenarios require fixed_ticks_scale > 0: scenario "
            "event times are fractions of the finest level's tick budget, "
            "which the eps-oracle mode leaves unbounded")


def _failure_consts(plan, failures, maxt_levels, n, device):
    """Per-level `FailureCtx`s plus the dissemination freeze-out, from
    the host-drawn failure node sets mapped through each level's slot
    layout and static event windows.

    Event times are fractions of the FINEST level's tick budget (the
    finest level is where events fire); churned nodes stay down through
    every coarser level (churn_tick=0 there), and a regional outage
    persists into coarser levels only when its window extends past 1.0.

    Returns (ctxs, freeze): `freeze` is None or a dict with the (n,)
    mask of nodes that must NOT receive the dissemination down-pass —
    Byzantine nodes discard it, churned / permanently-out regional
    nodes never hear it — plus their (graph, slot) coordinates in the
    finest level, whose post-gossip value is exactly their frozen one.
    """
    sets = failure_sets(failures, n, coords=plan.graph.coords)
    maxt0 = int(maxt_levels[0])
    t0f, t1f = failures.regional_window
    reg_perm = t1f > 1.0
    ctxs = []
    for li, lp in enumerate(plan.levels):
        sn = np.asarray(lp.slot_node)
        valid = sn >= 0
        idx = np.clip(sn, 0, n - 1)
        if li == 0:
            churn_tick = int(round(failures.churn_time * maxt0))
            reg_t0 = int(round(t0f * maxt0))
            reg_t1 = maxt0 + 1 if reg_perm else int(round(t1f * maxt0))
        else:
            churn_tick = 0  # already-churned nodes stay down
            maxt = int(maxt_levels[li])
            reg_t0, reg_t1 = (0, maxt + 1) if reg_perm else (0, 0)
        ctxs.append(FailureCtx.from_masks(
            valid & sets["churned"][idx],
            valid & sets["straggler"][idx],
            valid & sets["byz"][idx],
            valid & sets["regional"][idx],
            churn_tick, reg_t0, reg_t1,
            (float(failures.straggler_success)
             if failures.straggler_fraction > 0 else 1.0),
            device=device,
        ))
    frozen = sets["byz"] | sets["churned"]
    if reg_perm:
        frozen = frozen | sets["regional"]
    freeze = None
    if plan.disseminate and frozen.any():
        sn0 = np.asarray(plan.levels[0].slot_node)
        b, c = np.nonzero(sn0 >= 0)
        ids = sn0[b, c].astype(np.int64)
        graph0 = np.zeros(n, np.int64)
        slot0 = np.zeros(n, np.int64)
        graph0[ids] = b
        slot0[ids] = c
        freeze = {name: torch.as_tensor(a, device=device) for name, a in (
            ("frozen", frozen), ("graph0", graph0), ("slot0", slot0))}
    return ctxs, freeze


def _price_levels(cost, plan, n, level_messages, messages, lretx, lcong):
    """Reduce the executor's per-graph cost counters into a `MediumCost`.

    `level_messages` is (T, L) int64; `lretx`/`lcong` are the L per-level
    (T, B) host counters (empty when `cost` is None).  When the model is
    closed-form (``sample=False`` or ``retransmit_p == 1``) the sampled
    counters are ignored and the Geometric mean ``T*(1-p)/p`` is applied
    to the logical counts instead.  The dissemination down-pass (n extra
    logical transmissions, already in `messages`) is priced in
    expectation — there is no schedule to sample against.
    """
    if cost is None:
        return None
    p = cost.retransmit_p
    if cost.sample and p < 1.0:
        level_retx = np.stack(
            [np.asarray(r, np.int64).sum(axis=1) for r in lretx],
            axis=1,
        ).astype(np.float64)
    else:
        level_retx = expected_retransmissions(level_messages, p)
    level_cong = np.stack(
        [np.asarray(cg, np.float64).sum(axis=1) for cg in lcong], axis=1)
    retx = level_retx.sum(axis=1)
    if plan.disseminate and p < 1.0:
        retx = retx + n * (1.0 - p) / p
    cong_e = cost.hop_energy * cost.congestion_alpha * level_cong
    congestion = cong_e.sum(axis=1)
    return MediumCost(
        transmissions=np.asarray(messages, np.float64),
        retransmissions=retx,
        congestion=congestion,
        energy=cost.hop_energy * (messages + retx) + congestion,
        level_energy=(
            cost.hop_energy * (level_messages + level_retx) + cong_e),
        model=cost,
    )


def execute_plan(
    plan: HierarchyPlan,
    x0: np.ndarray,
    *,
    eps: float = 1e-4,
    seeds: Sequence[int] = (0,),
    weighted: bool = False,
    fixed_ticks_scale: float = 0.0,
    options: Optional[ExecOptions] = None,
    failures: Optional[FailureModel] = None,
    cost: Optional[CostModel] = None,
) -> EngineResult:
    """Execute `plan` for T = len(seeds) independent trials.

    x0 may be (n,) — shared across trials — or (T, n) per-trial.  Each
    seed drives one trial's exchange randomness; the plan (partition,
    election, routes) is shared, so trials differ only in gossip noise.
    `options` (`ExecOptions`) selects backend / device / mesh / check
    cadence / tick budget; `failures` carries the paper's `loss_p`
    message-loss model plus the scenario fields (churn, stragglers,
    regional outage, Byzantine drops) that perturb the presampled
    schedule — their event times are fractions of the finest level's
    tick budget, so scenarios run in fixed-iterations mode.  `cost`
    prices the schedule (energy, retransmissions, congestion) into
    `EngineResult.cost` without perturbing the trajectory.
    `options.collect_usage` also returns the per-level flat exchange
    counters.

    With `options.mesh` every rank of the mesh calls this with the same
    arguments and gets the whole result (module docstring); each
    trial's outputs are bitwise those of the unsharded run.
    """
    options = options if options is not None else ExecOptions()
    dev = resolve_device(options.device)
    _check_models(failures, cost, fixed_ticks_scale)
    backend, schedule, mesh = options.backend, options.schedule, options.mesh
    if backend not in GOSSIP_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    scenario = failures is not None and failures.has_scenario
    if (scenario or cost is not None) and schedule != "presampled":
        raise ValueError(
            "failure scenarios / cost pricing require schedule='presampled'")
    if options.node_mesh and (scenario or cost is not None):
        raise ValueError(
            "failure scenarios / cost pricing are not supported on the "
            "(trials, nodes) mesh (their reductions are batch-global)")
    n = plan.graph.n
    x0 = np.asarray(x0, np.float32)
    T = len(seeds)
    if x0.ndim == 2 and x0.shape[0] != T:
        raise ValueError(f"x0 leading dim {x0.shape[0]} != trials {T}")

    # per-level loop config: fixed-iterations levels run a host-known
    # number of whole chunks with the oracle off (eps < 0)
    level_cfg = []
    for lp in plan.levels:
        if fixed_ticks_scale > 0:
            fixed = fi_ticks(
                int(lp.n_nodes.max()), eps, fixed_ticks_scale,
                quadratic=(lp.kind == "overlay"),
            )
            chk = max(1, min(options.check_every, fixed))
            level_cfg.append((-1.0, ((fixed + chk - 1) // chk) * chk, chk))
        else:
            level_cfg.append((float(eps), int(options.max_ticks_per_level),
                              int(options.check_every)))

    # trial sharding: padding trials (copies of the first) bring T up to
    # a multiple of the trial dim; each rank runs its contiguous block
    trial_dims = ("trials",) if options.node_mesh else (0,)
    nt = C.axis_size(mesh, trial_dims) if mesh is not None else 1
    Tl = -(-T // nt)  # trials a rank
    first = C.axis_index(mesh, trial_dims) * Tl if mesh is not None else 0
    padded = tuple(seeds) + tuple(seeds[:1]) * (Tl * nt - T)
    if x0.ndim == 2:
        x0 = np.concatenate([x0, np.repeat(x0[:1], Tl * nt - T, axis=0)])
        x0 = x0[first:first + Tl]
    out = _run_trials(plan, x0, padded[first:first + Tl], weighted,
                      level_cfg, options, dev, failures, cost, scenario)
    if mesh is not None:
        out = {k: ([C.all_gather(t, mesh, trial_dims)[:T] for t in v]
                   if isinstance(v, list)
                   else C.all_gather(v, mesh, trial_dims)[:T])
               for k, v in out.items()}

    # host-side int64 reduction of the per-graph int32 counters
    level_messages = np.stack(
        [m.cpu().numpy().astype(np.int64).sum(axis=1) for m in out["msgs"]],
        axis=1)
    messages = level_messages.sum(axis=1)
    if plan.disseminate:
        messages = messages + n
    return EngineResult(
        x_final=out["x_final"].cpu().numpy(),
        messages=messages,
        node_sends=out["node_sends"].cpu().numpy().astype(np.int64),
        level_messages=level_messages,
        level_ticks=out["ticks"].cpu().numpy().astype(np.int64),
        level_converged=out["conv"].cpu().numpy().astype(np.float64),
        edge_usage=[u.cpu().numpy() for u in out["usage"]],
        backend=backend,
        cost=_price_levels(
            cost, plan, n, level_messages, messages,
            [r.cpu().numpy() for r in out["retx"]],
            [cg.cpu().numpy() for cg in out["cong"]]),
    )


def _node_block(mesh, B: int, dev):
    """This rank's block of a level's B graphs on the nodes dim: the
    clipped column ids, the realness mask and the unclipped ids."""
    nd = C.axis_size(mesh, "nodes")
    Bs = -(-B // nd)
    sidx = C.axis_index(mesh, "nodes") * Bs + torch.arange(Bs, device=dev)
    return torch.clamp_max(sidx, B - 1), sidx < B, sidx


def _node_cols(t, mesh, B: int):
    """(T, Bs, ...) per-column values of each node block gathered into
    the (T, B, ...) columns of the whole level."""
    full = C.all_gather(t, mesh, "nodes", tiled=False)   # (nd, T, Bs, ...)
    full = full.movedim(0, 1)
    return full.reshape(full.shape[0], -1, *full.shape[3:])[:, :B]


def _run_trials(plan, x0, seeds, weighted, level_cfg, options, dev,
                failures, cost, scenario) -> dict:
    """All levels for the trials `seeds` (x0 (n,) or (len(seeds), n)):
    the per-trial outputs as device tensors with a leading trial axis
    (lists: one a level).  On the node mesh each rank runs its block of
    every level's graphs, and the results are summed or gathered over
    the nodes dim."""
    mesh = options.mesh if options.node_mesh else None
    n = plan.graph.n
    T = len(seeds)
    V = 2 if weighted else 1
    loss_p = failures.loss_p if failures is not None else None
    ctxs, freeze = [None] * len(plan.levels), None
    if scenario:
        ctxs, freeze = _failure_consts(
            plan, failures, [cfg[1] for cfg in level_cfg], n, dev)
    # (T, 2), built on the host and copied once
    keys = torch.stack([prng.PRNGKey(s) for s in seeds]).to(dev)
    x0_rows = torch.as_tensor(x0, device=dev).expand(T, n)
    node_sends = torch.zeros((T, n + 1), dtype=torch.int32, device=dev)
    out = dict(msgs=[], usage=[], retx=[], cong=[])
    lvl_ticks, lvl_conv = [], []
    xb = frozen_vals = None
    for li, (lp, (eps_l, maxt, chk)) in enumerate(zip(plan.levels, level_cfg)):
        c = _level_consts(lp, dev)
        B = lp.num_graphs
        cols, ok, shard = slice(None), None, None
        mask = c["node_mask"]
        if mesh is not None:
            cols, ok, _ = _node_block(mesh, B, dev)
            mask = mask[cols] & ok[:, None]
            shard = (cols, ok)
        if lp.kind == "cells":
            vals = torch.where(
                mask, x0_rows[:, torch.clamp_min(c["slot_node"][cols], 0)],
                0.0)
            if weighted:
                w = mask.to(torch.float32).expand_as(vals)
                xb = torch.stack([vals * w, w], dim=-1)
            else:
                xb = vals[..., None]
        elif mesh is not None:
            xb = xb[:, cols]  # promotion left xb global; take our block
        x, usage, msgs, done, ticks, *priced = gossip_core(
            xb.contiguous(), c["adj"], mask, eps_l, prng.fold_in(keys, li),
            max_ticks=maxt, check_every=chk, loss_p=loss_p,
            backend=options.backend, schedule=options.schedule,
            failure_ctx=ctxs[li], cost_model=cost,
            hop_cap=max(1, int(lp.max_hops)), node_shard=shard,
        )
        if priced:
            out["retx"].append(priced[0])
            out["cong"].append(priced[1])
        if mesh is None:
            out["msgs"].append(msgs)
            lvl_ticks.append(ticks.max(dim=1).values)
            lvl_conv.append(done.to(torch.float32).mean(dim=1))
        else:
            out["msgs"].append(_node_cols(msgs, mesh, B))
            lvl_ticks.append(C.pmax(
                torch.where(ok, ticks, 0).max(dim=1).values, mesh, "nodes"))
            done_all = _node_cols(done.to(torch.uint8), mesh, B)
            lvl_conv.append(done_all.to(torch.float32).mean(dim=1))
        if options.collect_usage:
            out["usage"].append(usage)
        # a frozen node's own post-gossip value at the finest level is its
        # value for the rest of the run: snapshot it before promotion
        if li == 0 and freeze is not None:
            frozen_vals = _estimate(x)[:, freeze["graph0"], freeze["slot0"]]
        # attribution: gathers through the plan CSR + scatter-adds (on
        # the node mesh each rank adds its own graphs' exchanges)
        if lp.kind == "cells":
            node_sends.index_add_(1, c["row_node"], usage)
            node_sends.index_add_(1, c["partner_flat"], usage)
        else:
            usage_e = usage[:, c["edge_pos_i"]] + usage[:, c["edge_pos_j"]]
            node_sends.index_add_(
                1, c["inc_node"], usage_e[:, c["inc_edge"]] * c["inc_count"])
        # promotion (gathers; Alg.1 line 16 on the finest level)
        if lp.rep_slot is not None:
            Bl = x.shape[1]
            v = x[:, torch.arange(Bl, device=dev), c["rep_slot"][cols]]
            if weighted:
                v = v * c["adj"].n_nodes[cols, None].to(torch.float32)
            else:
                v = v * c["line16"][cols, None]
            B2, C2 = plan.levels[li + 1].node_mask.shape
            if mesh is None:
                xb = torch.zeros((T, B2, C2, V), dtype=torch.float32,
                                 device=dev)
                xb[:, c["next_graph"], c["next_slot"]] = v
            else:
                # representatives hop node blocks here: scatter into a
                # trash-rowed global buffer and sum the halo over blocks
                tg = torch.where(ok, c["next_graph"][cols], B2)
                full = torch.zeros((T, B2 + 1, C2, V), dtype=torch.float32,
                                   device=dev)
                full[:, tg, c["next_slot"][cols]] = torch.where(
                    ok[:, None], v, 0.0)
                xb = C.psum(full, mesh, "nodes")[:, :B2]
    # final estimate + dissemination down-pass
    est = _estimate(x)
    if mesh is not None:
        BL, CL = plan.levels[-1].node_mask.shape
        _, ok, sidx = _node_block(mesh, BL, dev)
        full = torch.zeros((T, BL + 1, CL), dtype=torch.float32, device=dev)
        full[:, torch.where(ok, sidx, BL)] = torch.where(ok[:, None], est,
                                                         0.0)
        est = C.psum(full, mesh, "nodes")[:, :BL]
        node_sends = C.psum(node_sends, mesh, "nodes")
    fg = torch.as_tensor(plan.final_graph, device=dev).long()
    fs = torch.as_tensor(plan.final_slot, device=dev).long()
    x_final = est[:, fg, fs]
    # Byzantine nodes discard the down-pass; churned / permanently
    # regional-out nodes never hear it — they keep their frozen value
    if frozen_vals is not None:
        x_final = torch.where(freeze["frozen"], frozen_vals, x_final)
    node_sends = node_sends[:, :n]
    if plan.disseminate:
        node_sends = node_sends + 1  # the n-message down-pass
    out.update(x_final=x_final, node_sends=node_sends,
               ticks=torch.stack(lvl_ticks, 1), conv=torch.stack(lvl_conv, 1))
    return out
