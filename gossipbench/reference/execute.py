"""The reference execution of multiscale gossip in its fixed-iterations
form (Tsianos & Rabbat, Alg. 1; MultiscaleGossipFI), trial by trial
block, over the reference's own plan (`reference.plan`).

Every level runs its fixed tick budget in chunks.  Each tick, one
uniformly drawn node of every graph wakes, draws a uniform neighbour,
and the pair averages; the draws come from threefry keyed by the trial
seed, the level and the tick.  Under a failure scenario the drawn
exchanges are perturbed (down nodes, stragglers, Byzantine nodes that
drop updates); under a cost model each chunk also draws its link-level
retransmissions and counts its concurrent exchanges.  Between levels
each graph's representative carries its value, weighted by its cell's
size, to the next level; at the end every node reads its level-2
cell's value (the down-pass).  Transmissions are attributed to nodes
through the routes of each overlay edge.

Plain torch and numpy: a loop over ticks for the value pass, the
draws as int64 tensor arithmetic.  `dtype` sets the precision of the
node values (float32 as the configuration states; a lower one makes
the benchmark's control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import prng

# stream tags folded into a level key before a chunk's tick offset
TAG_RETX = 2_147_483_640
TAG_STRAGGLER = 2_147_483_641
CHURNED, STRAGGLER, BYZ, REGIONAL = 1, 2, 4, 8


def fi_ticks(size: int, eps: float, scale: float, quadratic: bool) -> int:
    """The fixed tick budget of a level whose largest graph has `size`
    nodes: scale x (p^2/2 or 4p) x ln(1/eps), at least 32."""
    ln = math.log(1.0 / eps)
    budget = 0.5 * size * size * ln if quadratic else 4.0 * size * ln
    return max(32, math.ceil(scale * budget))


def level_chunks(plan: dict, eps: float, scale: float,
                 check_every: int = 64) -> list:
    """(ticks, ticks a chunk) of each level: whole chunks covering the
    level's budget."""
    out = []
    for li in range(int(plan["levels"])):
        fixed = fi_ticks(int(plan[f"L{li}.n_nodes"].max()), eps, scale,
                         quadratic=bool(plan[f"L{li}.kind"] == 1))
        chk = max(1, min(check_every, fixed))
        out.append((-(-fixed // chk) * chk, chk))
    return out


def failure_sets(fm: dict, n: int, coords) -> dict:
    """The failed node sets of a scenario, drawn on the host from its
    own seed in a fixed order: churned, stragglers, Byzantine, then the
    regional outage's epicentre."""
    rng = np.random.default_rng(fm.get("seed", 0))

    def pick(frac):
        m = np.zeros(n, bool)
        k = int(round(frac * n))
        if k > 0:
            m[rng.choice(n, size=min(k, n), replace=False)] = True
        return m

    out = {"churned": pick(fm.get("churn_fraction", 0.0)),
           "straggler": pick(fm.get("straggler_fraction", 0.0)),
           "byz": pick(fm.get("drop_fraction", 0.0))}
    epicenter = rng.uniform(0.0, 1.0, 2)
    radius = fm.get("regional_radius", 0.0)
    out["regional"] = (np.linalg.norm(coords - epicenter[None, :], axis=1)
                       < radius) if radius > 0 else np.zeros(n, bool)
    return out


def _level_faults(plan, fm, chunks, n, dev):
    """Each level's (bits (B, C) uint8, churn tick, regional window,
    straggler success) and the nodes that keep their finest-level
    value (they never hear, or discard, the down-pass)."""
    sets = failure_sets(fm, n, plan["coords"])
    maxt0 = chunks[0][0]
    t0f, t1f = fm.get("regional_window", (0.25, 0.75))
    perm = t1f > 1.0
    succ = (float(fm.get("straggler_success", 0.25))
            if fm.get("straggler_fraction", 0.0) > 0 else 1.0)
    out = []
    for li in range(int(plan["levels"])):
        sn = plan[f"L{li}.slot_node"]
        idx = np.clip(sn, 0, n - 1)
        bits = np.zeros(sn.shape, np.uint8)
        for name, bit in (("churned", CHURNED), ("straggler", STRAGGLER),
                          ("byz", BYZ), ("regional", REGIONAL)):
            bits |= ((sn >= 0) & sets[name][idx]).astype(np.uint8) * bit
        if li == 0:
            window = (int(round(t0f * maxt0)),
                      maxt0 + 1 if perm else int(round(t1f * maxt0)))
            churn = int(round(fm.get("churn_time", 0.5) * maxt0))
        else:
            window = (0, chunks[li][0] + 1) if perm else (0, 0)
            churn = 0
        out.append((torch.as_tensor(bits, device=dev), churn, window, succ))
    frozen = sets["byz"] | sets["churned"]
    if perm:
        frozen = frozen | sets["regional"]
    return out, frozen


def _log_q(p: float) -> float:
    return float(torch.log(torch.tensor(1.0 - p, dtype=torch.float32)))


def _chunk(t0, T, keys, adj, fault, cost, hop_cap, usage, msgs, retx, cong):
    """Draw ticks t0 .. t0+T-1 for R trials of the level's B graphs, count
    them, and return the (T, R, B) pairs and update bits."""
    start, nbr, hop, degrees, n_nodes = adj
    R = keys.shape[0]
    B = degrees.shape[0]
    dev = keys.device
    bidx = torch.arange(B, device=dev)
    ts = torch.arange(t0, t0 + T, device=dev)
    kt = prng.fold_in(keys[None], ts[:, None])               # (T, R, 2)
    ki, kj, _, _ = prng.split(kt, 4).unbind(-2)
    i = torch.minimum((prng.uniform(ki, (B,)) * n_nodes).to(torch.int32),
                      n_nodes - 1).long()
    deg_i = degrees[bidx, i]
    jidx = torch.minimum((prng.uniform(kj, (B,)) * deg_i).to(torch.int32),
                         torch.clamp_min(deg_i - 1, 0))
    pos = start[bidx, i] + jidx
    j = nbr[pos]
    attempt = deg_i > 0
    hops = hop[pos]
    sent = 2 * hops
    upd_i = upd_j = attempt
    if fault is not None:
        bits, churn, (r0, r1), succ = fault
        bits_i, bits_j = bits[bidx, i], bits[bidx, j]
        when = ts[:, None, None]

        def down(b):
            return (((b & CHURNED) != 0) & (when >= churn)) | (
                ((b & REGIONAL) != 0) & (when >= r0) & (when < r1))

        down_i, down_j = down(bits_i), down(bits_j)
        attempt = attempt & ~down_i
        delivered = attempt & ~down_j
        if succ < 1.0:
            slow = ((bits_i | bits_j) & STRAGGLER) != 0
            ku = prng.fold_in(prng.fold_in(keys, TAG_STRAGGLER), t0)
            u = prng.uniform(ku, (T, B)).transpose(0, 1)
            delivered = delivered & (~slow | (u < torch.tensor(
                succ, dtype=torch.float32, device=dev)))
        upd_j = delivered & ((bits_j & BYZ) == 0)
        upd_i = delivered & ((bits_i & BYZ) == 0)
        # a contact of a down partner still sends the request
        sent = torch.where(attempt & ~down_j, sent, hops)
    nflat = nbr.shape[0]
    usage.index_add_(0, (pos + (torch.arange(R, device=dev) * nflat)[:, None]
                         ).reshape(-1), attempt.reshape(-1).long())
    sent = torch.where(attempt, sent, 0)
    msgs += sent.sum(0)
    if cost is not None and cost["retransmit_p"] < 1.0:
        kr = prng.fold_in(prng.fold_in(keys, TAG_RETX), t0)
        u = torch.clamp_min(prng.uniform(kr, (T, B, 2 * hop_cap)), 1e-12)
        lq = torch.tensor(_log_q(cost["retransmit_p"]), dtype=torch.float32,
                          device=dev)
        g = torch.floor(torch.log(u) / lq).long()            # (R, T, B, 2H)
        m = (torch.arange(2 * hop_cap, device=dev)
             < sent.transpose(0, 1)[..., None])
        retx += torch.where(m, g, 0).sum((1, 3))
    if cost is not None and cost["congestion_alpha"] > 0.0:
        conc = attempt.sum(2)                                # (T, R)
        # the chunk's pairs counted exactly, summed over chunks in f32
        cong += (attempt * torch.clamp_min(conc - 1, 0)[:, :, None]).sum(
            0).to(torch.float32)
    return i, j, upd_i, upd_j


def _pair_average(x, i, j, upd_i, upd_j):
    """x (N, C, V): for each tick in turn, rows i and j of every graph
    take their average where their update bit is set (the partner's row
    is written first)."""
    rows = torch.arange(x.shape[0], device=x.device)
    for t in range(i.shape[0]):
        it, jt = i[t], j[t]
        xi, xj = x[rows, it], x[rows, jt]
        avg = 0.5 * (xi + xj)
        x[rows, jt] = torch.where(upd_j[t][:, None], avg, xj)
        x[rows, it] = torch.where(upd_i[t][:, None], avg, xi)
    return x


def run(plan: dict, x0: torch.Tensor, seeds, *, eps: float, scale: float,
        weighted: bool, failures: dict | None = None,
        cost: dict | None = None, dtype=torch.float32) -> dict:
    """R trials (x0 (R, n) float32 on the device the reference runs on,
    seeds R ints).  Returns numpy arrays: x_final (R, n) float32,
    messages (R,), node_sends (R, n), level_messages (R, L) int64, and
    under `cost` retransmissions and congestion (R,) float64."""
    dev = x0.device
    n = x0.shape[1]
    R = len(seeds)
    V = 2 if weighted else 1
    L = int(plan["levels"])
    chunks = level_chunks(plan, eps, scale)
    faults, frozen = [None] * L, None
    if failures is not None:
        faults, frozen = _level_faults(plan, failures, chunks, n, dev)
    keys = torch.stack([prng.PRNGKey(s) for s in seeds]).to(dev)

    def t(name, dtype=torch.int64):
        return torch.as_tensor(plan[name], device=dev).to(dtype)

    sends = torch.zeros((R, n + 1), dtype=torch.int64, device=dev)
    level_msgs, retx_l, cong_l = [], [], []
    x = frozen_vals = None
    for li in range(L):
        p = f"L{li}."
        slot_node = t(p + "slot_node")
        B, C = slot_node.shape
        mask = slot_node >= 0
        adj = (t(p + "nbr_start"), t(p + "nbr_flat"), t(p + "hop_flat"),
               t(p + "degrees"), t(p + "n_nodes", torch.int32))
        if li == 0:
            vals = torch.where(mask, x0[:, slot_node.clamp_min(0)], 0.0)
            x = (torch.stack([vals * mask, mask.expand_as(vals).float()], -1)
                 if weighted else vals[..., None]).to(dtype)
        nflat = adj[1].shape[0]
        usage = torch.zeros(R * nflat, dtype=torch.int64, device=dev)
        msgs = torch.zeros((R, B), dtype=torch.int64, device=dev)
        retx = torch.zeros((R, B), dtype=torch.int64, device=dev)
        cong = torch.zeros((R, B), dtype=torch.float32, device=dev)
        lkeys = prng.fold_in(keys, li)
        hop_cap = max(1, int(plan[p + "max_hops"]))
        xs = x.reshape(R * B, C, V)
        maxt, chk = chunks[li]
        for t0 in range(0, maxt, chk):
            i, j, ui, uj = _chunk(t0, chk, lkeys, adj, faults[li], cost,
                                  hop_cap, usage, msgs, retx, cong)
            xs = _pair_average(xs, *(a.reshape(chk, R * B)
                                     for a in (i, j, ui, uj)))
        x = xs.reshape(R, B, C, V)
        level_msgs.append(msgs)
        retx_l.append(retx)
        cong_l.append(cong)
        if li == 0 and frozen is not None:
            sn0 = plan[p + "slot_node"]
            b, c = np.nonzero(sn0 >= 0)
            g0 = np.zeros(n, np.int64)
            s0 = np.zeros(n, np.int64)
            g0[sn0[b, c]] = b
            s0[sn0[b, c]] = c
            frozen_vals = _estimate(x)[:, torch.as_tensor(g0, device=dev),
                                       torch.as_tensor(s0, device=dev)]
        usage = usage.reshape(R, nflat)
        if plan[p + "kind"] == 0:
            sends.index_add_(1, t(p + "row_node"), usage)
            sends.index_add_(1, t(p + "partner_flat"), usage)
        else:
            use_e = usage[:, t(p + "edge_pos_i")] + usage[:, t(p + "edge_pos_j")]
            sends.index_add_(1, t(p + "inc_node"),
                             use_e[:, t(p + "inc_edge")] * t(p + "inc_count"))
        if p + "rep_slot" in plan:
            v = x[:, torch.arange(B, device=dev), t(p + "rep_slot")]
            w = (adj[4].to(torch.float32) if weighted
                 else t(p + "line16", torch.float32))
            v = v * w[:, None].to(dtype)
            B2, C2 = plan[f"L{li + 1}.slot_node"].shape
            x = torch.zeros((R, B2, C2, V), dtype=dtype, device=dev)
            x[:, t(p + "next_graph"), t(p + "next_slot")] = v
    x_final = _estimate(x)[:, t("final_graph"), t("final_slot")]
    if frozen_vals is not None and frozen.any():
        x_final = torch.where(torch.as_tensor(frozen, device=dev),
                              frozen_vals, x_final)
    lm = np.stack([m.cpu().numpy().sum(axis=1) for m in level_msgs], axis=1)
    out = dict(x_final=x_final.float().cpu().numpy(),
               messages=lm.sum(axis=1) + n,
               node_sends=sends[:, :n].cpu().numpy() + 1,
               level_messages=lm)
    if cost is not None:
        out.update(_price(cost, n, lm, out["messages"],
                          [r.cpu().numpy() for r in retx_l],
                          [c.cpu().numpy() for c in cong_l]))
    return out


def run_blocks(plan: dict, x0: torch.Tensor, seeds, **kw) -> dict:
    """`run` over blocks of trials small enough that a chunk's draw stays
    within about 2**26 words a tensor; the blocks' outputs joined."""
    words = max(ch[1] * int(plan[f"L{li}.slot_node"].shape[0])
                * 2 * max(1, int(plan[f"L{li}.max_hops"]))
                for li, ch in enumerate(level_chunks(
                    plan, kw["eps"], kw["scale"])))
    block = max(1, (1 << 26) // words)
    parts = [run(plan, x0[b:b + block], seeds[b:b + block], **kw)
             for b in range(0, len(seeds), block)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _estimate(x):
    if x.shape[-1] == 1:
        return x[..., 0].float()
    return (x[..., 0] / torch.clamp_min(x[..., 1], 1e-30)).float()


def _price(cost, n, level_messages, messages, retx, cong) -> dict:
    """Retransmissions (the sampled extra attempts, and the down-pass's
    n transmissions at their mean) and the congestion surcharge."""
    p = cost["retransmit_p"]
    if p < 1.0:
        level_retx = np.stack([r.sum(axis=1) for r in retx], axis=1).astype(
            np.float64)
    else:
        level_retx = np.zeros(level_messages.shape, np.float64)
    level_cong = np.stack([c.astype(np.float64).sum(axis=1) for c in cong],
                          axis=1)
    retransmissions = level_retx.sum(axis=1)
    if p < 1.0:
        retransmissions = retransmissions + n * (1.0 - p) / p
    he = cost.get("hop_energy", 1.0)
    congestion = (he * cost["congestion_alpha"] * level_cong).sum(axis=1)
    return dict(retransmissions=retransmissions, congestion=congestion)
