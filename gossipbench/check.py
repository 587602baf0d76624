"""The comparison that decides `correct`: the program's plan and a
sample of the window's trials against the benchmark's reference.

Numbers compared, each against its cell's limit:

* ``plan_mismatch``: arrays of the program's plan (graph, every level's
  CSR, cells, election, promotion maps, overlay routes and incidence,
  the down-pass map) that differ from the reference's plan;
* ``accounting_mismatch``: entries of the sampled trials' messages,
  level messages and per-node sends that differ;
* ``cost_mismatch``: entries of their retransmissions and congestion
  that differ (priced cells);
* ``x_final_gap``: the largest, over the sampled trials, of the
  distance between the program's and the reference's final estimates,
  over the distance of the reference's from the true average (the
  error the paper measures).
"""
from __future__ import annotations

import numpy as np

# arrays of each level, named alike in the program's LevelPlan and the
# reference's plan
_LEVEL_FIELDS = ("nbr_start", "nbr_flat", "hop_flat", "degrees", "n_nodes",
                 "slot_node", "max_hops", "row_node", "partner_flat",
                 "edge_pos_i", "edge_pos_j", "inc_node", "inc_edge",
                 "inc_count", "rep_slot", "line16", "next_graph",
                 "next_slot")


def plan_mismatch(plan, ref: dict) -> list:
    """Names of the arrays in which the program's plan and the
    reference's differ (present on one side only counts too)."""
    bad = []

    def cmp(name, got, key):
        want = ref.get(key)
        if got is None or want is None:
            if (got is None) != (want is None):
                bad.append(name)
            return
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or not np.array_equal(got, want):
            bad.append(name)

    g = plan.graph
    cmp("coords", g.coords, "coords")
    cmp("graph.nbr_start", g.nbr_start, "graph_nbr_start")
    cmp("graph.nbr_flat", g.nbr_flat, "graph_nbr_flat")
    cmp("graph.degrees", g.degrees, "graph_degrees")
    cmp("partition.sides", np.asarray(plan.partition.sides), "sides")
    if len(plan.levels) != int(ref["levels"]):
        bad.append("levels")
    for li, lp in enumerate(plan.levels[:int(ref["levels"])]):
        for f in _LEVEL_FIELDS:
            cmp(f"L{li}.{f}", getattr(lp, f), f"L{li}.{f}")
        cmp(f"L{li}.routes", None if lp.routes is None else lp.routes.nodes,
            f"L{li}.route_nodes")
    for f in ("final_graph", "final_slot", "rep_counts"):
        cmp(f, getattr(plan, f), f)
    return bad


def _diff(got, want) -> int:
    """Entries that differ; every entry where the shapes do not agree."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return int(max(got.size, want.size, 1))
    return int(np.sum(got != want))


def compare(got: dict, want: dict, x0: np.ndarray) -> dict:
    """Readings of one block of trials: `got` and `want` hold x_final,
    messages, level_messages and node_sends (and retransmissions and
    congestion where priced) for the same trials, x0 their initial
    values."""
    acc = sum(_diff(got[k], want[k])
              for k in ("messages", "level_messages", "node_sends"))
    xf_got = np.asarray(got["x_final"], np.float64)
    if xf_got.shape != np.shape(want["x_final"]):
        xf_got = np.full(np.shape(want["x_final"]), np.inf)
    xf_want = np.asarray(want["x_final"], np.float64)
    dev = np.linalg.norm(xf_want - x0.mean(axis=1, keepdims=True), axis=1)
    gap = np.linalg.norm(xf_got - xf_want, axis=1) / np.maximum(dev, 1e-30)
    if not np.all(np.isfinite(xf_got)):
        gap = np.full_like(gap, np.inf)
    out = {"accounting_mismatch": acc,
           "x_final_gap": float(gap.max()) if len(gap) else 0.0}
    if "retransmissions" in want:
        out["cost_mismatch"] = sum(_diff(got.get(k), want[k])
                                   for k in ("retransmissions", "congestion"))
    return out


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every reading at or under its limit; a reading
    with no limit, or a limit with no reading, fails."""
    checks = {}
    ok = True
    for name in sorted(set(readings) | set(limits)):
        value, limit = readings.get(name), limits.get(name)
        good = value is not None and limit is not None and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
