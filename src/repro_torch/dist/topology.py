"""Replica-set topology for decentralized gradient synchronization.

The paper's recursive-partition rule (Thm 1 discussion): subnetworks at
scale j contain O(n^((2/3)^j)) nodes, i.e. a network of size m is split
into ~m^(1/3) cells of ~m^(2/3) nodes each, recursively, until cells are
small enough to mix cheaply.  `suggest_levels` transplants that rule to
the replica set of a decentralized data-parallel trainer: it returns a
branching-factor tuple ``(l_1, ..., l_k)`` with ``prod(l_i) == R`` where
``l_1`` is the number of top-level cells and ``l_k`` is the size of the
finest cells.  For R = 32 this yields ``(4, 2, 4)``; for R = 512 the
hierarchy is >= 3 levels deep (the Theta(log log n) depth growth).

The mixing-matrix builders return dense doubly-stochastic matrices used
by analysis and tests.  The strategies in `gossip_sync` apply the same
operators structurally (rolls / grouped means) instead of an R x R
matmul.  Numpy only: the reference's module, copied.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "suggest_levels",
    "ring_matrix",
    "complete_matrix",
    "hierarchy_matrix",
    "default_rounds",
    "is_doubly_stochastic",
    "rotation_schedule",
]

# Cells of <= _CELL_MAX replicas mix in O(1) rounds; recursion stops here
# (the paper's base case where a cell's induced subgraph is near-complete).
_CELL_MAX = 4


def suggest_levels(R: int, cell_max: int = _CELL_MAX) -> tuple[int, ...]:
    """Factor the replica count R following the paper's n^(2/3) rule.

    At every step a group of m replicas is split into b cells of m/b
    replicas, with b the divisor of m closest to m^(1/3) (so cells hold
    ~m^(2/3) replicas).  Recursion stops once cells fit in `cell_max`.
    Returns branching factors coarsest-first; their product is exactly R.
    """
    if R < 1:
        raise ValueError(f"replica count must be >= 1, got {R}")
    levels: list[int] = []
    m = R
    while m > cell_max:
        target = m ** (1.0 / 3.0)
        divisors = [d for d in range(2, m) if m % d == 0]
        if not divisors:  # prime group: one flat cell, nothing to split
            break
        b = min(divisors, key=lambda d: (abs(d - target), d))
        levels.append(b)
        m //= b
    levels.append(m)
    return tuple(levels)


def ring_matrix(m: int, self_weight: float = 1.0 / 3.0) -> np.ndarray:
    """Symmetric doubly-stochastic ring: each node averages with its two
    ring neighbors.  W = self_weight * I + (1-self_weight)/2 * (S + S^T).
    Second-largest eigenvalue modulus governs the per-round contraction
    of replica disagreement (Boyd et al.)."""
    if m < 1:
        raise ValueError(f"ring size must be >= 1, got {m}")
    if not 0.0 < self_weight < 1.0:
        raise ValueError(f"self_weight must be in (0, 1), got {self_weight}")
    if m == 1:
        return np.ones((1, 1))
    w = np.eye(m) * self_weight
    side = (1.0 - self_weight) / 2.0
    for i in range(m):
        w[i, (i + 1) % m] += side
        w[i, (i - 1) % m] += side
    return w


def complete_matrix(m: int) -> np.ndarray:
    """One-shot exact fusion: W = J/m (the all-reduce operator as a
    doubly-stochastic matrix; spectral gap 1)."""
    if m < 1:
        raise ValueError(f"cell size must be >= 1, got {m}")
    return np.full((m, m), 1.0 / m)


def hierarchy_matrix(
    levels: tuple[int, ...], rounds_per_level: tuple[int, ...] | None = None
) -> np.ndarray:
    """Effective R x R operator of one bottom-up multiscale sweep.

    Per level (finest to coarsest) the within-cell ring matrix is applied
    `rounds` times on every cell in parallel; the result is the Kronecker
    composition of level operators.  Useful to reason about the spectral
    gap of a `gossip_sync` multiscale configuration without lowering it.
    """
    R = int(np.prod(levels))
    if rounds_per_level is None:
        rounds_per_level = tuple(default_rounds(l) for l in levels)
    if len(rounds_per_level) != len(levels):
        raise ValueError(
            f"rounds_per_level {rounds_per_level} does not match levels {levels}"
        )
    op = np.eye(R)
    # finest level acts on contiguous blocks of size l_k; coarser levels on
    # strided groups — expressed as I_{pre} (x) W^rounds (x) I_{post}
    for ax in range(len(levels) - 1, -1, -1):
        pre = int(np.prod(levels[:ax], dtype=int)) if ax else 1
        post = int(np.prod(levels[ax + 1:], dtype=int))
        w = np.linalg.matrix_power(ring_matrix(levels[ax]), rounds_per_level[ax])
        lvl_op = np.kron(np.kron(np.eye(pre), w), np.eye(post))
        op = lvl_op @ op
    return op


def rotation_schedule(
    R: int, period: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """The paper's randomized cells (§IV) on the replica set: a table of
    `period` replica permutations cycled by sync step, so cell membership
    (and ring neighbors) changes every step and no straggler is pinned to
    one cell.  Deterministic in (seed, step): step t uses row t % period.

    Returns (perms, invs), both (period, R) int32 with
    ``invs[t, perms[t, s]] == s`` — mixing runs in permuted order and the
    inverse scatters values back to their home replicas.
    """
    if R < 1:
        raise ValueError(f"replica count must be >= 1, got {R}")
    if period < 1:
        raise ValueError(f"rotation period must be >= 1, got {period}")
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(R) for _ in range(period)]).astype(np.int32)
    invs = np.argsort(perms, axis=1).astype(np.int32)
    return perms, invs


def default_rounds(cell_size: int) -> int:
    """Mixing rounds for a ring of `cell_size` nodes sized so the slowest
    mode contracts below ~1e-3: the ring's second eigenvalue is
    (1 + 2 cos(2 pi / m)) / 3, so ~4m rounds suffice for the small cells
    the n^(2/3) rule produces."""
    return max(4, 4 * cell_size)


def is_doubly_stochastic(w: np.ndarray, atol: float = 1e-8) -> bool:
    return bool(
        np.all(w >= -atol)
        and np.allclose(w.sum(axis=0), 1.0, atol=atol)
        and np.allclose(w.sum(axis=1), 1.0, atol=atol)
    )
