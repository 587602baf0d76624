"""Recursive multiscale partition of the unit square (paper §III, §V).

Convention follows the paper: level 1 is the TOP (one cell = the unit
square); level k is the FINEST.  A cell holding q nodes (in expectation)
is split into q^(1-a) subcells, i.e. q^((1-a)/2) per side, with the
subdivision constant a = 2/3 justified in §V-C.  Because every cell at a
level has equal area, the level-j partition is a regular S_j x S_j grid,
with S_1 = 1 and S_{j+1} = S_j * split_j.

Auto-k (paper Thm 1 part 2): choose the smallest k such that the finest
cells hold between m and M nodes, n^((2/3)^(k-1)) <= M, giving
k = Theta(log log n).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = ["Partition", "build_partition", "auto_levels"]

DEFAULT_A = 2.0 / 3.0


def auto_levels(n: int, a: float = DEFAULT_A, cell_max: float = 8.0) -> int:
    """Smallest k with n^(a^(k-1)) <= cell_max  (=> k = Theta(log log n))."""
    if n <= cell_max:
        return 1
    # a^(k-1) * ln n <= ln cell_max
    k = 1 + math.ceil(
        math.log(math.log(cell_max) / math.log(n)) / math.log(a)
    )
    return max(2, k)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Multiscale grid partition. sides[j-1] = S_j for level j in 1..k."""

    n: int
    a: float
    sides: tuple[int, ...]

    @property
    def k(self) -> int:
        return len(self.sides)

    def num_cells(self, level: int) -> int:
        return self.sides[level - 1] ** 2

    def expected_cell_size(self, level: int) -> float:
        return self.n / self.num_cells(level)

    def cell_of(self, coords: np.ndarray, level: int) -> np.ndarray:
        """Flat cell index (row-major) of each coordinate at `level`."""
        s = self.sides[level - 1]
        ij = np.minimum((coords * s).astype(np.int64), s - 1)
        return (ij[:, 1] * s + ij[:, 0]).astype(np.int64)

    def cell_center(self, level: int, cell: np.ndarray) -> np.ndarray:
        """(len(cell), 2) centers of flat cell indices at `level`."""
        s = self.sides[level - 1]
        cell = np.asarray(cell, np.int64)
        row, col = cell // s, cell % s
        return np.stack([(col + 0.5) / s, (row + 0.5) / s], axis=1)

    def parent_cell(self, level: int, cell: np.ndarray) -> np.ndarray:
        """Flat index at `level - 1` of the parent of each cell at `level`."""
        s_child = self.sides[level - 1]
        s_par = self.sides[level - 2]
        f = s_child // s_par
        cell = np.asarray(cell, np.int64)
        row, col = cell // s_child, cell % s_child
        return (row // f) * s_par + (col // f)

    def child_grid_edges(self, parent_level: int) -> np.ndarray:
        """Overlay-grid edges between level-(parent_level+1) cells.

        Two child cells share an edge iff they are N/S/E/W adjacent AND
        belong to the same parent cell (paper §III).  Returns an (m, 2)
        array of flat child-cell indices.
        """
        child_level = parent_level + 1
        s = self.sides[child_level - 1]
        f = s // self.sides[parent_level - 1]
        idx = np.arange(s * s, dtype=np.int64).reshape(s, s)
        edges = []
        # horizontal neighbors, excluding pairs straddling a parent boundary
        left, right = idx[:, :-1], idx[:, 1:]
        cols = np.arange(s - 1)
        same_parent = ((cols + 1) % f) != 0
        edges.append(
            np.stack([left[:, same_parent].ravel(), right[:, same_parent].ravel()], 1)
        )
        up, down = idx[:-1, :], idx[1:, :]
        rows = np.arange(s - 1)
        same_parent = ((rows + 1) % f) != 0
        edges.append(
            np.stack([up[same_parent, :].ravel(), down[same_parent, :].ravel()], 1)
        )
        return np.concatenate(edges).astype(np.int64)


def build_partition(
    n: int,
    k: Optional[int] = None,
    a: float = DEFAULT_A,
    cell_max: float = 8.0,
) -> Partition:
    """Construct the multiscale partition for an n-node deployment.

    With k=None the number of levels is chosen automatically per Thm 1
    part 2.  With k=2 and a=1/2 this yields the paper's two-level variant
    (§VI-B): n^(1/4) x n^(1/4) cells of ~sqrt(n) nodes each.
    """
    if k is None:
        k = auto_levels(n, a, cell_max)
    sides = [1]
    for _ in range(2, k + 1):
        q = n / sides[-1] ** 2  # expected nodes per cell at current level
        split = max(2, round(q ** ((1.0 - a) / 2.0)))
        sides.append(sides[-1] * split)
    return Partition(n=n, a=a, sides=tuple(sides))
