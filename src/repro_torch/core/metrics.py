"""Error metrics used throughout the paper (§II eq. 1, Thm 2 eq. 2)."""
from __future__ import annotations

import numpy as np

__all__ = ["relative_error", "theorem2_bound"]


def relative_error(x: np.ndarray, x0: np.ndarray) -> float:
    """||x - x_ave * 1|| / ||x0||  (the paper's accuracy measure)."""
    avg = float(np.mean(x0))
    return float(np.linalg.norm(np.asarray(x) - avg) / np.linalg.norm(x0))


def theorem2_bound(n: int, eps: float) -> float:
    """Thm 2: final error <= sqrt(6) * n * eps w.h.p."""
    return float(np.sqrt(6.0) * n * eps)
