"""Asynchronous (overlapped) gradient synchronization, dense.

The paper's analysis rests on an asynchronous time model: nodes gossip
without a global clock.  The training-stack transplant of that idea is
**one-step-delayed gradient averaging** (`SyncConfig(overlap=
"one_step")`): step `t` applies the *previous* step's mixed gradients
while step `t`'s fresh gradients become the in-flight buffer, so the mix
has no data dependency on the current backward pass.  The train state
carries a double-buffered `prev_grads` dict; the error-feedback residual
rides along exactly as in the serialized path, one step late.

Staleness correction: the delayed gradients are mixed under the
rotation index (and applied under the learning rate) of the step that
*produced* them (`step - 1`), so the overlapped trajectory is the
serialized one delayed by exactly one step on a step-independent
gradient stream.  Warmup: at step 0 the buffer holds zeros and the
train step discards the update.

The reference's `execute_sync_sharded` expresses the same mix as
explicit per-replica collectives over a device mesh; it waits for the
port's multi-device work (ROADMAP Queue A), and passing `mesh=` raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .gossip_sync import execute_sync
from .plan import SyncPlan

__all__ = ["async_execute_sync", "init_inflight"]


def init_inflight(grads_like: dict) -> dict:
    """Zero in-flight gradient buffer (the second half of the double
    buffer) matching the gradient dict."""
    return {k: torch.zeros_like(g) for k, g in grads_like.items()}


def async_execute_sync(
    plan: SyncPlan,
    grads: dict,
    prev_grads: dict,
    residuals: Optional[dict] = None,
    step: int = 0,
    *,
    mesh=None,
    inplace: bool = False,
) -> tuple[dict, dict, Optional[dict]]:
    """One stage of the overlapped sync pipeline.

    grads: the current step's fresh (clipped) gradients — NOT mixed yet;
        they become the new in-flight buffer.
    prev_grads: the previous step's gradients (zeros at step 0).
    residuals / step: threaded to `execute_sync`; the rotation schedule
        and the faults are indexed at `step - 1`, the sync index of the
        step that produced `prev_grads`.
    inplace: mix into `prev_grads` (and `residuals`) in place.

    Returns (applied, new_prev_grads, new_residuals) where `applied` is
    `mix(prev_grads)` and `new_prev_grads` is `grads`.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded sync executor (execute_sync_sharded) is not "
            "ported yet (ROADMAP Queue A, several devices); pass mesh=None")
    applied, new_residuals = execute_sync(
        plan, prev_grads, residuals, int(step) - 1, inplace=inplace)
    return applied, grads, new_residuals
