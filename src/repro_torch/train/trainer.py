"""Training loop with fault tolerance.

Responsibilities:
  * run the step on the device (the steps update the state in place),
  * checkpoint every `save_every` steps (atomic, keep-N) + auto-resume
    from the latest checkpoint on construction,
  * deterministic data (batch = f(seed, step)) so restarts replay the
    exact stream,
  * failure injection hook (`fail_at_step`) used by the recovery tests,
  * metrics JSONL log.

Straggler mitigation is structural rather than reactive: every gossip
sync strategy uses FIXED mixing rounds (the paper's MultiscaleGossipFI
variant), so no replica ever waits on a data-dependent convergence test
of another replica.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Optional

import torch

from ..core.options import resolve_device
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["Trainer"]


class Trainer:
    def __init__(
        self,
        step_fn: Callable,
        init_state: dict,
        data,                        # object with .batch_at(step) -> host batch
        *,
        ckpt_dir: Optional[str] = None,
        save_every: int = 50,
        keep_n: int = 3,
        place_batch: Optional[Callable] = None,
        log_path: Optional[str] = None,
        fail_at_step: Optional[int] = None,
        device="cuda",
    ):
        """`device` is the step's (the card unless "cpu" is asked for):
        the loop waits for it before reading a step's time.  A restore
        writes the checkpoint into `init_state`'s tensors."""
        self.device = resolve_device(device)
        self._step = step_fn
        self.state = init_state
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep_n = keep_n
        self.place_batch = place_batch or (lambda b: b)
        self.log_path = log_path
        self.fail_at_step = fail_at_step
        self.metrics_history: list[dict] = []
        # cumulative modeled wire traffic of decentralized sync (steps that
        # report `wire_bytes`); restarts reset it, as a per-run gauge
        self.wire_bytes_total = 0.0
        # running mean of `sync_overlap_fraction`; same per-run semantics
        self._overlap_sum = 0.0
        self._overlap_steps = 0
        # fault-degradation accumulators (steps that report the
        # SyncFailureModel metrics): Byzantine gradients rejected by
        # robust aggregation, and the live-replica fraction's mean
        self.rejected_gradients_total = 0.0
        self._eff_replica_sum = 0.0
        self._eff_replica_steps = 0
        if ckpt_dir and latest_step(ckpt_dir) is not None:
            self.state, step = restore_checkpoint(ckpt_dir, self.state)
            print(f"[trainer] resumed from step {step}")

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, rec: dict) -> None:
        self.metrics_history.append(rec)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def run(self, num_steps: int) -> list[dict]:
        self._sync()
        t_last = time.perf_counter()
        while self.step < num_steps:
            s = self.step
            if self.fail_at_step is not None and s == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {s}")
            batch = self.place_batch(self.data.batch_at(s))
            self.state, metrics = self._step(self.state, batch)
            if self.ckpt_dir and (s + 1) % self.save_every == 0:
                save_checkpoint(self.ckpt_dir, self.state, s + 1,
                                keep_n=self.keep_n)
            rec = {"step": s + 1, **{k: float(v) for k, v in metrics.items()}}
            self._sync()
            now = time.perf_counter()
            rec["sec_per_step"] = now - t_last
            if "wire_bytes" in rec:
                self.wire_bytes_total += rec["wire_bytes"]
                rec["wire_bytes_total"] = self.wire_bytes_total
            if "sync_overlap_fraction" in rec:
                self._overlap_sum += rec["sync_overlap_fraction"]
                self._overlap_steps += 1
                rec["sync_overlap_fraction_mean"] = (
                    self._overlap_sum / self._overlap_steps)
            if "rejected_gradient_count" in rec:
                self.rejected_gradients_total += rec["rejected_gradient_count"]
                rec["rejected_gradients_total"] = self.rejected_gradients_total
            if "effective_replica_fraction" in rec:
                self._eff_replica_sum += rec["effective_replica_fraction"]
                self._eff_replica_steps += 1
                rec["effective_replica_fraction_mean"] = (
                    self._eff_replica_sum / self._eff_replica_steps)
            t_last = now
            self._log(rec)
        # final checkpoint so a finished run is always resumable (unless
        # the periodic one already holds this step)
        if self.ckpt_dir and latest_step(self.ckpt_dir) != self.step:
            save_checkpoint(self.ckpt_dir, self.state, self.step,
                            keep_n=self.keep_n)
        return self.metrics_history
