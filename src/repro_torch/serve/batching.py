"""Continuous batching over a paged KV cache.

The engine replaces `Generator`'s run-to-all-done loop: decode slots are
admitted and retired **per step** — a slot frees its pages the moment
its request hits EOS (or its token budget) and is refilled from the
queue, so the batch stays full under streaming traffic.  The device
work goes through two calls whose shapes never change (the page table
keeps them fixed while requests come and go):

* `prefill` teacher-forces every just-admitted slot's prompt, one
  `paged_decode_step` a prompt position over all slots (the reference's
  ``lax.scan`` over the padded prompt, as a host loop), and samples each
  slot's first token from its own last prompt position's logits;
* `decode` is one `paged_decode_step` advancing every active slot at its
  own position (`steps` is per slot; inactive slots write the trash
  page).

The scheduling core is model-free: `BatchingEngine` drives any
`backend` with `prefill(...)` / `decode(...)` — `ModelBackend` runs the
real paged model on the card, `SimBackend` is the token-stream stub the
fleet simulation (`serve.fleet`) uses to run the same admission and
paging logic at N-replica scale.  `BatchingEngine`, `SimBackend` and
`Request` are the reference's host code line for line.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..core.options import resolve_device
from ..models import init_paged_cache, paged_decode_step
from .kv_pages import PageTable

__all__ = ["Request", "BatchingEngine", "ModelBackend", "SimBackend"]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle timestamps (engine steps)."""

    rid: int
    prompt: np.ndarray            # (plen,) int32
    max_new_tokens: int
    arrived: int = -1
    admitted: int = -1
    finished: int = -1
    slot: int = -1
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.finished >= 0

    @property
    def admission_latency(self) -> int:
        return self.admitted - self.arrived


class ModelBackend:
    """Paged decode of a real model on `device` (the card unless "cpu"
    is asked for; the parameters must lie there): owns the page pools
    and the recurrent state, and exposes the two calls the engine
    schedules.

    Greedy sampling (temperature 0) is argmax, as in the reference.
    Temperature sampling draws from a `torch.Generator` on the device,
    seeded with the engine's `key_seed` for each call: its tokens are
    not the reference's `jax.random.categorical` draws for that seed.
    """

    def __init__(self, cfg, params, *, num_slots: int, num_pages: int,
                 page_size: int, max_prompt_len: int,
                 temperature: float = 0.0, device: str = "cuda"):
        self._device = resolve_device(device)
        where = params["embed"].device
        if where.type != self._device.type or (
                self._device.index is not None and where != self._device):
            raise ValueError(f"the parameters lie on {where}, not on "
                             f"{self._device}")
        self.cfg = cfg
        self.params = params
        self.temperature = float(temperature)
        self.num_slots = num_slots
        self.max_prompt_len = int(max_prompt_len)
        self.cache = init_paged_cache(params, cfg, num_slots, num_pages,
                                      page_size)
        self._gen = torch.Generator(device=where)

    def _sample(self, logits, key_seed: int) -> np.ndarray:
        if self.temperature <= 0.0:
            tok = torch.argmax(logits, dim=-1)
        else:
            self._gen.manual_seed(int(key_seed))
            probs = torch.softmax(logits / self.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return tok.to(torch.int32).cpu().numpy()

    def _step(self, tokens, page_map, steps, write_mask):
        logits, self.cache = paged_decode_step(
            self.params, self.cfg, self.cache, tokens, page_map, steps,
            write_mask)
        return logits

    def warmup(self, table: PageTable) -> float:
        """One step with every slot masked, to load the libraries and
        pick the GEMM algorithms before the clock starts; returns the
        seconds spent.  Masked slots write only the trash page and keep
        their state, so the cache is as it was."""
        dev = self.params["embed"].device
        B = self.num_slots
        t0 = time.perf_counter()
        self._step(torch.zeros(B, dtype=torch.int32, device=dev),
                   torch.as_tensor(table.page_map, device=dev),
                   torch.zeros(B, dtype=torch.int32, device=dev),
                   torch.zeros(B, dtype=torch.bool, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def prefill(self, prompts, plens, page_map, admit_mask, key_seed):
        """Teacher-force the admitted slots' prompts (`prompts` (B,
        max_prompt_len) front-aligned, padded with 0) and sample each
        slot's first token from its last prompt position.  The loop ends
        after the longest admitted prompt: past it every write is masked
        and no logits are kept, so the result is the full scan's."""
        dev = self.params["embed"].device
        admit_np = np.asarray(admit_mask, bool)
        plens_np = np.asarray(plens, np.int32)
        length = int(plens_np[admit_np].max()) if admit_np.any() else 0
        prompts = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
        plens = torch.as_tensor(plens_np, device=dev)
        admit = torch.as_tensor(admit_np, device=dev)
        page_map = torch.as_tensor(page_map, device=dev)
        last_pos = torch.clamp_min(plens - 1, 0)
        steps = torch.zeros_like(plens)
        last = None
        for t in range(max(length, 1)):
            logits = self._step(prompts[:, t], page_map, steps,
                                admit & (t < plens))
            here = (last_pos == t)[:, None]
            last = logits if last is None else torch.where(here, logits, last)
            steps = steps + 1
        return self._sample(last, key_seed)

    def decode(self, tokens, steps, page_map, active, key_seed):
        logits = self._step(tokens, page_map, steps, active)
        return self._sample(logits, key_seed)


class SimBackend:
    """Deterministic token-stream stub (no model, no device work): every
    active slot emits token 2 forever, so request lifetimes are governed
    purely by `max_new_tokens`.  Lets the fleet simulation run the real
    admission / page-allocation / retirement logic at N-replica scale."""

    def __init__(self, num_slots: int, fill_token: int = 2):
        self.num_slots = num_slots
        self.fill = np.int32(fill_token)

    def prefill(self, prompts, plens, page_map, admit_mask, key_seed):
        return np.full(self.num_slots, self.fill, np.int32)

    def decode(self, tokens, steps, page_map, active, key_seed):
        return np.full(self.num_slots, self.fill, np.int32)


class BatchingEngine:
    """Admit -> prefill -> decode -> retire, one call per serving step.

    Pages for a request's full budget (prompt + max_new_tokens) are
    reserved at admission (`PageTable.alloc`), so decode never runs out
    of pages mid-stream; admission is head-of-line blocked on page/slot
    availability, which is exactly the backpressure signal the gossip
    control plane exports (`load_vector`).
    """

    TOKS_WINDOW = 16  # steps of tok/s history for the load vector

    def __init__(self, backend, table: PageTable, *, eos_id: int = 1,
                 seed: int = 0):
        if getattr(backend, "num_slots", table.num_slots) != table.num_slots:
            raise ValueError("backend/table num_slots mismatch")
        self.backend = backend
        self.table = table
        self.eos_id = int(eos_id)
        self.seed = int(seed)
        self.max_prompt_len = getattr(
            backend, "max_prompt_len",
            table.pages_per_slot * table.page_size,
        )
        S = table.num_slots
        self.slot_req: list[Optional[Request]] = [None] * S
        self.steps = np.zeros(S, np.int32)
        self.cur_tok = np.zeros(S, np.int32)
        self.queue: deque[Request] = deque()
        self.t = 0
        self._next_rid = 0
        self.completed: list[Request] = []
        self.tokens_generated = 0
        self._recent = deque(maxlen=self.TOKS_WINDOW)

    # ------------------------------ intake ------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> Request:
        prompt = np.asarray(prompt, np.int32).ravel()
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} > max_prompt_len "
                f"{self.max_prompt_len}"
            )
        budget = len(prompt) + int(max_new_tokens)
        if self.table.pages_needed(budget) > self.table.pages_per_slot:
            raise ValueError(
                f"request budget {budget} tokens exceeds slot capacity "
                f"{self.table.pages_per_slot * self.table.page_size}"
            )
        req = Request(self._next_rid, prompt, int(max_new_tokens),
                      arrived=self.t)
        self._next_rid += 1
        self.queue.append(req)
        return req

    # ---------------------------- load vector ---------------------------

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def load_vector(self) -> dict:
        """The control-plane payload: local-only observables."""
        recent = float(np.mean(self._recent)) if self._recent else 0.0
        return {
            "queue_depth": float(self.queue_depth),
            "active_slots": float(self.active_slots),
            "free_pages": float(self.table.free_pages),
            "tok_s": recent,
        }

    def load_score(self) -> float:
        """Scalar routing load: outstanding work normalized by capacity."""
        return (self.queue_depth + self.active_slots) / max(
            1, self.table.num_slots
        )

    @property
    def idle(self) -> bool:
        return self.active_slots == 0 and not self.queue

    # ------------------------------ stepping -----------------------------

    def _emit(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        req.tokens.append(int(tok))
        self.tokens_generated += 1
        self.cur_tok[slot] = tok
        if int(tok) == self.eos_id or len(req.tokens) >= req.max_new_tokens:
            req.finished = self.t
            self.completed.append(req)
            self.table.free(slot)
            self.slot_req[slot] = None
            self.steps[slot] = 0

    def step(self) -> dict:
        """One serving step: admit from the queue into free slots, batch-
        prefill the admissions, run one decode step for all active slots,
        retire finished ones.  Returns per-step event counts."""
        S = self.table.num_slots
        # -- admit (head-of-line) ----------------------------------------
        admitted: list[int] = []
        for slot in range(S):
            if not self.queue or self.slot_req[slot] is not None:
                continue
            req = self.queue[0]
            budget = len(req.prompt) + req.max_new_tokens
            if not self.table.can_alloc(budget):
                break
            self.queue.popleft()
            self.table.alloc(slot, budget)
            req.slot, req.admitted = slot, self.t
            self.slot_req[slot] = req
            self.steps[slot] = 0
            admitted.append(slot)

        # -- prefill admissions in one scanned call ----------------------
        if admitted:
            prompts = np.zeros((S, self.max_prompt_len), np.int32)
            plens = np.zeros(S, np.int32)
            admit_mask = np.zeros(S, bool)
            for slot in admitted:
                p = self.slot_req[slot].prompt
                prompts[slot, : len(p)] = p
                plens[slot] = len(p)
                admit_mask[slot] = True
            first = self.backend.prefill(
                prompts, plens, self.table.page_map, admit_mask,
                self._key(),
            )
            for slot in admitted:
                self.steps[slot] = plens[slot]
                self._emit(slot, first[slot])

        # -- decode every still-active slot ------------------------------
        active = np.array([r is not None for r in self.slot_req])
        decoded = int(active.sum())
        if decoded:
            tok = self.backend.decode(
                self.cur_tok, self.steps, self.table.page_map, active,
                self._key(),
            )
            self.steps[active] += 1
            for slot in np.nonzero(active)[0]:
                self._emit(int(slot), tok[slot])

        emitted = len(admitted) + decoded
        self._recent.append(emitted)
        self.t += 1
        return {
            "admitted": len(admitted),
            "decoded": decoded,
            "emitted": emitted,
            "active": self.active_slots,
            "queue": self.queue_depth,
            "page_utilization": self.table.utilization,
        }

    def _key(self) -> int:
        # one stream per engine step phase; deterministic in (seed, t)
        return self.seed * 1_000_003 + self.t

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until queue + slots drain (or `max_steps`); returns the
        completed requests in completion order."""
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.completed
