"""Paged KV-cache bookkeeping for continuous batching.

`PageTable` is the host-side allocator (the MaxText `page_manager`
idiom): a fixed pool of `num_pages` physical KV pages of `page_size`
tokens each, handed out to decode slots and reclaimed when a request
retires.  The device never sees the free list — it sees only the dense
`(num_slots, pages_per_slot)` int32 `page_map` (unallocated entries
point at the trash page, index `num_pages`), so the decode step keeps
its shapes while requests come and go.

The device-side pools live in the model layer
(`models.attention.init_paged_kv_cache` / `paged_decode_attention`,
threaded by `models.model.paged_decode_step`); this module is pure
numpy bookkeeping, the reference's allocator line for line.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PageTable"]


@dataclasses.dataclass
class PageTable:
    """Slot -> physical-page allocator over a fixed page pool.

    num_pages: physical pages in the pool (the trash page at index
        `num_pages` is implicit and never allocated).
    page_size: tokens per page.
    num_slots: decode slots (the batched step's static batch).
    pages_per_slot: logical pages per slot row; a slot can therefore
        hold at most `pages_per_slot * page_size` tokens.
    """

    num_pages: int
    page_size: int
    num_slots: int
    pages_per_slot: int

    def __post_init__(self):
        if min(self.num_pages, self.page_size, self.num_slots,
               self.pages_per_slot) < 1:
            raise ValueError(
                f"PageTable dims must be >= 1, got {self}"
            )
        self.trash = self.num_pages
        self.page_map = np.full(
            (self.num_slots, self.pages_per_slot), self.trash, np.int32
        )
        self._free = list(range(self.num_pages - 1, -1, -1))  # pop() -> 0,1,..
        self._held = [0] * self.num_slots  # pages held per slot

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_pages / self.num_pages

    def pages_needed(self, num_tokens: int) -> int:
        return -(-max(num_tokens, 1) // self.page_size)

    def can_alloc(self, num_tokens: int) -> bool:
        need = self.pages_needed(num_tokens)
        return need <= len(self._free) and need <= self.pages_per_slot

    def alloc(self, slot: int, num_tokens: int) -> None:
        """Reserve pages for `num_tokens` tokens in `slot` (a free slot).

        Allocation is up-front for the request's full budget
        (prompt + max new tokens), so decoding never hits a mid-stream
        out-of-pages condition; callers gate admission on `can_alloc`.
        """
        if self._held[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        need = self.pages_needed(num_tokens)
        if need > self.pages_per_slot:
            raise ValueError(
                f"{num_tokens} tokens need {need} pages > pages_per_slot="
                f"{self.pages_per_slot}"
            )
        if need > len(self._free):
            raise ValueError(
                f"out of pages: need {need}, free {len(self._free)}"
            )
        for p in range(need):
            self.page_map[slot, p] = self._free.pop()
        self._held[slot] = need

    def free(self, slot: int) -> int:
        """Release `slot`'s pages back to the pool; returns pages freed."""
        held = self._held[slot]
        for p in range(held):
            self._free.append(int(self.page_map[slot, p]))
        self.page_map[slot, :] = self.trash
        self._held[slot] = 0
        return held

    def slot_pages(self, slot: int) -> int:
        return self._held[slot]
