"""Token data pipeline: a deterministic synthetic LM stream and a
memmap-backed binary corpus, numpy only (the reference's, batch for
batch).

Determinism contract (fault tolerance): batch contents are a pure
function of (seed, step), so a restart that resumes from checkpoint
step S reproduces the exact training stream — no data-loader state in
the checkpoint.  Batches are host numpy arrays; the train steps place
them on their device.  On a process mesh each rank takes its own block
of a batch with `shard_batch`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM", "MemmapCorpus", "shard_batch", "shard_slice",
           "write_synthetic_corpus"]


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-distributed token stream with document structure (BOS=0,
    in-doc Markov-ish correlation so the loss is learnable)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        ranks = rng.zipf(1.3, size=(B, S + 1))
        tokens = np.clip(ranks, 1, self.vocab_size - 1).astype(np.int64)
        # learnable structure: with prob .3 copy the token `shift` back
        shift = int(rng.integers(1, 4))
        rep = rng.uniform(size=(B, S + 1)) < 0.3
        rep[:, :shift] = False
        src = np.roll(tokens, shift, axis=1)
        tokens[rep] = src[rep]
        # document boundaries
        bos = rng.uniform(size=(B, S + 1)) < (1.0 / self.mean_doc_len)
        tokens[bos] = 0
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class MemmapCorpus:
    """Flat uint16/uint32 token file; batches are strided windows chosen
    by a seeded permutation (production-style binary corpus reader)."""

    path: str
    seq_len: int
    global_batch: int
    seed: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._num_windows = (len(self._data) - 1) // self.seq_len
        if self._num_windows < self.global_batch:
            raise ValueError(
                f"corpus too small: {self._num_windows} windows "
                f"< batch {self.global_batch}"
            )

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self._num_windows, self.global_batch)
        starts = idx * self.seq_len
        toks = np.stack(
            [self._data[s : s + self.seq_len + 1] for s in starts]
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def write_synthetic_corpus(path: str, num_tokens: int, vocab_size: int,
                           seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    toks = np.clip(rng.zipf(1.3, num_tokens), 1, vocab_size - 1).astype(np.uint16)
    tmp = path + ".tmp"
    toks.tofile(tmp)
    os.replace(tmp, path)
    return path


def shard_slice(size: int, mesh, dp_axes) -> slice:
    """This rank's contiguous block of a leading dim of `size` split over
    the mesh dims `dp_axes`, picked by its row-major coordinates there."""
    from ..dist.collectives import axis_index, axis_size

    n = axis_size(mesh, dp_axes)
    if size % n:
        raise ValueError(f"a leading dim of {size} does not split into "
                         f"{n} blocks over {dp_axes}")
    block = size // n
    i = axis_index(mesh, dp_axes)
    return slice(i * block, (i + 1) * block)


def shard_batch(batch: dict, mesh, dp_axes) -> dict:
    """This rank's block of a host batch: the leading (batch) dim of
    each leaf split over the mesh dims `dp_axes` (numpy in, numpy out),
    the block the reference's `shard_batch` places on this device."""
    return {k: v[shard_slice(v.shape[0], mesh, dp_axes)]
            for k, v in batch.items()}
