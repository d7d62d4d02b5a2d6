"""Deterministic, shardable synthetic token pipeline (the port's own copy
of ``repro.data.pipeline``: numpy only, so both packages draw identical
batches from the same seed).

Design goals (the properties a real pipeline must have for fault tolerance):
  * STATELESS indexing: batch(i) is a pure function of (seed, step) — restart
    from a checkpointed step reproduces the exact stream, no data loss or
    duplication after failover;
  * per-host sharding: each data-parallel host materializes only its slice;
  * structure, not noise: sequences follow a mixture of integer-sequence
    "tasks" (arithmetic progressions, repeats, copy patterns) so a small LM's
    loss actually decreases — used by ``repro_torch.train.tiny_lm``.

Batches are numpy int32 arrays; the train loop moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


def _sequence(rng: np.random.Generator, seq_len: int, vocab: int) -> np.ndarray:
    """One synthetic sequence from a task mixture."""
    task = rng.integers(0, 4)
    v = vocab - 1
    if task == 0:    # arithmetic progression mod vocab
        start, step = rng.integers(1, v), rng.integers(1, 7)
        return (start + step * np.arange(seq_len)) % v
    if task == 1:    # repeated motif
        m = rng.integers(2, 9)
        motif = rng.integers(1, v, size=m)
        return np.tile(motif, seq_len // m + 1)[:seq_len]
    if task == 2:    # copy: first half random, second half copies
        half = (seq_len + 1) // 2
        head = rng.integers(1, v, size=half)
        return np.concatenate([head, head])[:seq_len]
    # noise with a sticky state (markov-ish)
    out = np.empty(seq_len, dtype=np.int64)
    cur = rng.integers(1, v)
    for i in range(seq_len):
        if rng.random() < 0.2:
            cur = rng.integers(1, v)
        out[i] = cur
    return out


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The canonical access path: (seed, step, host) -> local batch."""
    out_tokens = np.empty((cfg.local_batch, cfg.seq_len + 1), dtype=np.int64)
    for i in range(cfg.local_batch):
        global_row = step * cfg.global_batch + cfg.host_id * cfg.local_batch + i
        rng = np.random.default_rng((cfg.seed, global_row))
        out_tokens[i] = _sequence(rng, cfg.seq_len + 1, cfg.vocab_size)
    tokens = out_tokens[:, :-1].astype(np.int32)
    labels = out_tokens[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
