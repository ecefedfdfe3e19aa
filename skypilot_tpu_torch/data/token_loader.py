"""Token data loader, numpy path (port of the numpy route of
skypilot_tpu/data/token_loader.py).

Binary token shards (nanoGPT-style .bin of uint16 or uint32) become
[batch, seq+1] uint32 arrays, deterministic per (seed, step, rank) so
data-parallel hosts draw disjoint streams: the same shard format,
`rank`/`world` split and window order as the reference's numpy path.
The reference's native mmap+prefetch reader (native/token_loader.cpp)
waits for a later slice (ROADMAP A11).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


class TokenLoader:
    """Iterates [batch, seq+1] uint32 batches from token shard files."""

    def __init__(self, shard_paths: Sequence[str], batch: int, seq: int,
                 *, seed: int = 0, rank: int = 0, world: int = 1,
                 shuffle: bool = True, dtype_bytes: int = 2) -> None:
        self.paths = [os.path.abspath(os.path.expanduser(p))
                      for p in shard_paths]
        for p in self.paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self.batch, self.seq = batch, seq
        self.seed, self.rank, self.world = seed, rank, world
        self.shuffle = shuffle
        dt = np.uint16 if dtype_bytes == 2 else np.uint32
        self._arrays = [np.memmap(p, dtype=dt, mode='r') for p in self.paths]
        self._cum = np.cumsum([0] + [len(a) for a in self._arrays])
        self.total_tokens = int(self._cum[-1])
        if seq + 1 >= self.total_tokens:
            raise ValueError('dataset smaller than one window')
        self._step = 0

    def _window(self, start: int, count: int) -> np.ndarray:
        out = np.empty(count, np.uint32)
        filled = 0
        while filled < count:
            shard = int(np.searchsorted(self._cum, start + filled,
                                        side='right')) - 1
            off = start + filled - self._cum[shard]
            take = min(count - filled, len(self._arrays[shard]) - int(off))
            out[filled:filled + take] = self._arrays[shard][off:off + take]
            filled += take
        return out

    def next_batch(self) -> np.ndarray:
        """[batch, seq+1] uint32; inputs = [:, :-1], targets = [:, 1:]."""
        step = self._step
        self._step += 1
        out = np.empty((self.batch, self.seq + 1), np.uint32)
        n_windows = self.total_tokens // self.seq
        for b in range(self.batch):
            if self.shuffle:
                rng = np.random.default_rng([self.seed, step, self.rank, b])
                start = int(rng.integers(0, self.total_tokens - self.seq - 1))
            else:
                window = (step * self.world + self.rank) * self.batch + b
                start = (window % n_windows) * self.seq
                start = min(start, self.total_tokens - self.seq - 1)
            out[b] = self._window(start, self.seq + 1)
        return out
