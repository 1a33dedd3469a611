"""Data pipeline: deterministic synthetic LM streams + memmap token-bin
files.  Both are host-shardable (disjoint slices per host), checkpointable
(state dicts), and prefetch via a background thread.

Port of ``repro/data/pipeline.py``, the port's own copy (numpy only): the
same seeds give the same batches, bit for bit, as the JAX package's.
``DataConfig`` :17, ``SyntheticLM`` :27, ``BinTokenDataset`` :64,
``Prefetcher`` :104 and ``write_bin`` :130.  Batches are numpy int32
arrays; the train step's caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    batch_size: int                 # per-host batch
    seq_len: int
    vocab_size: int
    host_index: int = 0
    host_count: int = 1
    seed: int = 0


class SyntheticLM:
    """Deterministic pseudo-text: Zipfian tokens from a counter-based PRNG;
    identical across restarts given the same state (step counter)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0
        # zipf-ish distribution over the vocab (real text is far from
        # uniform — this also makes the loss actually decrease)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])

    def next_batch(self) -> dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, c.host_index, self.step]))
        tok = rng.choice(c.vocab_size, size=(c.batch_size, c.seq_len + 1),
                         p=self.p).astype(np.int32)
        # inject learnable bigram structure: every even position repeats
        tok[:, 1::2] = (tok[:, 0::2][:, :tok[:, 1::2].shape[1]] + 1) % c.vocab_size
        self.step += 1
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class BinTokenDataset:
    """Flat binary token file (uint16/uint32), memmap'd; hosts read disjoint
    strided windows; sequential within a host for locality.  Exact-resume
    via (epoch, cursor)."""

    def __init__(self, path: str | Path, cfg: DataConfig,
                 dtype: str = "uint16"):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        need = cfg.batch_size * (cfg.seq_len + 1)
        self.per_host = (len(self.tokens) // cfg.host_count) // need * need
        if self.per_host == 0:
            raise ValueError("dataset smaller than one host batch")
        self.base = cfg.host_index * (len(self.tokens) // cfg.host_count)
        self.cursor = 0
        self.epoch = 0

    def state_dict(self) -> dict:
        return {"cursor": self.cursor, "epoch": self.epoch}

    def load_state_dict(self, s: dict) -> None:
        self.cursor = int(s["cursor"])
        self.epoch = int(s["epoch"])

    def next_batch(self) -> dict[str, np.ndarray]:
        c = self.cfg
        need = c.batch_size * (c.seq_len + 1)
        if self.cursor + need > self.per_host:
            self.cursor = 0
            self.epoch += 1
        start = self.base + self.cursor
        flat = np.asarray(self.tokens[start:start + need], dtype=np.int32)
        self.cursor += need
        tok = flat.reshape(c.batch_size, c.seq_len + 1)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class Prefetcher:
    """Background-thread prefetch with a bounded queue."""

    def __init__(self, src, depth: int = 2):
        self.src = src
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        it = iter(self.src)
        while not self.stop.is_set():
            try:
                self.q.put(next(it), timeout=0.5)
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self.stop.set()


def write_bin(path: str | Path, tokens: np.ndarray,
              dtype: str = "uint16") -> None:
    np.asarray(tokens, dtype=dtype).tofile(path)
