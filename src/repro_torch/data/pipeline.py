"""Deterministic synthetic token pipeline, a numpy copy of the reference's
``repro/data/pipeline.py``: the same tokens, bit for bit, for every
``(seed, step, host)``.

A seeded, checkpointable stream (its state is the step counter, so restore
and continue reproduces the exact batch sequence), per-host shards (each
data-parallel host draws its own substream), background prefetch, and a
document mixture of bigram chains whose next-token statistics are
learnable, so a training run shows a falling loss.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections.abc import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    mixture_components: int = 8  # bigram chains to mix


class SyntheticLMStream:
    """Deterministic, sharded, checkpointable batch stream: every ``(seed,
    step, host)`` maps to one batch shard, so a restart reproduces the
    stream from the step counter alone and hosts never overlap."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide over hosts")
        self.cfg = cfg
        self.step = step
        self._mixers = self._build_mixture(cfg)

    @staticmethod
    def _build_mixture(cfg: DataConfig) -> np.ndarray:
        """Per-component bigram tables: 4 successors a token."""
        rng = np.random.default_rng(cfg.seed ^ 0xBEEF)
        k = cfg.mixture_components
        tables = np.zeros((k, cfg.vocab, 4), dtype=np.int64)
        for c in range(k):
            tables[c] = rng.integers(0, cfg.vocab, size=(cfg.vocab, 4))
        return tables

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"stream seed mismatch: {state['seed']} != {self.cfg.seed}")
        self.step = int(state["step"])

    def next_batch(self) -> dict:
        """``{"tokens": [global_batch / num_hosts, seq_len] int32}``."""
        cfg = self.cfg
        local = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, self.step, cfg.host_index]))
        comp = rng.integers(0, cfg.mixture_components, size=local)
        toks = np.empty((local, cfg.seq_len), dtype=np.int32)
        cur = rng.integers(0, cfg.vocab, size=local)
        choice = rng.integers(0, 4, size=(local, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t] = cur
            cur = self._mixers[comp, cur, choice[:, t]]
        self.step += 1
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class Prefetcher:
    """Background-thread prefetch, at most ``depth`` batches ahead, over any
    object with ``next_batch()``; :meth:`close` stops the thread."""

    def __init__(self, stream, depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.stream.next_batch()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2.0)
