"""Data pipeline: deterministic synthetic stream + binary-file loader, with a
background prefetch thread (the practical straggler-mitigation lever on the
input side) and per-host sharding hooks for multi-host launches.

Copied from ``src/repro/train/data.py``, which imports no JAX: the batches
are numpy int32 arrays, byte-equal to the reference's for the same
``DataConfig`` (the synthetic stream is ``np.random.Philox`` keyed on seed,
step and host).  The caller moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None        # None -> synthetic
    host_index: int = 0
    host_count: int = 1


class TokenStream:
    """Deterministic, seekable token stream.

    Synthetic mode generates a mixed Zipf/Markov-ish stream from a counter-
    based RNG keyed on (seed, step, host): restartable at any step without
    replaying history — the property checkpoint/resume tests rely on.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._data = None
        if cfg.path:
            self._data = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        local_batch = cfg.global_batch // cfg.host_count
        if self._data is not None:
            tokens_per_batch = local_batch * (cfg.seq_len + 1)
            start = (step * cfg.host_count + cfg.host_index) * tokens_per_batch
            start = start % max(1, self._data.size - tokens_per_batch)
            chunk = np.asarray(self._data[start:start + tokens_per_batch])
            chunk = chunk.reshape(local_batch, cfg.seq_len + 1) % cfg.vocab_size
        else:
            rng = np.random.Generator(np.random.Philox(
                key=cfg.seed, counter=[0, 0, step, cfg.host_index]))
            zipf = rng.zipf(1.3, size=(local_batch, cfg.seq_len + 1))
            chunk = (zipf % cfg.vocab_size).astype(np.int32)
        return {
            "tokens": chunk[:, :-1].astype(np.int32),
            "labels": chunk[:, 1:].astype(np.int32),
        }


class PrefetchIterator:
    """Background-thread prefetch of the next ``depth`` batches."""

    def __init__(self, stream: TokenStream, start_step: int = 0, depth: int = 2):
        self.stream = stream
        self.step = start_step
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
