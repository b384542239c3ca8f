"""Synthetic deterministic LM data pipeline.

Port of ``repro/data/pipeline.py`` (numpy only), copied: the reference's
package ``__init__`` imports jax, so the port keeps its own copy.  The
tokens equal the reference's bit for bit for every ``(seed, step,
shard)``.

Production-shaped: host-sharded (each process generates only its slice of
the global batch), deterministic in (seed, step, shard) so restarts resume
bit-identically mid-stream, with a background double-buffered prefetcher.
The "dataset" is a reproducible token stream with local n-gram structure
(so a ~100M model actually learns and the example-run loss curve means
something) — swapping in a real tokenized corpus only changes
``_tokens_for``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLMData", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1      # data-parallel host shards
    shard_id: int = 0


class SyntheticLMData:
    """Deterministic structured token stream (order-2 markov-ish)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_shards
        # a fixed random "transition" table gives the stream learnable
        # structure; identical on every host (derived from seed only)
        r = np.random.default_rng(cfg.seed)
        self._next = r.integers(0, cfg.vocab_size,
                                size=(cfg.vocab_size, 4), dtype=np.int32)

    def _tokens_for(self, step: int) -> np.ndarray:
        cfg = self.cfg
        r = np.random.default_rng(
            (cfg.seed, step, self.cfg.shard_id, 0xDA7A))
        B, S = self.local_batch, cfg.seq_len
        out = np.empty((B, S), np.int32)
        out[:, 0] = r.integers(0, cfg.vocab_size, size=B)
        branch = r.integers(0, 4, size=(B, S))
        noise = r.random((B, S))
        rand_tok = r.integers(0, cfg.vocab_size, size=(B, S))
        for t in range(1, S):
            follow = self._next[out[:, t - 1], branch[:, t]]
            out[:, t] = np.where(noise[:, t] < 0.1, rand_tok[:, t], follow)
        return out

    def batch(self, step: int) -> dict:
        toks = self._tokens_for(step)
        return {"tokens": toks, "labels": toks.copy()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background thread keeping ``depth`` batches ready."""

    def __init__(self, source: SyntheticLMData, start_step: int = 0,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def work():
            s = start_step
            while not self._stop.is_set():
                b = source.batch(s)
                while not self._stop.is_set():
                    try:
                        self._q.put((s, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
