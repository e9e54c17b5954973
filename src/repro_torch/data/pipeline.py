"""Deterministic sharded data pipeline (a copy of the reference's
``repro.data.pipeline``, numpy only: its batches equal the reference's
byte for byte).

Design constraints for 1000+ node training (DESIGN.md §5):

  * **Stateless addressing** — batch `step` for host `h` of `H` is a pure
    function of (seed, step, h, H): restart/elastic-rescale needs no data
    checkpoints; a run resumed on a different host count replays no example
    twice within an epoch window.
  * **Host-sharded** — every host materializes only its `global_batch / H`
    slice (single-process here, but the addressing is multi-host).
  * **Double-buffered** — a background thread prefetches the next batch while
    the step runs (overlap host compute with device compute).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.synthetic import synthetic_corpus
from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    corpus_bytes: int = 1 << 20
    host_id: int = 0
    n_hosts: int = 1
    prefetch: int = 2

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} must be a "
                             f"multiple of n_hosts {self.n_hosts}")


class ShardedLoader:
    """Deterministic loader over a byte corpus, host-sharded + prefetched."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tok = ByteTokenizer()
        corpus = synthetic_corpus(cfg.corpus_bytes, seed=cfg.seed)
        self._ids = np.frombuffer(corpus, np.uint8).astype(np.int32)
        self._n_windows = len(self._ids) - cfg.seq_len - 1
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- stateless batch addressing ---------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Host-local batch for global `step` (pure function of step)."""
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        # per-(step,row) deterministic window offsets (splitmix64, uint64)
        row0 = cfg.host_id * per_host
        rows = np.arange(row0, row0 + per_host, dtype=np.uint64)
        with np.errstate(over="ignore"):
            mix = (np.uint64(step) * np.uint64(0x9E3779B97F4A7C15)
                   + rows * np.uint64(0xBF58476D1CE4E5B9)
                   + np.uint64(cfg.seed))
            mix = (mix ^ (mix >> np.uint64(31))) \
                * np.uint64(0x94D049BB133111EB)
        offs = (mix % np.uint64(self._n_windows)).astype(np.int64)
        tokens = np.stack([self._ids[o:o + cfg.seq_len] for o in offs])
        labels = np.stack([self._ids[o + 1:o + 1 + cfg.seq_len] for o in offs])
        return {"tokens": tokens, "labels": labels}

    # -- prefetching iterator ----------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate(start_step=0)

    def iterate(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetched stream starting at `start_step` (resume-aware)."""
        self._q = queue.Queue(maxsize=self.cfg.prefetch)
        self._stop.clear()

        def producer():
            step = start_step
            try:
                while not self._stop.is_set():
                    batch = self.batch_at(step)
                    while not self._stop.is_set():
                        try:
                            self._q.put(("ok", batch), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    step += 1
            except BaseException as e:  # propagate, never hang the consumer
                self._q.put(("err", e))

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()
        try:
            while True:
                kind, payload = self._q.get()
                if kind == "err":
                    raise payload
                yield payload
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self._q is not None:
            try:  # unblock the producer
                self._q.get_nowait()
            except queue.Empty:
                pass
