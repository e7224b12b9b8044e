"""Token data pipeline: deterministic synthetic stream or memmapped file,
sharded per host, with background prefetch.

A copy of the JAX package's ``data/pipeline.py`` (the port imports
nothing of that package).  It uses numpy only, so for the same
``DataConfig`` both packages give bit-identical batches.  Synthetic mode
generates a fixed-seed Zipf-ish token stream so loss curves are
reproducible across restarts (the stream position is part of the
checkpoint extras, giving exact resume).

The prefetching iterator differs from JAX's on purpose: JAX's worker
advances the stream and drops the batch it built whenever the queue
stays full for 0.5 s, so a slow consumer skips steps, and ``state()``
reads the producer's position.  Here the worker keeps a batch until it
is queued, and ``state()`` is the position after the last batch yielded.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    host_count: int = 1
    host_index: int = 0
    seed: int = 1234
    path: Optional[str] = None       # memmap .bin (uint16) if set
    prefetch: int = 2                # batches the iterator builds ahead


class TokenPipeline:
    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        if cfg.global_batch % cfg.host_count:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of host_count {cfg.host_count}")
        self.local_batch = cfg.global_batch // cfg.host_count
        self.step = start_step
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.uint16, mode="r")

    # -- deterministic access ------------------------------------------
    def _batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        if self._mm is not None:
            n_tok = cfg.seq_len + 1
            total = self.local_batch * n_tok
            start = ((step * cfg.global_batch + cfg.host_index
                      * self.local_batch) * n_tok) % (len(self._mm) - total)
            flat = np.asarray(self._mm[start:start + total])
            return flat.reshape(self.local_batch, n_tok).astype(np.int32)
        rng = np.random.default_rng((cfg.seed, step, cfg.host_index))
        # zipf-ish distribution clipped to vocab
        z = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
        return (z % cfg.vocab_size).astype(np.int32)

    def _example(self, step: int) -> dict:
        arr = self._batch_at(step)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def next(self) -> dict:
        batch = self._example(self.step)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])

    # -- prefetching iterator -------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        """``next()``'s batches from the current step on, built ahead by
        a worker thread (at most ``cfg.prefetch`` waiting).  Closing the
        generator stops the worker; an error in the worker is raised
        here."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def put(item) -> None:          # until queued or stopped
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def worker(step: int):
            try:
                while not stop.is_set():
                    put((step, self._example(step)))
                    step += 1
            except Exception as e:      # handed to the consumer
                put((None, e))

        t = threading.Thread(target=worker, args=(self.step,), daemon=True)
        t.start()
        try:
            while True:
                step, batch = q.get()
                if step is None:
                    raise batch
                self.step = step + 1
                yield batch
        finally:
            stop.set()
            t.join()
