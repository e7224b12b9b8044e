"""Token data pipeline: deterministic synthetic stream or memmapped file,
sharded per host.

A copy of the JAX package's ``data/pipeline.py`` (the port imports
nothing of that package) without its prefetching iterator, which no
caller uses.  It uses numpy only, so for the same
``DataConfig`` both packages give bit-identical batches.  Synthetic mode
generates a fixed-seed Zipf-ish token stream so loss curves are
reproducible across restarts (the stream position is part of the
checkpoint extras, giving exact resume).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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

    def next(self) -> dict:
        arr = self._batch_at(self.step)
        self.step += 1
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
