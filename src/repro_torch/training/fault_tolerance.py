"""Fault tolerance + elasticity: the port's copy of the JAX package's
``training/fault_tolerance.py`` (cluster interactions simulated; the
decision logic is host-side and the same).

  HeartbeatMonitor   -- tracks per-host liveness; flags missing hosts.
  StragglerDetector  -- per-step host timing; robust z-score quarantine.
  elastic_plan       -- shrink the data axis to the surviving host count,
                        keeping model/pod axes intact (weights survive,
                        only the batch sharding changes); a checkpoint
                        saved on one mesh restores at the new one
                        (``training/checkpoint.py``).
  CadenceController  -- adapts checkpoint frequency to observed MTBF so
                        expected lost work stays under a budget.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.config import ParallelConfig


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0):
        self.timeout = timeout_s
        self.last_seen: Dict[str, float] = {h: time.time() for h in hosts}  # repro-lint: disable=raw-wall-clock (heartbeat)

    def beat(self, host: str, t: Optional[float] = None):
        self.last_seen[host] = time.time() if t is None else t  # repro-lint: disable=raw-wall-clock (heartbeat)

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now  # repro-lint: disable=raw-wall-clock (heartbeat)
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout]

    def alive_hosts(self, now: Optional[float] = None) -> List[str]:
        dead = set(self.dead_hosts(now))
        return [h for h in self.last_seen if h not in dead]


class StragglerDetector:
    """Flags hosts whose step time is a robust outlier (median + k*MAD)."""

    def __init__(self, k: float = 4.0, window: int = 20):
        self.k = k
        self.window = window
        self.history: Dict[str, List[float]] = {}

    def record(self, host: str, step_time_s: float):
        self.history.setdefault(host, []).append(step_time_s)
        self.history[host] = self.history[host][-self.window:]

    def stragglers(self) -> List[str]:
        if len(self.history) < 3:
            return []
        means = {h: float(np.mean(v)) for h, v in self.history.items()}
        vals = np.array(list(means.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        return [h for h, m in means.items() if (m - med) / mad > self.k]


def elastic_plan(parallel: ParallelConfig, alive_hosts: int,
                 hosts_per_pod: Optional[int] = None) -> ParallelConfig:
    """Shrink the data axis to the largest power-of-two that the surviving
    hosts support.  Model axis is preserved (weight shards must all be
    present); if a model-axis host died its pod is dropped entirely.
    ``hosts_per_pod`` is read by neither package."""
    total = parallel.pods * parallel.data * parallel.model
    if alive_hosts >= total:
        return parallel
    # drop pods first if multi-pod
    pods = parallel.pods
    while pods > 1 and alive_hosts < pods * parallel.data * parallel.model:
        pods -= 1
    data = parallel.data
    while data > 1 and alive_hosts < pods * data * parallel.model:
        data //= 2
    if alive_hosts < pods * data * parallel.model:
        raise RuntimeError(
            f"cannot form a mesh: {alive_hosts} hosts < minimal "
            f"{pods * data * parallel.model}")
    return dataclasses.replace(parallel, pods=pods, data=data)


@dataclass
class CadenceController:
    """Choose checkpoint cadence so E[lost work] <= budget_steps.

    With failure rate lambda (per step) and cadence c, expected loss per
    failure ~ c/2; E[lost per step] ~ lambda * c / 2.
    """
    budget_steps: float = 10.0
    min_cadence: int = 10
    max_cadence: int = 2000
    failures: List[int] = field(default_factory=list)
    steps_seen: int = 0

    def record_steps(self, n: int = 1):
        self.steps_seen += n

    def record_failure(self):
        self.failures.append(self.steps_seen)

    def cadence(self) -> int:
        if not self.failures or self.steps_seen == 0:
            return self.max_cadence
        lam = len(self.failures) / max(self.steps_seen, 1)
        c = int(2 * self.budget_steps / max(lam, 1e-9))
        return max(self.min_cadence, min(self.max_cadence, c))
