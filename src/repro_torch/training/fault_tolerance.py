"""Fault-tolerance hooks the training CLI uses.

Own copies of the JAX package's ``StragglerDetector`` and
``CadenceController`` (``training/fault_tolerance.py``): the decision
logic is host-side numpy and the same.  ``HeartbeatMonitor`` and the
elastic restore are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


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
