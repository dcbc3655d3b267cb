"""Step-time monitoring and straggler detection (copy of
``repro/train/monitor.py``).

Mesh-Attention's lock-step symmetric schedule (paper §3.2) removes
*algorithmic* stragglers — every device executes identical work — so any
persistent outlier is a *hardware* straggler.  The monitor keeps an EMA and
EW-variance of step times and flags steps beyond ``k`` sigma; the policy
decides between logging, requesting a checkpoint, or excluding the node and
re-meshing through the elastic-restart path (in the JAX package's
train/loop.py; the port's comes with multi-process training).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

__all__ = ["StragglerPolicy", "StepMonitor"]


@dataclasses.dataclass
class StragglerPolicy:
    sigma: float = 4.0
    patience: int = 3  # consecutive slow steps before escalation
    action: str = "log"  # log | checkpoint | remesh


class StepMonitor:
    def __init__(self, policy: Optional[StragglerPolicy] = None, decay: float = 0.95):
        self.policy = policy or StragglerPolicy()
        self.decay = decay
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.count = 0
        self._consecutive = 0
        self.events: List[dict] = []

    def record(self, dt: float) -> Optional[str]:
        """Record one step time; returns an escalation action or None."""
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return None
        slow = self.is_straggler(dt)
        d = self.decay
        delta = dt - self.mean
        self.mean += (1 - d) * delta
        self.var = d * (self.var + (1 - d) * delta * delta)
        if not slow:
            self._consecutive = 0
            return None
        self._consecutive += 1
        self.events.append({"step": self.count, "dt": dt, "mean": self.mean})
        if self._consecutive >= self.policy.patience:
            self._consecutive = 0
            return self.policy.action
        return None

    def is_straggler(self, dt: float) -> bool:
        if self.mean is None or self.count < 5:
            return False
        sd = math.sqrt(max(self.var, 1e-12))
        return dt > self.mean + self.policy.sigma * max(sd, 0.05 * self.mean)
