"""Wall-clock instrumentation: ``Phases``, named per-phase accumulating
timers with a summary table.

Enable phase timing with TROPICAL_PROFILE=1.  The phases time the host
clock; each phase this package wraps ends in a host read of device data
(a count, a mask, a float), so queued CUDA work is inside the phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

PROFILE = bool(int(os.environ.get("TROPICAL_PROFILE", "0")))


class Phases:
    """Accumulating named timers: ``with phases('forward'): ...``."""

    def __init__(self):
        self.enabled = PROFILE
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t
            self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return ""
        width = max(len(k) for k in self.totals)
        lines = ["phase timing:"]
        for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<{width}}  {v:8.3f}s  x{self.counts[k]}")
        return "\n".join(lines)

    def report(self):
        if self.enabled and self.totals:
            print(self.summary())
