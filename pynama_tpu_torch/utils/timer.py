"""Wall-clock timing utilities.

A copy of pynama_tpu/utils/timer.py: tic/toc and named phase
accumulation for per-stage profiling (setup / solve / rhs / io). Host
clock only: time device work after ``torch.cuda.synchronize()``.
"""

import time
from collections import defaultdict
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self._t0 = None
        self.phases = defaultdict(float)
        self.counts = defaultdict(int)

    def tic(self):
        self._t0 = time.perf_counter()
        return self

    def toc(self):
        """Seconds since the last tic."""
        return time.perf_counter() - self._t0

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        lines = [f"{k:>12}: {v:9.3f}s /{self.counts[k]:5d} calls"
                 for k, v in sorted(self.phases.items())]
        return "\n".join(lines)
