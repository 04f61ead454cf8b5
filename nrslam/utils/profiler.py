"""Wall-clock stage profiler (actually wired in, unlike the reference's).

The reference ships a TimeProfiler (utilities/time_profiler.{h,cc}) that is
constructed and threaded through Tracking/Mapping but never invoked
(SURVEY.md §5). This one is used by the CLI: named tic/toc with mean/sigma
statistics and a file dump.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class TimeProfiler:
    def __init__(self):
        self._open = {}
        self._samples = defaultdict(list)

    def tic(self, name: str):
        self._open[name] = time.perf_counter()

    def toc(self, name: str) -> float:
        dt = time.perf_counter() - self._open.pop(name)
        self._samples[name].append(dt)
        return dt

    @contextlib.contextmanager
    def section(self, name: str):
        self.tic(name)
        try:
            yield
        finally:
            self.toc(name)

    def samples(self, name: str) -> list:
        """Every recorded duration of ``name``, in seconds, in order."""
        return list(self._samples[name])

    def statistics(self):
        # median_ms is the steady-state measure: the first samples of each
        # process pay one-off compile costs, which dominate the mean.
        return {name: dict(mean_ms=float(np.mean(s) * 1e3),
                           median_ms=float(np.median(s) * 1e3),
                           sigma_ms=float(np.std(s) * 1e3),
                           count=len(s))
                for name, s in self._samples.items()}

    def save_statistics_to_file(self, path: str):
        with open(path, "w") as f:
            for name, st in sorted(self.statistics().items()):
                f.write(f"{name}: mean {st['mean_ms']:.3f} ms "
                        f"sigma {st['sigma_ms']:.3f} ms n={st['count']}\n")
