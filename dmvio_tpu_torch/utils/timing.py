"""Named RAII wall-clock profiling scopes.

Equivalent of dmvio::TimeMeasurement (src/util/
TimeMeasurement.h:36-87): `with TimeMeasurement("name"):` accumulates
count/mean/max/var per name; `save_results(path)` writes the same
timings.txt the reference dumps at shutdown (main_dmvio_dataset.cpp:302).
"""

from __future__ import annotations

import threading
import time
from typing import Dict


_SAMPLE_CAP = 1024   # raw samples kept per name (median/percentiles)


class _Stat:
    __slots__ = ("n", "mean", "m2", "max", "samples")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.max = 0.0
        self.samples = []

    def add(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)
        self.max = max(self.max, x)
        if len(self.samples) < _SAMPLE_CAP:
            self.samples.append(x)

    @property
    def var(self):
        return self.m2 / self.n if self.n > 1 else 0.0

    @property
    def median(self):
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[len(s) // 2]


_stats: Dict[str, _Stat] = {}
_lock = threading.Lock()


class TimeMeasurement:
    """RAII scope timer; also usable via .end() like the reference."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self._ended = False

    def end(self):
        if self._ended:
            return
        self._ended = True
        dt = time.perf_counter() - self.t0
        with _lock:
            _stats.setdefault(self.name, _Stat()).add(dt)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def save_results(path: str) -> None:
    with _lock:
        with open(path, "w") as f:
            f.write("name num mean(s) max(s) var\n")
            for name in sorted(_stats):
                s = _stats[name]
                f.write(f"{name} {s.n} {s.mean:.6f} {s.max:.6f} "
                        f"{s.var:.9f}\n")


def reset() -> None:
    with _lock:
        _stats.clear()


def get_stats() -> Dict[str, dict]:
    with _lock:
        return {k: {"n": v.n, "mean": v.mean, "max": v.max, "var": v.var,
                    "median": v.median, "samples": list(v.samples)}
                for k, v in _stats.items()}
