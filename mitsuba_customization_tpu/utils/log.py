"""Logging + render statistics.

Counterpart of mitsuba3 src/core/logger.cpp (severity levels,
appenders — SURVEY.md §5.5) and the 0.6 StatsCounter/Statistics singleton
(SURVEY.md §5.1): a std-logging logger plus a process-global stats registry
printed after renders (rays traced, kernel timings), and a JSONL metrics
writer for optimization loops (loss, rays/s, grad norms — §5.5).
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict

logger = logging.getLogger("mitsuba_customization_tpu")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s [%(levelname)s] %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def set_log_level(level):
    """Trace/Debug/Info/Warn/Error — Logger::set_log_level analogue."""
    logger.setLevel(level)


class Statistics:
    """Global counters — StatsCounter/Statistics::getInstance analogue."""

    _instance = None

    def __init__(self):
        self.counters = defaultdict(int)
        self.timers = defaultdict(float)

    @classmethod
    def get(cls):
        if cls._instance is None:
            cls._instance = Statistics()
        return cls._instance

    def add(self, name, value=1):
        self.counters[name] += int(value)

    def add_time(self, name, seconds):
        self.timers[name] += float(seconds)

    def reset(self):
        self.counters.clear()
        self.timers.clear()

    def print_stats(self):
        """Statistics::printStats — dump all counters to the log."""
        for name, v in sorted(self.counters.items()):
            logger.info("stat %-40s %d", name, v)
        for name, v in sorted(self.timers.items()):
            logger.info("stat %-40s %.3fs", name, v)


class timed:
    """Context manager: accumulate wall-time into a Statistics timer."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        Statistics.get().add_time(self.name, time.perf_counter() - self.t0)
        return False


class MetricsWriter:
    """Per-step JSONL metrics for optimization loops (SURVEY.md §5.5)."""

    def __init__(self, path):
        self.f = open(path, "a", buffering=1)

    def write(self, step, **metrics):
        self.f.write(json.dumps({"step": step, "ts": time.time(), **metrics}) + "\n")

    def close(self):
        self.f.close()
