"""Tracing / profiling / throughput observability.

Replaces the reference's monitoring hooks with JAX equivalents
(SURVEY.md section 5):

* per-op shape/stat monitor (``stat_helper`` executor callbacks,
  multi_solver.py:262-280) -> :func:`tensor_stats` pytree summarizer +
  :class:`StatMonitor`;
* wall-clock timers + Speedometer throughput logging
  (multi_solver.py:401-404, mx.callback.Speedometer) -> :class:`Speedometer`;
* deterministic-timing env toggles (run_multi.sh:5-7) -> XLA profiler traces
  via :func:`trace` (view in TensorBoard / xprof).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/dspnet_trace"):
    """jax.profiler trace context (device timeline, HLO, memory)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def tensor_stats(tree, prefix: str = "", name_filter=None) -> Dict[str, str]:
    """Per-leaf shape/mean/std summary of a pytree (stat_helper equivalent).

    ``name_filter(name) -> bool`` is applied BEFORE fetching a leaf: each
    np.asarray is a serial device->host round trip, so non-matching leaves
    must never be pulled."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        if name_filter is not None and not name_filter(name):
            continue
        arr = np.asarray(leaf)
        out[name] = f"shape={arr.shape} mean={arr.mean():.5f} std={arr.std():.5f}"
    return out


class StatMonitor:
    """Periodic parameter/gradient stats logger (mx.mon.Monitor equivalent,
    multi_train.py:76-79,379)."""

    def __init__(self, interval: int = 100, pattern: str = ".*", logger=None):
        import re

        self.interval = interval
        self.rx = re.compile(pattern)
        self.log = (logger or logging.getLogger()).info
        self._step = 0

    def tic_toc(self, tree):
        self._step += 1
        if self._step % self.interval:
            return
        # filter by path BEFORE fetching: only matching leaves pay the D2H
        for name, stat in tensor_stats(tree, name_filter=self.rx.search).items():
            self.log("monitor %s %s", name, stat)


class Speedometer:
    """Throughput callback: logs samples/sec every ``frequent`` batches."""

    def __init__(self, batch_size: int, frequent: int = 20, logger=None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.log = (logger or logging.getLogger()).info
        self.count = 0
        self.tic = time.time()

    def __call__(self, epoch: int, metrics: Dict | None = None):
        self.count += 1
        if self.count % self.frequent == 0:
            speed = self.frequent * self.batch_size / (time.time() - self.tic)
            extra = ""
            if metrics:
                extra = " " + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            self.log("Epoch[%d] Batch [%d] Speed: %.2f samples/sec%s",
                     epoch, self.count, speed, extra)
            self.tic = time.time()


class StepTimer:
    """Per-step wall-clock timing with aggregation (eval loop's ms/batch,
    multi_eval.py:311-318)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.total / max(self.count, 1)
