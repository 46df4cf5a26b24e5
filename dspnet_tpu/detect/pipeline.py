"""Throughput-oriented serving pipeline.

The synchronous `Detector.predict` path pays one full host<->device round
trip per call. JAX dispatch is asynchronous: `predict` returns device
arrays that are futures, so keeping a small window of calls in flight and
materializing results one window behind overlaps each call's H2D +
compute + D2H with its neighbors, without changing results. Its gain on
the GPU is not measured yet (ROADMAP S4).

Usage (video/stream serving):

    pipe = ServingPipeline(detector, depth=2)
    for frame in frames:
        out = pipe.submit(frame)          # returns an OLDER frame's result
        if out is not None:               # (None while the window fills)
            frame_i, res = out
            ...
    for frame_i, res in pipe.drain():     # flush the tail
        ...

Results come back strictly in submission order, paired with the caller's
tag, and are bit-identical to the synchronous path (same jitted program).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterator, Optional, Tuple

import numpy as np

from dspnet_tpu.detect.detector import start_d2h as _start_d2h


class ServingPipeline:
    """Bounded-depth asynchronous wrapper over a :class:`Detector`.

    ``depth``: in-flight window (2 hides one call's latency behind the
    next; bigger helps only when transport jitter exceeds compute).
    ``raw=True`` feeds ``predict_raw`` (uint8 BGR in, normalize on device
    — 4x less H2D than f32); ``raw=False`` feeds preprocessed floats to
    ``predict``.
    """

    def __init__(self, detector, depth: int = 2, raw: bool = True):
        assert depth >= 1
        self.detector = detector
        self.depth = depth
        self.raw = raw
        self._inflight: deque = deque()
        self._seq = 0

    def __len__(self) -> int:
        return len(self._inflight)

    def submit(self, frame: np.ndarray, tag: Any = None
               ) -> Optional[Tuple[Any, dict]]:
        """Dispatch one frame (H, W, 3) or batch (B, H, W, 3); returns the
        OLDEST completed (tag, results) once the window is full, else None.
        ``tag`` defaults to a running submission index."""
        if frame.ndim == 3:
            frame = frame[None]
        if tag is None:
            tag = self._seq
        self._seq += 1
        res = (self.detector.predict_raw if self.raw
               else self.detector.predict)(frame)
        # res leaves are un-materialized device arrays (dispatch already
        # returned); holding them here is what keeps the device queue full.
        # Start their D2H NOW: copy_to_host_async lands the bytes in the
        # background, so the later np.asarray finds them on the host
        _start_d2h(res)
        self._inflight.append((tag, res))
        if len(self._inflight) > self.depth:
            return self._materialize(self._inflight.popleft())
        return None

    def drain(self) -> Iterator[Tuple[Any, dict]]:
        """Yield the remaining (tag, results) in order."""
        while self._inflight:
            yield self._materialize(self._inflight.popleft())

    @staticmethod
    def _materialize(item):
        tag, res = item
        return tag, {k: np.asarray(v) for k, v in res.items()}
