"""Device prefetch: overlap host->device batch transfer with device compute.

The reference hides host latency behind MXNet's threaded C++ iterator;
here the equivalent is keeping N batches in flight with ``jax.device_put``
on a background thread, so the train step never waits on PCIe transfer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import jax


def prefetch_to_device(iterable, size: int = 2, sharding=None) -> Iterator:
    """Yield batches already resident on device, ``size`` in flight.

    ``sharding`` (e.g. a batch NamedSharding) controls placement; None puts
    on the default device. If the consumer abandons the generator (train
    step raised, caller broke out), the producer thread is released instead
    of blocking forever on the full queue holding device-resident batches.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def put(batch):
        if callable(sharding):
            return sharding(batch)  # custom per-leaf placement
        if sharding is not None:
            return jax.tree.map(lambda x: jax.device_put(x, sharding), batch)
        return jax.tree.map(jax.device_put, batch)

    def offer(item) -> bool:
        # bounded put that gives up once the consumer is gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterable:
                if not offer(put(batch)):
                    return
            offer(_END)
        except BaseException as e:  # surface to the consumer, don't die silently
            offer(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)
