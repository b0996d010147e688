"""A closed loop with one client: back-to-back batches from host memory.

The client holds the mix's distinct batches as host numpy arrays, calls the
step on one, writes the answers (vertices, camera) into host numpy arrays
of its own, and only then sends the next batch, cycling over the batches:
an offline job that fills its result arrays as it goes.  The result arrays
are allocated once, before the window; a batch whose answers the check
reads gets arrays of its own, the others share one set.

No batch starts after ``seconds``; the window closes when the batch in
flight then has returned, so the rate counts all the work and all the time
of the window.
"""
from __future__ import annotations

import sys
import time
import traceback
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch


def _host_like(outputs) -> tuple:
    """Host arrays shaped as the step's outputs, their pages touched."""
    return tuple(torch.zeros(t.shape, dtype=t.dtype).numpy()
                 for t in outputs)


class Client:
    """One client over ``batches``.  Its first batch sizes the shared result
    arrays, so it warms up before it measures."""

    def __init__(self, step: Callable, batches: Sequence[np.ndarray]):
        self.step = step
        self.batches = batches
        self.scratch: Optional[tuple] = None

    def write(self, outputs, dst: tuple) -> tuple:
        """Copy the step's outputs into the host arrays ``dst``."""
        for d, t in zip(dst, outputs):
            torch.from_numpy(d).copy_(t)
        return dst

    def run(self, seconds: float, keep: Iterable[int] = (),
            max_batches: Optional[int] = None,
            after_batch: Callable[[], None] = lambda: None) -> Dict:
        """-> {"seconds", "frames", "attempted", "failed", "batches",
        "kept": [(batch number, distinct batch index, host outputs)]} for
        the batch numbers in ``keep`` and the last batch.
        ``max_batches`` ends the loop early; ``after_batch`` runs after
        each batch."""
        stores = {k: tuple(np.zeros_like(a) for a in self.scratch)
                  for k in keep} if self.scratch is not None else {}
        if keep and not stores:
            raise RuntimeError("warm the client up before keeping answers")
        kept: List = []
        last = None
        frames = attempted = failed = n = 0
        t0 = time.perf_counter()
        t_end = t0
        while (time.perf_counter() - t0 < seconds
               and (max_batches is None or n < max_batches)):
            i = n % len(self.batches)
            attempted += len(self.batches[i])
            try:
                outputs = self.step(self.batches[i])
                if self.scratch is None:           # the first call sizes them
                    self.scratch = _host_like(outputs)
                outs = self.write(outputs, stores.get(n, self.scratch))
            except Exception:  # a failed batch counts; the loop goes on
                failed += len(self.batches[i])
                traceback.print_exc(file=sys.stderr)
                outs = None
            t_end = time.perf_counter()
            if outs is not None:
                frames += len(self.batches[i])
                last = (n, i, outs)
                if n in stores:
                    kept.append(last)
            n += 1
            after_batch()
        if last is not None and last[2] is self.scratch:
            kept.append((last[0], last[1], tuple(a.copy() for a in last[2])))
        return {"seconds": t_end - t0, "frames": frames,
                "attempted": attempted, "failed": failed, "batches": n,
                "kept": kept}
