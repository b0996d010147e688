"""Spans on the profiler's clock, and per-stage timing (port of
``tpubody.utils.profiling``).

:func:`span` marks a layer boundary of the program.  While no
``torch.profiler`` session records it does nothing but read one flag.
While one records, it opens a ``record_function`` range, so that the span
lands in the profiler's trace on the kernels' clock (a ``user_annotation``
host range and, on the card, a ``gpu_user_annotation`` device range), and
keeps a record: the name, the span's id, its parent's and its root's ids
(a stack per thread), the host's ``perf_counter_ns`` at enter and exit and
a CUDA event pair on the current stream.  Nothing synchronises while spans
are recorded.  :func:`spans` resolves the kept records once, after one
synchronisation; :func:`clear` empties the store, which keeps the newest
:data:`MAX_ROOTS` roots.

:class:`StageTimer` times stages with a device synchronisation at each end
and opens a span for each, so that its stages appear in the profiler
session that an operator runs.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_ROOTS = 64
# The flag torch sets while a profiler session records (not during its
# warm-up).  A disabled ``record_function`` costs about twenty times the
# read of this flag, so the flag is read first.
_profiler = torch.autograd.profiler
_NULL = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "e0", "e1",
                 "resolved")

    def __init__(self, name: str, id_: int, parent: Optional[int],
                 root: int):
        self.name, self.id, self.parent, self.root = name, id_, parent, root
        self.t0 = self.t1 = self.e0 = self.e1 = None
        self.resolved: Optional[dict] = None


class _Stack(threading.local):
    """The open spans of one thread, innermost last."""

    def __init__(self):
        self.open: List[_Record] = []


class _Store:
    """The records of the newest ``max_roots`` roots, by root."""

    def __init__(self, max_roots: int):
        self.max_roots = max_roots
        self.lock = threading.Lock()
        self.roots: "collections.OrderedDict[int, List[_Record]]" = (
            collections.OrderedDict())
        self.ids = itertools.count()
        self.local = _Stack()

    def open(self, name: str) -> _Record:
        stack = self.local.open
        with self.lock:
            id_ = next(self.ids)
            if stack:
                rec = _Record(name, id_, stack[-1].id, stack[-1].root)
                self.roots.setdefault(rec.root, []).append(rec)
            else:
                rec = _Record(name, id_, None, id_)
                self.roots[id_] = [rec]
                while len(self.roots) > self.max_roots:
                    self.roots.popitem(last=False)
        stack.append(rec)
        return rec


STORE = _Store(MAX_ROOTS)


def _event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "rec", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fn = _profiler.record_function(self.name)
        self.fn.__enter__()
        self.rec = STORE.open(self.name)
        self.rec.t0 = time.perf_counter_ns()
        self.rec.e0 = _event()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.e1 = _event()
        rec.t1 = time.perf_counter_ns()
        STORE.local.open.pop()
        self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work: a shared null context
    while no profiler records, else a recorded span named ``name``."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def _resolve(rec: _Record, root: _Record) -> dict:
    """One closed record -> its times in ms; the device's start and end are
    relative to its root's start (the host's where either has no event
    pair)."""
    host_ms = (rec.t1 - rec.t0) * 1e-6
    if None in (rec.e0, rec.e1, root.e0):
        start, end = (rec.t0 - root.t0) * 1e-6, (rec.t1 - root.t0) * 1e-6
    else:
        start = root.e0.elapsed_time(rec.e0) if rec is not root else 0.0
        end = root.e0.elapsed_time(rec.e1)
    return {"name": rec.name, "id": rec.id, "parent": rec.parent,
            "root": rec.root, "host_ms": host_ms, "device_ms": end - start,
            "start_ms": start, "end_ms": end}


def spans() -> List[Dict]:
    """Every closed span kept, by root, oldest root first, each a dict
    {"name", "id", "parent" (None for a root), "root", "host_ms",
    "device_ms", "start_ms", "end_ms"}: the device's interval from the
    span's event pair, its start and end relative to its root's start
    event (host times where CUDA was not in use).  Synchronises the card
    once where a record is not yet resolved."""
    with STORE.lock:
        groups = [list(recs) for recs in STORE.roots.values()]
    groups = [g for g in groups if g[0].id == g[0].root]
    closed = [(r, g[0]) for g in groups for r in g if r.t1 is not None]
    if any(r.resolved is None and r.e1 is not None for r, _ in closed):
        torch.cuda.synchronize()
    for rec, root in closed:
        if rec.resolved is None:
            rec.resolved = _resolve(rec, root)
    for rec, _ in closed:
        rec.e0 = rec.e1 = None
    return [dict(r.resolved) for r, _ in closed]


def clear() -> None:
    """Forget every kept span."""
    with STORE.lock:
        STORE.roots.clear()


def _sync() -> None:
    """Wait for the card, where one is in use: PyTorch returns before the
    device finishes, so a stage's host time means nothing without it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Collects named stage durations.  A stage ends in a device
    synchronisation, and is a :func:`span` in a recording profiler."""

    def __init__(self):
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        with span(name):
            yield
            _sync()
        self.records.append(
            {"stage": name, "seconds": round(time.perf_counter() - t0, 4)})

    def report(self) -> str:
        lines = [f"{r['stage']:<28s} {r['seconds']:>9.3f}s"
                 for r in self.records]
        total = sum(r["seconds"] for r in self.records)
        lines.append(f"{'TOTAL':<28s} {total:>9.3f}s")
        return "\n".join(lines)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.records, f, indent=1)
