"""Spans and counters at the port's layer boundaries.

``span(name, device=False)`` times one layer's work where it happens and
``count(name, n)`` counts what it moves. Both are off by default and then
cost one check: ``span`` returns one shared no-op context, constructs no
``record_function``, records no CUDA event and allocates nothing. They are on
while a ``torch.profiler`` session records, or inside ``recording()``.

When on, a span opens ``torch.profiler.record_function(name)``, so under a
profiler it lies in the host timeline on the clock of the device's kernel
records, and it keeps a record: its name, its host start and end
(``time.perf_counter``), its parent span and the id of the entry call it
belongs to. A span opened with no span open on its thread starts a new call
(``hooi`` and ``dist_hooi`` are the entry calls' top spans); every span
beneath carries its id. With ``device=True`` the span also records two
timing events on the current CUDA stream (skipped while that stream is
capturing). A span never synchronises: ``summary()`` resolves the events
and is the only place that waits on the device. A count is attributed to
the innermost open span.

Records stay in memory, at most ``MAX_RECORDS``; past that the oldest are
folded into per-name totals (which ``summary(call=...)`` no longer sees).

To trace a run without the profiler::

    from repro_torch import tracing

    with tracing.recording():
        dec, fits = hooi(t, core_dims, device="cuda")
    for name, s in tracing.summary().items():
        print(name, s["count"], s["host_s"], s["self_s"], s["device_s"],
              s["counters"])
    tracing.clear()

``DistHooiStats.spans`` holds the summary of one ``dist_hooi`` call when it
ran with recording on.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

__all__ = ["span", "count", "recording", "summary", "clear", "MAX_RECORDS"]

MAX_RECORDS = 1 << 16

_profiler_enabled = torch._C._autograd._profiler_enabled


class _Record:
    __slots__ = ("name", "parent", "call", "t0", "t1", "child_s", "events",
                 "device_s", "counters")

    def __init__(self, name: str, parent: _Record | None, call: int):
        self.name = name
        self.parent = parent
        self.call = call
        self.t0 = self.t1 = 0.0
        self.child_s = 0.0  # host seconds its direct children cover
        self.events = None
        self.device_s = None
        self.counters = None


class _Store:
    """The process's records and the per-name totals of folded ones."""

    def __init__(self):
        self.lock = threading.Lock()
        self.recording = 0  # open ``recording()`` blocks, any thread
        self.calls = itertools.count(1)
        self.local = threading.local()  # each thread's stack of open spans
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.records: collections.deque = collections.deque()
            self.folded: dict = {}

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, rec: _Record) -> None:
        with self.lock:
            self.records.append(rec)
            while len(self.records) > MAX_RECORDS:
                _fold(self.folded, self.records.popleft(), wait=False)


_STORE = _Store()


_NULL = contextlib.nullcontext()  # the shared no-op span


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, device: bool):
        st = _STORE.stack()
        parent = st[-1] if st else None
        call = parent.call if parent is not None else next(_STORE.calls)
        self.rec = _Record(name, parent, call)
        if device and not torch.cuda.is_current_stream_capturing():
            self.rec.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        rec = self.rec
        self.rf.__enter__()
        _STORE.stack().append(rec)
        rec.t0 = time.perf_counter()
        if rec.events is not None:
            rec.events[0].record()
        return rec.call

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        rec.t1 = time.perf_counter()
        st = _STORE.stack()
        if st and st[-1] is rec:
            st.pop()
        if rec.parent is not None:
            rec.parent.child_s += rec.t1 - rec.t0
        self.rf.__exit__(*exc)
        _STORE.add(rec)
        return False


def span(name: str, device: bool = False):
    """A context manager timing ``name``; off, the shared no-op. Entered,
    it gives the id of the call it belongs to (None when off).
    ``device=True`` also times it on the current CUDA stream."""
    if not (_STORE.recording or _profiler_enabled()):
        return _NULL
    return _Span(name, device)


def count(name: str, n: int | float) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span (of a
    pseudo-span ``name`` when none is open); nothing when off."""
    if not (_STORE.recording or _profiler_enabled()):
        return
    st = _STORE.stack()
    if st:
        rec = st[-1]
        if rec.counters is None:
            rec.counters = collections.Counter()
        rec.counters[name] += n
        return
    rec = _Record(name, None, 0)
    rec.counters = collections.Counter({name: n})
    _STORE.add(rec)


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the block, without a profiler."""
    with _STORE.lock:
        _STORE.recording += 1
    try:
        yield
    finally:
        with _STORE.lock:
            _STORE.recording -= 1


def _entry() -> dict:
    return {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": None,
            "device_count": 0, "counters": collections.Counter(),
            "parents": set(), "calls": set(), "pending": []}


def _resolve(rec: _Record, wait: bool) -> None:
    """Turn a record's events into device seconds; without ``wait`` only
    once the device has passed the second one."""
    ev0, ev1 = rec.events
    if not wait and not ev1.query():
        return
    ev1.synchronize()
    rec.device_s = ev0.elapsed_time(ev1) / 1e3
    rec.events = None


def _fold(out: dict, rec: _Record, wait: bool) -> None:
    e = out.get(rec.name)
    if e is None:
        e = out[rec.name] = _entry()
    if rec.counters:
        e["counters"].update(rec.counters)
    if rec.call == 0:  # a count made with no span open
        return
    e["count"] += 1
    e["host_s"] += rec.t1 - rec.t0
    e["self_s"] += rec.t1 - rec.t0 - rec.child_s
    e["calls"].add(rec.call)
    if rec.parent is not None:
        e["parents"].add(rec.parent.name)
    if rec.events is not None:
        _resolve(rec, wait)
    if rec.events is not None:  # still running on the device
        e["pending"].append(rec)
    elif rec.device_s is not None:
        e["device_s"] = (e["device_s"] or 0.0) + rec.device_s
        e["device_count"] += 1


def _merge(out: dict, name: str, folded: dict) -> None:
    for rec in folded["pending"]:  # folded before the device passed them
        _resolve(rec, wait=True)
        folded["device_s"] = (folded["device_s"] or 0.0) + rec.device_s
        folded["device_count"] += 1
    folded["pending"] = []
    e = out.setdefault(name, _entry())
    for k in ("count", "host_s", "self_s", "device_count"):
        e[k] += folded[k]
    if folded["device_s"] is not None:
        e["device_s"] = (e["device_s"] or 0.0) + folded["device_s"]
    e["counters"].update(folded["counters"])
    e["parents"] |= folded["parents"]
    e["calls"] |= folded["calls"]


def summary(call: int | None = None) -> dict:
    """Per span name: ``count``, ``host_s``, ``self_s`` (host seconds less
    what its child spans cover), ``device_s`` (None without events) over
    ``device_count`` spans, ``counters``, the names of its ``parents`` and
    the number of ``calls`` it ran in. ``call`` keeps one call's spans.
    Waits for the device to pass every recorded event."""
    with _STORE.lock:
        records = [r for r in _STORE.records if call is None or r.call == call]
        out: dict = {}
        for rec in records:
            _fold(out, rec, wait=True)
        if call is None:
            for name, folded in _STORE.folded.items():
                _merge(out, name, folded)
    for e in out.values():
        e["counters"] = dict(e["counters"])
        e["parents"] = sorted(e["parents"])
        e["calls"] = len(e["calls"])
        del e["pending"]
    return out


def clear() -> None:
    """Drop every record and total."""
    _STORE.clear()
