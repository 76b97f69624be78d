"""The port's spans and the recorder that keeps them.

A span names a stretch of the program's work::

    with tracing.span("decode"):
        ...
    with tracing.span("synthesise", rows=32, text_width=256, n_frames=1792):
        ...

    @tracing.traced("train/step")
    def train_step(state, batch): ...

Tracing is on while `enable()` is in force or a torch profiler runs (the
profiler's flag is the process's, so a span on any thread sees it). Off,
`span` returns one shared no-op context after a test of two bools: no
allocation, no lock, no torch call. `traced` is the decorator form, since
that shared context cannot carry a name.

On, a span
- opens `torch.profiler.record_function("optispeech/<name>")`, so that a
  profiled run shows the program's ranges beside the kernels they launch;
- appends a record to a bounded ring (`RING_SPANS`), from any thread: the
  name, host start and end as `time.perf_counter_ns()`, its id and its
  parent's (a stack per thread), the thread's native id, the attrs given,
  and the device-to-host syncs counted inside it (its children's included);
- where CUDA is initialised and the current stream is not capturing a
  graph, records a pair of timing events (taken from a pool) on the current
  stream. Their elapsed time is the span's stream time: from when the
  stream reached the span's start to when it finished the span's last work,
  so it holds the device's idle time inside the span, unlike a sum of
  kernel times. Under capture a span records host fields only, so that a
  graph holds no event nodes.

Syncs are counted through CUDA's sync debug mode, set to "warn" while
tracing is on and put back when it goes off: each warning it raises is
counted against the innermost open span of its thread. It sees the syncs
that PyTorch's own operations make (`.item()`, `.cpu()`, `.tolist()`, a
blocking copy, a stream's `synchronize()`); not a device-wide
`torch.cuda.synchronize()`, an event's wait, or a sync made inside a
library (cuDNN, cuBLAS) or a ctypes launch.

`snapshot()` gives the records, stream times resolved, with an anchor pair
(perf_counter_ns, time_ns); `to_unix_ns` maps a stamp onto the Unix-ns time
base of the profiler's host events. `dump(path)` writes a Chrome trace on the
Unix-µs base, `clear()` empties the ring.
"""

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import warnings
from collections import deque
from typing import NamedTuple, Optional

import torch

PREFIX = "optispeech/"  # of the spans' names in the profiler's timeline
RING_SPANS = 1 << 20  # records kept; the oldest go first
EVENT_PAIRS = 1 << 12  # spans awaiting their stream times before a span resolves them
SYNC_WARNING = "called a synchronizing CUDA operation"  # CUDA's sync debug mode

_profiler = torch.autograd.profiler  # its `_is_profiler_enabled` is the process's flag
_perf_ns = time.perf_counter_ns

_forced = False  # enable() in force
_armed = False  # the sync counting installed
_depth = 0  # nested enable()s
_lock = threading.Lock()  # enable(), arming, the event pool
_ring: deque = deque(maxlen=RING_SPANS)
_ids = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans; .tid: its native id
_pools: dict = {}  # device index -> free (start, end) event pairs
_pending: deque = deque()  # spans whose events await resolution, oldest first
_saved: dict = {}  # what arming replaced: showwarning, filter, sync mode


class Record(NamedTuple):
    """One span as `snapshot()` gives it."""

    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int  # 0 at the top of its thread
    thread: int  # native thread id, as the profiler's
    attrs: dict
    syncs: int  # device-to-host syncs counted inside it
    stream_ms: Optional[float]  # None where no events were recorded

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Snapshot(NamedTuple):
    spans: list
    anchor: tuple  # (perf_counter_ns, time_ns) read together: to_unix_ns's


def _anchor() -> tuple:
    return _perf_ns(), time.time_ns()


def to_unix_ns(t: int, anchor: Optional[tuple] = None) -> int:
    """A perf_counter_ns stamp on the Unix-ns time base of the profiler's host
    events, through `anchor` (a fresh pair when None)."""
    perf, unix = anchor or _anchor()
    return t - perf + unix


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack


class _Null:
    """The shared no-op context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "thread", "t0", "t1", "syncs", "stream_ms",
                 "_rf", "_events", "_stream", "_device")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.syncs = 0
        self.stream_ms = self._events = None

    def __enter__(self):
        if not _armed:
            _arm()
        stack = _stack()
        self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)
        self.thread = _local.tid
        self.t0 = _perf_ns()
        self._rf = _profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self._stream = stream = torch.cuda.current_stream()
            self._device = stream.device_index
            self._events = _take_pair(self._device)
            self._events[0].record(stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = _local.stack
        stack.pop()
        if self._events is not None:
            if torch.cuda.is_current_stream_capturing():  # a capture began inside
                _pools[self._device].append(self._events)
                self._events = None
            else:
                self._events[1].record(self._stream)
            self._stream = None
        self._rf.__exit__(*exc)
        self.t1 = _perf_ns()
        self._rf = None
        if stack:
            stack[-1].syncs += self.syncs
        if self._events is not None:
            _pending.append(self)
        _ring.append(self)
        return False


def span(name: str, **attrs):
    """A span of the program's work named `name` (kineto: "optispeech/<name>"),
    with `attrs` kept in its record; the shared no-op context when tracing is
    off."""
    if _forced or _profiler._is_profiler_enabled:
        return _Span(name, attrs)
    if _armed:
        _disarm()
    return NULL


def traced(name: str, **attrs):
    """Decorator: each call of the function inside `span(name, **attrs)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)

        return inner

    return wrap


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Append a span that the caller timed (perf_counter_ns stamps), with host
    fields only, when tracing is on: a wait that began on another thread, say.
    Its parent is the innermost span open on this thread."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    s = _Span(name, attrs)
    stack = _stack()
    s.parent = stack[-1].id if stack else 0
    s.id = next(_ids)
    s.thread = _local.tid
    s.t0, s.t1 = start_ns, end_ns
    _ring.append(s)


class timed:
    """`span(name, **attrs)` whose host seconds are also added to
    `totals[key]`, tracing on or off, from the same two clock reads as the
    span's; `.seconds` holds them after the block."""

    __slots__ = ("_totals", "_key", "_span", "_t0", "seconds")

    def __init__(self, totals: dict, key: str, name: str, **attrs):
        self._totals, self._key = totals, key
        self._span = span(name, **attrs)

    def __enter__(self):
        s = self._span
        if s is NULL:
            self._t0 = _perf_ns()
        else:
            s.__enter__()
            self._t0 = s.t0
        return self

    def __exit__(self, *exc):
        s = self._span
        if s is NULL:
            t1 = _perf_ns()
        else:
            s.__exit__(*exc)
            t1 = s.t1
        self.seconds = (t1 - self._t0) / 1e9
        self._totals[self._key] += self.seconds
        return False


# -- the event pool -----------------------------------------------------------

def _take_pair(device: int):
    """A free pair of timing events on `device`; new ones while fewer than
    EVENT_PAIRS spans await their stream times, else those the stream has
    passed are resolved first, in one go."""
    pool = _pools.setdefault(device, [])
    if not pool and len(_pending) >= EVENT_PAIRS:
        with _lock:
            _recycle()
    try:
        return pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _resolve(s: _Span, wait: bool) -> bool:
    """Set s.stream_ms from its events and give them back; False when the
    stream has not reached its end yet and `wait` is False. Under _lock."""
    if s._events is None:
        return True
    start, end = s._events
    if not wait and not end.query():
        return False
    end.synchronize()
    s.stream_ms = start.elapsed_time(end)
    _pools.setdefault(s._device, []).append(s._events)
    s._events = None
    return True


def _recycle() -> None:
    """Resolve the oldest spans whose streams have passed their ends. Under _lock."""
    while _pending and _resolve(_pending[0], wait=False):
        _pending.popleft()


# -- sync counting ------------------------------------------------------------

def _on_warning(message, category, filename, lineno, file=None, line=None):
    if SYNC_WARNING in str(message):
        stack = getattr(_local, "stack", None)
        if stack:
            stack[-1].syncs += 1
        return
    _saved["showwarning"](message, category, filename, lineno, file, line)


def _arm() -> None:
    global _armed
    with _lock:
        if _armed:
            return
        _saved["showwarning"] = warnings.showwarning
        warnings.showwarning = _on_warning
        warnings.filterwarnings("always", message=SYNC_WARNING)
        _saved["filter"] = warnings.filters[0]
        if torch.cuda.is_available():
            _saved["sync_mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _armed = True


def _disarm() -> None:
    global _armed
    with _lock:
        if not _armed:
            return
        if warnings.showwarning is _on_warning:
            warnings.showwarning = _saved["showwarning"]
        with contextlib.suppress(ValueError):
            warnings.filters.remove(_saved["filter"])
            getattr(warnings, "_filters_mutated", lambda: None)()
        if "sync_mode" in _saved:
            torch.cuda.set_sync_debug_mode(_saved.pop("sync_mode"))
        _armed = False


# -- the recorder's surface ---------------------------------------------------

@contextlib.contextmanager
def enable():
    """Tracing on inside the block (nests), whether or not a profiler runs."""
    global _forced, _depth
    with _lock:
        _depth += 1
        _forced = True
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            _forced = _depth > 0
        if not (_forced or _profiler._is_profiler_enabled):
            _disarm()


def snapshot() -> Snapshot:
    """The ring's records, oldest first, with their stream times resolved
    (this waits for the device to reach their ends)."""
    spans = list(_ring)
    with _lock:
        for s in spans:
            _resolve(s, wait=True)
        _recycle()
    return Snapshot([Record(s.name, s.t0, s.t1, s.id, s.parent, s.thread, s.attrs, s.syncs,
                            s.stream_ms) for s in spans], _anchor())


def clear() -> None:
    """Empty the ring."""
    _ring.clear()
    with _lock:
        _pending.clear()


def dump(path, base_ns: int = 0) -> None:
    """Write the ring's spans as a Chrome trace: complete events whose `ts` is
    Unix µs less `base_ns` / 1000, with the same `baseTimeNanoseconds` in the
    header. Given the `baseTimeNanoseconds` of a `torch.profiler` export, the
    two files open in one viewer on one time line."""
    snap = snapshot()
    pid = os.getpid()
    events = []
    for r in snap.spans:
        args = {**{k: _jsonable(v) for k, v in r.attrs.items()}, "id": r.id, "parent": r.parent,
                "syncs": r.syncs}
        if r.stream_ms is not None:
            args["stream_ms"] = r.stream_ms
        events.append({"name": r.name, "cat": "optispeech", "ph": "X", "pid": pid,
                       "tid": r.thread, "ts": (to_unix_ns(r.start_ns, snap.anchor) - base_ns) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns}, f)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)
