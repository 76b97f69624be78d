"""The traced run: spans recorded from the benchmark's own files, the
profiler's device events, and what the per-layer readers are given.

Spans are `torch.profiler.record_function` ranges: the benchmark's own
(`bench/<name>`), which module hooks and method wrappers open and close
around the program's calls (`Spans`), and the program's (`optispeech/<name>`,
`optispeech_tpu_torch.utils.tracing`, on while the profiler runs). A span's
device time is the time of the kernels launched from inside it: each launch
(a CUDA runtime or low-level API call on the span's thread, within its host
interval) is matched to its kernel by the profiler's correlation id. The
benchmark's spans are keyed by `<name>`, the program's by their full
`optispeech/<name>`, so that the two never add into one key.
"""

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "bench/"
PROGRAM_PREFIX = "optispeech/"  # the program's own ranges, keyed by their full names
# a host event that launches device work: a CUDA runtime or low-level API call
LAUNCH = re.compile(r"^cu(da)?[A-Z]")


class Spans:
    """Hooks that open a named profiler range around module calls and
    method calls; `shapes` keeps each call's argument shapes by span name."""

    def __init__(self):
        self._handles = []
        self._restore = []
        self.shapes = defaultdict(list)

    def around_module(self, module, name, shape_of=None):
        from torch.autograd.profiler import record_function

        stack = []

        def pre(mod, args):
            if shape_of is not None:
                self.shapes[name].append(shape_of(mod, args))
            rf = record_function(SPAN_PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def around_method(self, obj, attr, name):
        from torch.autograd.profiler import record_function

        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with record_function(SPAN_PREFIX + name):
                return inner(*args, **kwargs)

        self._restore.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, wrapped)

    def remove(self):
        for h in self._handles:
            h.remove()
        for obj, attr, before in reversed(self._restore):
            if before is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, before)
        self._handles, self._restore = [], []


@dataclass
class TraceData:
    """What a per-layer reader may read."""

    window_s: float
    busy_s: float
    span_device_s: dict  # span key -> device seconds (keys as `analyse` gives them)
    span_calls: dict  # span key -> calls within the window
    span_shapes: dict
    kernels: dict  # device op name -> seconds
    idle_gaps: dict  # host op at the gap's middle -> idle seconds
    work: dict = field(default_factory=dict)  # counts of the traced window's work
    counters: dict = field(default_factory=dict)  # program counters over the window
    flops: object = None  # callable: the cell's FLOP counts, counted on the reference

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(self.kernels), "idle_gaps": top(self.idle_gaps)}


def idle_pct(t: TraceData):
    """Share of the traced window in which no operation ran on the device
    (the union of kernel, copy and memset intervals): the device-idle
    readers' metric."""
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None


def _union(intervals):
    """Merged (start, end) intervals of a list of them."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_window(run):
    """Run `run()` under torch.profiler (CPU and CUDA activities) inside a
    `bench/window` range, and return a TraceData of that window. `run`
    returns a dict of the window's work counts."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN_PREFIX + "window"):
            work = run()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == SPAN_PREFIX + "window")
    data = analyse(events, window.start_ns(), window.end_ns())
    data.work = work
    return data


def analyse(events, w0, w1) -> TraceData:
    """TraceData from kineto events over the window [w0, w1] (ns). Device
    operations are the device's events that the host does not mirror (a
    host range's device-side copy carries the range's name)."""
    host_names = {e.name() for e in events if e.device_type().name == "CPU"}
    device, launches, host = [], defaultdict(list), defaultdict(list)
    for e in events:
        if e.device_type().name != "CPU":
            if e.name() not in host_names:
                device.append(e)
            continue
        host[e.start_thread_id()].append(e)
        if LAUNCH.match(e.name()):
            launches[e.start_thread_id()].append((e.start_ns(), e.correlation_id()))
    dev_by_corr = defaultdict(float)
    kernels = defaultdict(float)
    intervals = []
    for e in device:
        s, t = e.start_ns(), e.end_ns()
        dev_by_corr[e.correlation_id()] += (t - s) / 1e9
        s, t = max(s, w0), min(t, w1)
        if t > s:
            intervals.append((s, t))
            kernels[e.name()] += (t - s) / 1e9
    merged = _union(intervals)
    busy = sum(t - s for s, t in merged) / 1e9

    for tid in launches:
        launches[tid].sort()
    span_dev, span_calls = defaultdict(float), defaultdict(int)
    for tid, evs in host.items():
        starts = [s for s, _ in launches.get(tid, [])]
        for e in evs:
            name = e.name()
            if name.startswith(SPAN_PREFIX):
                key = name[len(SPAN_PREFIX):]
            elif name.startswith(PROGRAM_PREFIX):
                key = name
            else:
                continue
            if e.start_ns() < w0 or e.end_ns() > w1:
                continue
            span_calls[key] += 1
            lo = bisect.bisect_left(starts, e.start_ns())
            hi = bisect.bisect_right(starts, e.end_ns())
            span_dev[key] += sum(dev_by_corr.get(c, 0.0) for _, c in launches[tid][lo:hi])

    return TraceData(window_s=(w1 - w0) / 1e9, busy_s=busy, span_device_s=dict(span_dev),
                     span_calls=dict(span_calls), span_shapes={}, kernels=dict(kernels),
                     idle_gaps=_label_gaps(merged, w0, w1, host))


def _label_gaps(merged, w0, w1, host) -> dict:
    """Idle seconds of the window by the innermost host operation running at
    each gap's middle on the thread that launched the most work."""
    gaps = []
    prev = w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    if not host:
        return {}
    main = max(host, key=lambda tid: len(host[tid]))
    evs = sorted(host[main], key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in evs]
    out = defaultdict(float)
    for s, t in gaps:
        mid = (s + t) / 2
        label = "(host between operations)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if evs[j].end_ns() >= mid:
                label = evs[j].name()
                break
        out[label] += (t - s) / 1e9
    return dict(out)
