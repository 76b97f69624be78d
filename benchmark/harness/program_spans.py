"""The program's own spans over the traced window, for the per-layer readers
that read them.

`optispeech_tpu_torch.utils.tracing` records a span while a torch profiler
runs, and the traced window (`harness.trace.profile_window`) is the only time
one runs in a benchmark process, so the recorder holds that window's spans
and no others. A checkout whose program has no recorder gives no spans, and
its readers return None.
"""

from dataclasses import dataclass


@dataclass
class Totals:
    """One span name's sums over the window."""

    calls: int = 0
    host_ms: float = 0.0  # host start to end
    stream_calls: int = 0  # the spans with a stream time
    stream_ms: float = 0.0  # the stream's start to its end (timing events)
    syncs: int = 0  # device-to-host syncs counted inside

    def mean_host_ms(self):
        return self.host_ms / self.calls if self.calls else None

    def mean_stream_ms(self):
        return self.stream_ms / self.stream_calls if self.stream_calls else None


def by_name() -> dict:
    """{span name: Totals} over the program's recorder; {} without one."""
    try:
        from optispeech_tpu_torch.utils import tracing
    except ImportError:
        return {}
    out = {}
    for r in tracing.snapshot().spans:
        t = out.setdefault(r.name, Totals())
        t.calls += 1
        t.host_ms += r.host_ms
        t.syncs += r.syncs
        if r.stream_ms is not None:
            t.stream_calls += 1
            t.stream_ms += r.stream_ms
    return out


def mean_host_ms(name: str):
    t = by_name().get(name)
    return t.mean_host_ms() if t else None


def mean_stream_ms(name: str):
    t = by_name().get(name)
    return t.mean_stream_ms() if t else None
