"""`harness.trace.analyse` on synthetic profiler events: each span's device
time is the time of the kernels launched inside it; the program's own ranges
(`optispeech/<name>`) are keyed by their full names beside the benchmark's
(`bench/<name>` as `<name>`), which read as they do without them."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402
from harness.trace import analyse  # noqa: E402

US = 1000  # ns


class Event:
    def __init__(self, name, start, end, device="CPU", tid=1, corr=0):
        self._name, self._start, self._end = name, start * US, end * US
        self._device, self._tid, self._corr = SimpleNamespace(name=device), tid, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr


def two_calls(program_ranges=True):
    """Two decodes: in each, one decoder kernel (20 µs) and two vocoder
    kernels (30 + 50 µs), launched from inside the ranges around them."""
    events = []
    for call, t in enumerate((0, 1000)):
        c = 10 * call
        events += [Event("bench/decode", t + 10, t + 500), Event("bench/decoder", t + 30, t + 120),
                   Event("cudaLaunchKernel", t + 40, t + 45, corr=c + 1),
                   Event("cudaLaunchKernel", t + 200, t + 205, corr=c + 2),
                   Event("cudaLaunchKernel", t + 300, t + 305, corr=c + 3),
                   Event("decoder_kernel", t + 50, t + 70, device="CUDA", corr=c + 1),
                   Event("trunk_kernel", t + 210, t + 240, device="CUDA", corr=c + 2),
                   Event("head_kernel", t + 310, t + 360, device="CUDA", corr=c + 3)]
        if program_ranges:
            events += [Event("optispeech/decode", t + 20, t + 490),
                       Event("optispeech/decoder", t + 35, t + 110),
                       Event("optispeech/vocoder", t + 150, t + 480),
                       # a range's device-side mirror carries its name: not a kernel
                       Event("optispeech/vocoder", t + 210, t + 360, device="CUDA")]
    return events


def test_program_ranges_beside_the_benchmark_s():
    t = analyse(two_calls(), 0, 2000 * US)
    assert t.span_calls == {"decode": 2, "decoder": 2, "optispeech/decode": 2,
                            "optispeech/decoder": 2, "optispeech/vocoder": 2}
    assert t.span_device_s == pytest.approx({
        "decode": 200e-6, "decoder": 40e-6, "optispeech/decode": 200e-6,
        "optispeech/decoder": 40e-6, "optispeech/vocoder": 160e-6})
    assert set(t.kernels) == {"decoder_kernel", "trunk_kernel", "head_kernel"}
    assert common.load_module("metrics", "vocoder.device_ms").read(t) == pytest.approx(0.08)
    assert common.load_module("metrics", "generator.decode_ms").read(t) == pytest.approx(0.1)
    assert common.load_module("metrics", "decoder.device_ms").read(t) == pytest.approx(0.02)


def test_benchmark_s_keys_and_gaps_as_without_program_ranges():
    with_p, without = analyse(two_calls(), 0, 2000 * US), analyse(two_calls(False), 0, 2000 * US)
    bench = lambda d: {k: v for k, v in d.items() if not k.startswith("optispeech/")}  # noqa: E731
    assert bench(with_p.span_device_s) == without.span_device_s
    assert bench(with_p.span_calls) == without.span_calls
    assert with_p.busy_s == without.busy_s and with_p.kernels == without.kernels
    assert sum(with_p.idle_gaps.values()) == pytest.approx(sum(without.idle_gaps.values()))
    assert common.load_module("metrics", "vocoder.device_ms").read(without) is None


def test_ranges_outside_the_window_are_left_out():
    t = analyse(two_calls(), 0, 900 * US)
    assert t.span_calls["optispeech/vocoder"] == 1 and t.span_calls["decode"] == 1
