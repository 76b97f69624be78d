"""The readers of the program's own spans (`harness.program_spans`): None
on an empty recorder, the right mean on a hand-filled one, and each listed in
BENCHMARK.json for the cells that have those spans."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402
from optispeech_tpu_torch.utils import tracing  # noqa: E402

MS = 1_000_000  # ns
READERS = {  # reader -> (cells, the value over `filled`)
    "encode.host_ms": ({"convnext.offline", "conformer.offline"}, 3.0),
    "decode.host_ms": ({"convnext.offline", "conformer.offline"}, 11.0),
    "decode.stream_ms": ({"convnext.offline", "conformer.offline"}, 14.0),
    "train.host_ms": ({"convnext.train"}, 400.0),
    "train.g_turn_ms": ({"convnext.train"}, 250.0),
    "train.d_turn_ms": ({"convnext.train"}, 120.0),
    "train.optim_ms": ({"convnext.train"}, 30.0),
    "train.syncs_per_step": ({"convnext.train"}, 2.5),
}


def filled():
    """Records of two synthesis calls and two steps."""
    rows = [  # name, host ms, stream ms, syncs
        ("encode", 2.0, 1.5, 0), ("encode", 4.0, 1.0, 0),
        ("decode", 10.0, 13.0, 0), ("decode", 12.0, 15.0, 0),
        ("decoder", 3.0, 4.0, 0),
        ("train/g_turn", 200.0, 240.0, 1), ("train/g_turn", 210.0, 260.0, 2),
        ("train/d_turn", 100.0, 110.0, 0), ("train/d_turn", 100.0, 130.0, 1),
        ("train/g_update", 20.0, 20.0, 0), ("train/g_update", 20.0, 20.0, 0),
        ("train/d_update", 10.0, 10.0, 0), ("train/d_update", 10.0, 10.0, 0),
        ("train/step", 390.0, 420.0, 2), ("train/step", 410.0, 430.0, 3),
    ]
    return [tracing.Record(name, 0, int(host * MS), i + 1, 0, 1, {}, syncs, stream)
            for i, (name, host, stream, syncs) in enumerate(rows)]


@pytest.fixture(autouse=True)
def empty_ring():
    tracing.clear()
    yield
    tracing.clear()


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_on_an_empty_recorder(name):
    assert common.load_module("metrics", name).read(None) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_mean_on_a_hand_filled_recorder(name, monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", lambda: tracing.Snapshot(filled(), (0, 0)))
    assert common.load_module("metrics", name).read(None) == pytest.approx(READERS[name][1])


def test_host_spans_of_the_recorder_itself():
    """Spans recorded through the recorder (host fields only): the host means
    read, the stream means do not."""
    with tracing.enable():
        for ms in (2, 6):
            tracing.record("decode", 0, ms * MS)
    assert common.load_module("metrics", "decode.host_ms").read(None) == pytest.approx(4.0)
    assert common.load_module("metrics", "decode.stream_ms").read(None) is None


def test_none_without_the_program_s_recorder(monkeypatch):
    """A program that has no recorder (an older checkout): no value, no error."""
    import optispeech_tpu_torch.utils

    with tracing.enable():
        tracing.record("decode", 0, 5 * MS)
    assert common.load_module("metrics", "decode.host_ms").read(None) == pytest.approx(5.0)
    monkeypatch.delattr(optispeech_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "optispeech_tpu_torch.utils.tracing", None)
    for name in READERS:
        assert common.load_module("metrics", name).read(None) is None


def test_listed_for_their_cells():
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name, (cells, _) in READERS.items():
        assert set(entries[name]["workloads"]) == cells
        assert entries[name]["source"] == "device_trace"
