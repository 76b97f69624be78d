"""run.py as a whole: its result line, no result without a card, and each
cell driven on the CPU at test widths with correct outputs, with the
program's lower precision (the control) and with an answer altered where it
is produced: both must come out not correct."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tiny
from harness import common

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH / "tools"))
import run  # noqa: E402
from faults import planted  # noqa: E402

CELLS = {
    "convnext.offline": dict(rows=2, tokens=[20, 30], pool=2, n_frames=256, frame_margin=16),
    "conformer.offline": dict(rows=2, tokens=[20, 30], pool=2, n_frames=256, frame_margin=16),
    "convnext.batcher": dict(max_batch=8, rate=30, max_pending=256,
                             tokens={"median": 12, "sigma": 0.5, "clip": [4, 24]}),
    "convnext.train": dict(batch=4, t_text=24, t_mel=96, pool=4, seconds_mean=0.8,
                           seconds_sd=0.2, seconds_clip=[0.3, 1.02], flop_rows=2),
}
SYNTHESIS = sorted(c for c in CELLS if c != "convnext.train")


def _measure(cell, control=False, seconds=0.6, seed=21):
    ctx = tiny.context(cell, seed=seed, control=control, **CELLS[cell])
    ctx.seconds = seconds
    return json.loads(run.measure(ctx, False, 1, common.process_start()))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_is_correct_on_the_cpu(cell):
    out = _measure(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    e2e, _ = common.cell_metrics(cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["device"]["platform"] == "cpu"
    limits = tiny.tiny_workload(cell)["check"]["limits"]
    assert set(out["checks"]) == set(limits)
    assert all(v["limit"] == limits[k] for k, v in out["checks"].items())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    """The program's bfloat16 path in place of the stated precision."""
    assert _measure(cell, control=True)["correct"] is False


@pytest.mark.parametrize("cell,fault", [(c, "altered_answer") for c in SYNTHESIS]
                         + [("convnext.train", "unchanged_state"),
                            ("convnext.train", "half_batch")])
def test_planted_fault_is_not_correct(cell, fault):
    """Each fault the cell can have, planted in the program (`tools/faults.py`)."""
    with planted(fault):
        assert _measure(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["convnext.offline", "convnext.batcher"])
def test_altered_duration_is_not_correct(cell, monkeypatch):
    """Every duration of the batch one frame longer where it is produced."""
    from optispeech_tpu_torch.models.modules.core import DurationPredictor

    infer = DurationPredictor.infer
    monkeypatch.setattr(DurationPredictor, "infer",
                        lambda self, *a, **k: infer(self, *a, **k) + 1)
    assert _measure(cell)["correct"] is False


def test_result_line_shape():
    from harness.compare import Check

    line = common.result_line(True, 10, 1, {"setup_s": {"value": 1.5, "unit": "s"}},
                              {"platform": "gpu", "kind": "x", "count": 1,
                               "memory_peak_bytes": 5},
                              [Check("wav_gap", 0.001, 0.007)],
                              {"device_ops": [["k", 0.1]], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"] == {"wav_gap": {"value": 0.001, "limit": 0.007}}


def test_no_card_no_result(tmp_path):
    """Without a card the run fails and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (BENCH.parent, None):
        if cwd is None:  # a directory with only BENCHMARK.json and the benchmark
            cwd = tmp_path
            (tmp_path / "BENCHMARK.json").write_bytes((BENCH.parent / "BENCHMARK.json")
                                                      .read_bytes())
            subprocess.run(["cp", "-r", str(BENCH), str(tmp_path / "benchmark")], check=True)
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "convnext.offline",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"correct"' not in r.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_on_the_card(card, cell):
    """The control at the cell's own size on three seeds: not correct."""
    w = common.workload(cell)
    for seed in (101, 202, 303):
        ctx = common.Context(cell=cell, workload=w, config=common.config(w["config"]), seed=seed,
                             seconds=3.0, control=True, log=lambda m: None)
        common.apply_precision(ctx.config)
        assert json.loads(run.measure(ctx, False, 1, common.process_start()))["correct"] is False
