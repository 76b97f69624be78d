"""scripts/port_campaign.py, the port's campaign script, against
scripts/campaign.py (loaded as tests/test_campaign_audit.py loads it): its
pure functions give campaign.py's results on the same inputs, EQUAL:
`stats_overrides`, `audit_metrics`, `quality_verdict`, `derive_targets`, and
`score` (campaign.py's is the function its calibration stage writes into
`_gate_calibration.py`, run here on the JAX package's metric functions; the
port's runs on the port's numpy copies of them)."""

import csv
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(name, module)
    spec.loader.exec_module(module)
    return module


campaign, port_campaign = _load("campaign"), _load("port_campaign")


def _write_metrics(path, rows):
    with open(path / "metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["step", "metric", "value"])
        w.writeheader()
        for step, metric, value in rows:
            w.writerow({"step": step, "metric": metric, "value": value})


def _series():
    """Validation series that exercise every branch of the audit: an AM
    subloss regressing after disc-on, one improving, a quality miss and a
    hit, a voicing collapse, a frozen metric, a directionless one, a single
    evaluation, and rows the audit ignores."""
    steps = (250, 500, 1000)
    series = {
        "gen_subloss/val_align_loss": (10.0, 8.0, 9.5),
        "gen_subloss/val_duration_loss": (0.05, 0.04, 0.03),
        "total_loss/val_am_loss": (3.0, 2.0, 2.01),
        "total_loss/val_total": (120.0, 100.0, 60.0),
        "val/mcd": (95.0, 90.0, 82.0),
        "val/stoi": (0.30, 0.40, 0.50),
        "val/f1_score": (0.86, 0.86, 0.35),
        "val/periodicity_loss": (0.123, 0.123, 0.123),
        "val/synth_wav_delta": (0.1, 0.3, 0.2),
        "gen_adv_loss/train_mel_loss": (9.0, 8.0, 7.0),
    }
    rows = [(s, m, v) for m, vals in series.items() for s, v in zip(steps, vals)]
    return rows + [(1000, "val/utmos", 3.2)]


@pytest.mark.parametrize("disc_on_step", [1, 500, 700, 2000])
@pytest.mark.parametrize("targets", ["default", "derived"])
def test_audit_and_verdict_equal_campaign(tmp_path, disc_on_step, targets):
    _write_metrics(tmp_path, _series())
    quality = None
    if targets == "derived":
        quality = {"val/mcd": ("<=", 87.2), "val/stoi": (">=", 0.27),
                   "val/f1_score": (">=", 0.73), "val/periodicity_loss": ("<=", 0.45)}
    audit = port_campaign.audit_metrics(tmp_path, disc_on_step, quality)
    assert audit == campaign.audit_metrics(tmp_path, disc_on_step, quality)
    assert "gen_adv_loss/train_mel_loss" not in audit and audit["val/utmos"]["n_evals"] == 1
    verdict = port_campaign.quality_verdict(audit, quality)
    assert verdict == campaign.quality_verdict(audit, quality)
    assert verdict[0] is False and any("frozen" in f for f in verdict[1])


def test_stats_overrides_and_derive_targets_equal_campaign(tmp_path):
    stats = {"pitch_min": 57.9, "pitch_max": 650.18, "pitch_mean": 125.05, "pitch_std": 28.03,
             "energy_min": 0.0007, "energy_max": 241.1, "energy_mean": 60.3,
             "energy_std": 46.7, "mel_mean": -5.13, "mel_std": 2.9}
    (tmp_path / "stats.json").write_text(json.dumps(stats))
    got = port_campaign.stats_overrides(tmp_path / "stats.json")
    assert got == campaign.stats_overrides(tmp_path / "stats.json")
    assert got[0] == "data.statistics.pitch_min=57.9"
    cal = {"n_utts": 16, "ceiling": {"mcd": 54.5, "stoi": 0.63, "f1_score": 0.91,
                                     "periodicity_loss": 0.30}}
    (tmp_path / "cal.json").write_text(json.dumps(cal))
    targets, derivation = port_campaign.derive_targets(tmp_path / "cal.json")
    assert (targets, derivation) == campaign.derive_targets(tmp_path / "cal.json")
    assert targets["val/mcd"] == ("<=", 87.2)


def _campaign_score(tmp_path, sr):
    """campaign.py's `score`, cut from the calibration script its stage
    writes (its `run` replaced, so nothing runs), bound to the JAX
    package's metric functions at `sr`."""
    from optispeech_tpu.training import metrics

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(campaign, "run", lambda *a, **kw: 0)
        campaign.stage_calibrate_gate(tmp_path, tmp_path / "corpus", tmp_path / "pre",
                                      tmp_path / "log")
    text = (tmp_path / "_gate_calibration.py").read_text()
    source = re.search(r"^def score\(gt, rs\):\n(?:    .*\n)+", text, re.M).group(0)
    namespace = {"np": np, "sr": sr, **{k: getattr(metrics, k) for k in (
        "mel_cepstral_distortion", "periodicity_metrics", "resample_to_16k", "stoi_score")}}
    exec(source, namespace)
    return namespace["score"]


@pytest.mark.parametrize("sr", [24000, 48000])
def test_score_equals_campaign_score(tmp_path, sr):
    from optispeech_tpu_torch.data.synthcorpus import (DEFAULT_LANGUAGES, DEFAULT_SPEAKERS,
                                                       synth_utterance)

    lang, spk = DEFAULT_LANGUAGES[0], DEFAULT_SPEAKERS[2]
    gt = synth_utterance("dake mito nasebo", spk, lang, sr=sr, seed=1)
    rs = synth_utterance("dake mito nasebo", spk, lang, sr=sr, seed=2, f0_scale=1.1)
    got = port_campaign.score(gt, rs, sr)
    assert got == _campaign_score(tmp_path, sr)(gt, rs)
    assert set(got) == {"mcd", "stoi", "periodicity_loss", "f1_score"} and got["mcd"] > 0


def test_train_stage_resumes_and_passes_the_device(tmp_path, monkeypatch):
    """The resumable-stage contract: a run stops when the newest checkpoint
    reaches --max-steps, a call that makes no progress stops the campaign,
    and a missing inference export is made by one more call; the train CLI
    gets `--device`."""
    calls = []

    def fake_run(cmd, log_path=None, check=True):
        calls.append([str(c) for c in cmd])
        step = 2 * sum("optispeech_tpu_torch.cli.train" in c for c in calls)
        (tmp_path / "run" / "checkpoints" / str(min(step, 3))).mkdir(parents=True,
                                                                     exist_ok=True)
        return 0

    monkeypatch.setattr(port_campaign, "run", fake_run)
    (tmp_path / "stats.json").write_text(json.dumps({"mel_mean": -5.0}))
    out = port_campaign.stage_train(tmp_path, tmp_path / "pre", "t.pak", "v.pak",
                                    tmp_path / "stats.json", 3, None, ["x=1"], device="cpu")
    assert out == tmp_path / "run" and len(calls) == 3  # to 2, to 3, then the export
    cmd = calls[0]
    assert cmd[cmd.index("--device") + 1] == "cpu" and "--device-cache" in cmd
    assert "data.statistics.mel_mean=-5.0" in cmd and cmd[-1] == "x=1"
    monkeypatch.setattr(port_campaign, "run", lambda *a, **kw: 0)
    with pytest.raises(SystemExit, match="no progress"):
        port_campaign.stage_train(tmp_path / "other", tmp_path / "pre", "t.pak", "v.pak",
                                  tmp_path / "stats.json", 3, None)
