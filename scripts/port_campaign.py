"""End-to-end multi-speaker / multi-language training campaign through the
PyTorch port (`optispeech_tpu_torch`): the port's counterpart of
scripts/campaign.py, stage for stage.

    corpus -> preprocess -> stats -> pack -> calibrate the quality gate
           -> train (--packed-train --device-cache, on the card)
           -> metric audit and quality verdict
           -> per-speaker F0 check (synthesis conditioned on each sid)
           -> tail average (--compare)
           -> export (batch ladder + stream graphs)
           -> serve the artifact over HTTP and query every speaker + /stream

Each stage is a subprocess of the port's CLI of the same name, or a script
this file writes into the work directory, which imports the port only; the
stages are resumable: completed outputs are detected and skipped, and a
stage derived from the checkpoint reruns when the checkpoint is newer.
The flags are campaign.py's, plus `--device` (the card by default: the
training, speaker-check, averaging and serving stages raise without one;
`--device cpu` runs everything on the CPU) and `--evidence-dir` (default:
WORK_DIR/evidence). The verdict is printed; a FAIL does not stop the run.

Usage:
    python scripts/port_campaign.py --work-dir runs/port_campaign \\
        [--n-utterances 600] [--max-steps 3000] [--device cuda] \\
        [--evidence-dir DIR] [overrides ...]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CONFIG = "campaign-ms"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}{env.get('PYTHONPATH', '')}"
    return env


def run(cmd, log_path=None, check=True):
    print(f"+ {' '.join(map(str, cmd))}", flush=True)
    t0 = time.time()
    with open(log_path, "ab") if log_path else open(os.devnull, "wb") as sink:
        proc = subprocess.run(
            [str(c) for c in cmd], env=_env(), cwd=str(REPO),
            stdout=sink if log_path else None,
            stderr=subprocess.STDOUT if log_path else None,
        )
    print(f"  -> rc={proc.returncode} ({time.time() - t0:.0f}s)", flush=True)
    if check and proc.returncode != 0:
        tail = Path(log_path).read_text()[-3000:] if log_path else ""
        raise SystemExit(f"stage failed: {' '.join(map(str, cmd))}\n{tail}")
    return proc.returncode


def _device_flag(device):
    return ["--device", device] if device else []


def stats_overrides(stats_path: Path) -> list[str]:
    stats = json.loads(stats_path.read_text())
    return [f"data.statistics.{k}={v}" for k, v in stats.items()]


def stage_corpus(work: Path, n_utt: int, log, f0_jitter: float = 0.08):
    corpus = work / "corpus"
    if (corpus / "metadata.csv").exists():
        return corpus
    run([sys.executable, "-m", "optispeech_tpu_torch.data.synthcorpus", corpus,
         "--n-utterances", n_utt, "--frontend", "en-g2p",
         "--f0-jitter", f0_jitter], log_path=log)
    return corpus


def stage_preprocess(work: Path, corpus: Path, log):
    pre = work / "pre"
    if (pre / "train.txt").exists():
        return pre
    run([sys.executable, "-m", "optispeech_tpu_torch.cli.preprocess", corpus, pre,
         "--config", CONFIG, "--workers", "8", "--val-fraction", "0.03"], log_path=log)
    return pre


def stage_stats(work: Path, pre: Path, log):
    out = work / "stats.json"
    if not out.exists():
        run([sys.executable, "-m", "optispeech_tpu_torch.cli.stats", "--config", CONFIG,
             "-o", out, f"data.train_filelist_path={pre / 'train.txt'}"], log_path=log)
    return out


def stage_pack(work: Path, pre: Path, log):
    train_pak, val_pak = work / "train.pak", work / "val.pak"
    for split, pak in (("train", train_pak), ("val", val_pak)):
        if not pak.exists():
            run([sys.executable, "-m", "optispeech_tpu_torch.cli.pack", pre / f"{split}.txt",
                 pak, "--config", CONFIG], log_path=log)
    return train_pak, val_pak


def _latest_ckpt_step(out_dir: Path) -> int:
    d = out_dir / "checkpoints"
    if not d.is_dir():
        return 0
    return max((int(n) for n in os.listdir(d) if n.isdigit()), default=0)


def _latest_ckpt_mtime(out_dir: Path) -> float:
    step = _latest_ckpt_step(out_dir)
    return (out_dir / "checkpoints" / str(step)).stat().st_mtime if step else 0.0


def _fresh(result: Path, since: float) -> bool:
    """A cached stage output counts only if it postdates `since` (the newest
    checkpoint or the artifact it was derived from): a continuation run (the
    same work dir, a higher --max-steps) recomputes its evidence."""
    return result.exists() and result.stat().st_mtime >= since


def stage_train(work: Path, pre: Path, train_pak, val_pak, stats, max_steps, log,
                overrides=(), device=None):
    """Train to `max_steps`, resuming through preemptions: done is the latest
    checkpoint's step, not the inference export (a SIGTERM checkpoints,
    exports and exits 0 mid-run)."""
    out_dir = work / "run"
    cmd = [sys.executable, "-m", "optispeech_tpu_torch.cli.train", "--config", CONFIG,
           "--packed-train", train_pak, "--packed-val", val_pak, "--device-cache",
           "--out-dir", out_dir, "--max-steps", max_steps, "--no-print-config",
           *_device_flag(device),
           f"data.train_filelist_path={pre / 'train.txt'}",
           f"data.valid_filelist_path={pre / 'val.txt'}",
           *stats_overrides(stats), *overrides]
    while True:
        before = _latest_ckpt_step(out_dir)
        if before >= int(max_steps):
            break
        run(cmd, log_path=log, check=False)
        after = _latest_ckpt_step(out_dir)
        if after <= before:
            raise SystemExit(f"train stage made no progress (checkpoint step {before} -> "
                             f"{after}); see {log}")
    if not (out_dir / "inference_ckpt" / "config.json").exists():
        # at the target but without the export: one more call restores the
        # final state, leaves the loop at once and exports
        run(cmd, log_path=log)
    return out_dir


def stage_average(work: Path, out_dir: Path, val_pak, log, device=None) -> Path:
    """Tail-average the last retained checkpoints and validate the averaged
    and the final weights (cli/average.py --compare):
    out_dir/avg_eval/compare.json."""
    cmp_path = out_dir / "avg_eval" / "compare.json"
    if not _fresh(cmp_path, _latest_ckpt_mtime(out_dir)):
        run([sys.executable, "-m", "optispeech_tpu_torch.cli.average", out_dir, "--last", "5",
             "--packed-val", val_pak, "--compare", *_device_flag(device)], log_path=log)
    return cmp_path


# metrics where HIGHER is better; everything else (losses, mcd, rmse) is
# lower-better. synth_wav_delta is a change diagnostic with no direction.
_HIGHER_BETTER = ("val/f1_score", "val/stoi", "val/pesq", "val/utmos")
_NO_DIRECTION = ("val/synth_wav_delta",)
# the AM sublosses that must end flat-or-better than their value when the
# discriminator turned on: the adversarial term must not buy its fall by
# degrading the acoustic model
_AM_GATE = (
    "total_loss/val_am_loss",
    "gen_subloss/val_align_loss",
    "gen_subloss/val_duration_loss",
    "gen_subloss/val_pitch_loss",
    "gen_subloss/val_energy_loss",
)
# absolute quality targets at the end of the run, used when no per-corpus
# calibration is given; the calibrated targets are stated fractions of the
# corpus's measured ceiling (stage_calibrate_gate, derive_targets)
_QUALITY_TARGETS = {"val/mcd": ("<=", 75.0), "val/stoi": (">=", 0.45)}
# campaign.py's fractions of the measured ceiling, set there against its
# labelled healthy and collapsed runs
_GATE_FRACTIONS = {
    "val/mcd": ("<=", 1.60),
    "val/stoi": (">=", 0.42),
    "val/f1_score": (">=", 0.80),
    "val/periodicity_loss": ("<=", 1.50),
}
# voicing metrics gate DIRECTION after disc-on: ending more than 15% worse
# than at disc-on is a voicing collapse
_VOICING_GATE_TOL = 0.15
_VOICING_GATE = ("val/f1_score", "val/periodicity_loss")


def audit_metrics(out_dir: Path, disc_on_step: int = 500,
                  quality_targets: dict | None = None) -> dict:
    """Direction-aware per-metric audit of the run's validation metrics.

    For every val metric: {first, at_disc_on, last, direction, pass}.
    `pass` means: the metric moved, AND (for AM-gate sublosses) it ends
    flat-or-better (<= +2%) than its value at the eval where the
    discriminator turned on, AND (for quality-target metrics) it meets the
    absolute target."""
    import csv
    from collections import defaultdict

    targets = _QUALITY_TARGETS if quality_targets is None else quality_targets
    series = defaultdict(list)
    with open(out_dir / "metrics.csv") as f:
        for row in csv.DictReader(f):
            if row["metric"].startswith(("val/", "total_loss/val", "gen_subloss/val")):
                series[row["metric"]].append((int(row["step"]), float(row["value"])))
    audit = {}
    for metric, pts in sorted(series.items()):
        pts.sort()
        vals = [v for _, v in pts]
        at_disc = next((v for s, v in pts if s >= disc_on_step), vals[-1])
        moves = len(set(vals)) > 1 or len(vals) < 2
        if metric in _NO_DIRECTION:
            direction, ok = "n/a", moves
        else:
            higher_better = metric in _HIGHER_BETTER
            rel = (vals[-1] - at_disc) / max(abs(at_disc), 1e-9)
            if abs(rel) <= 0.02:
                direction = "flat"
            else:
                direction = "improving" if (rel < 0) != higher_better else "regressing"
            ok = moves
            if metric in _AM_GATE:
                ok = ok and direction != "regressing"
            if metric in targets:
                op, target = targets[metric]
                met = vals[-1] <= target if op == "<=" else vals[-1] >= target
                audit_target = f"{op} {target}"
            else:
                met, audit_target = None, None
        entry = {
            "n_evals": len(vals),
            "first": vals[0],
            "at_disc_on": at_disc,
            "last": vals[-1],
            "direction": direction,
            "moves": moves,
            "min": min(vals),
            "max": max(vals),
            "pass": ok,
        }
        if metric in targets:
            entry["quality_target"] = audit_target
            entry["quality_met"] = met
        audit[metric] = entry
    return audit


def quality_verdict(audit: dict, quality_targets: dict | None = None) -> tuple[bool, list[str]]:
    """Red/green verdict: the AM gate, the voicing-direction gate and the
    quality targets."""
    targets = _QUALITY_TARGETS if quality_targets is None else quality_targets
    failures = []
    for m in _AM_GATE:
        if m in audit and audit[m]["direction"] == "regressing":
            failures.append(
                f"{m}: {audit[m]['at_disc_on']:.4g} -> {audit[m]['last']:.4g} "
                f"(regressing after disc-on)"
            )
    for m in _VOICING_GATE:
        if m not in audit:
            continue
        a = audit[m]
        higher_better = m in _HIGHER_BETTER
        rel = (a["last"] - a["at_disc_on"]) / max(abs(a["at_disc_on"]), 1e-9)
        bad = -rel if higher_better else rel
        if bad > _VOICING_GATE_TOL:
            failures.append(
                f"{m}: {a['at_disc_on']:.4g} -> {a['last']:.4g} "
                f"({rel * 100:+.1f}% after disc-on exceeds the "
                f"{_VOICING_GATE_TOL * 100:.0f}% voicing-collapse tolerance)"
            )
    for m, (op, target) in targets.items():
        if m in audit and audit[m].get("quality_met") is False:
            failures.append(f"{m}: last {audit[m]['last']:.4g} misses target {op} {target}")
    failures.extend(f"{m}: frozen" for m, a in audit.items() if not a["moves"])
    return (not failures), failures


def score(gt, rs, sr):
    """One re-synthesis `rs` scored against its ground truth `gt` (both at
    `sr`) with the trainer's own metric functions, as the calibration
    script of campaign.py scores it."""
    from optispeech_tpu_torch.training.metrics import (
        mel_cepstral_distortion,
        periodicity_metrics,
        resample_to_16k,
        stoi_score,
    )

    g16, r16 = resample_to_16k(gt, sr), resample_to_16k(rs, sr)
    n = min(len(g16), len(r16))
    perio, _, f1 = periodicity_metrics([g16], [r16])
    return {"mcd": float(mel_cepstral_distortion(gt, rs, sr)),
            "stoi": float(stoi_score([g16[:n]], [r16[:n]])),
            "periodicity_loss": float(perio), "f1_score": float(f1)}


def stage_calibrate_gate(work: Path, corpus: Path, pre: Path, log,
                         n_utts: int = 16) -> Path:
    """Measure the corpus's irreducible metric ceiling and derive the quality
    targets from it.

    For the first `n_utts` VAL utterances: re-synthesise the same (text,
    speaker, language) with fresh randomness (a fresh per-utterance F0
    scale, and for one bracket fresh per-phone durations and noise), then
    score the re-synthesis against the ground truth with `score`. The
    mean of the two brackets is the measured ceiling; targets are the
    stated _GATE_FRACTIONS of it."""
    result = work / "gate_calibration.json"
    if result.exists():
        return result
    script = work / "_gate_calibration.py"
    script.write_text(f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / "scripts")!r})
import numpy as np
from scipy.io import wavfile
from optispeech_tpu_torch.data import synthcorpus as _sc
from port_campaign import score

manifest = json.load(open({str(corpus / "manifest.json")!r}))
sr = manifest["sample_rate"]
f0_jitter = float(manifest.get("f0_jitter", 0.0))
meta = {{}}
for line in open({str(corpus / "metadata.csv")!r}, encoding="utf-8"):
    utt, spk, lang, text = line.rstrip("\\n").split("|")
    meta[utt] = (spk, lang, text)
val_ids = [l.strip().rsplit("/", 1)[-1] for l in open({str(pre / "val.txt")!r}) if l.strip()]
val_ids = val_ids[:{n_utts}]
spk_by_name = {{s.name: s for s in _sc.DEFAULT_SPEAKERS}}
lang_by_name = {{l.name: l for l in _sc.DEFAULT_LANGUAGES}}
use_ipa = manifest.get("frontend") == "en-g2p"
if use_ipa:
    from optispeech_tpu_torch.text.english import phonemize_english
rng = np.random.default_rng(int(manifest.get("seed", 0)) + 990_001)
id2idx = {{u: i for i, u in enumerate(sorted(meta))}}
base_seed = int(manifest.get("seed", 0))
rows = []
for i, utt in enumerate(val_ids):
    spk_name, lang_name, text = meta[utt]
    _, gt = wavfile.read({str(corpus)!r} + "/wavs/" + utt + ".wav")
    gt = gt.astype(np.float32) / 32767.0 if gt.dtype == np.int16 else gt.astype(np.float32)
    f0_scale = float(np.exp(f0_jitter * rng.standard_normal())) if f0_jitter else 1.0
    spk, lang = spk_by_name[spk_name], lang_by_name[lang_name]
    synth = ((lambda **kw: _sc.synth_utterance_ipa(phonemize_english(text), spk, lang, sr=sr, **kw))
             if use_ipa else (lambda **kw: _sc.synth_utterance(text, spk, lang, sr=sr, **kw)))
    # (a) fresh seed: fresh durations, noise and pitch scale (pessimistic)
    rs_fresh = synth(seed=base_seed + 500_000 + i, f0_scale=f0_scale)
    # (b) the original seed, a fresh pitch scale only (optimistic)
    rs_pitch = synth(seed=base_seed + id2idx[utt], f0_scale=f0_scale)
    rows.append({{"utt": utt, "f0_scale_fresh": f0_scale,
                 "fresh_seed": score(gt, rs_fresh, sr),
                 "pitch_only": score(gt, rs_pitch, sr)}})
keys = ("mcd", "stoi", "periodicity_loss", "f1_score")
fresh = {{k: float(np.mean([r["fresh_seed"][k] for r in rows])) for k in keys}}
pitch = {{k: float(np.mean([r["pitch_only"][k] for r in rows])) for k in keys}}
ceiling = {{k: (fresh[k] + pitch[k]) / 2.0 for k in keys}}
json.dump({{
    "method": "re-synthesis of the same val (text, speaker, language) scored against the "
              "ground truth with the trainer's own metric functions; the ceiling is the mean "
              "of the fresh_seed (durations, noise and F0 scale re-drawn) and pitch_only "
              "(F0 scale re-drawn) brackets",
    "n_utts": len(rows), "f0_jitter": f0_jitter,
    "ceiling": ceiling, "ceiling_fresh_seed": fresh, "ceiling_pitch_only": pitch,
    "per_utt": rows,
}}, open({str(result)!r}, "w"), indent=2)
print(json.dumps({{"ceiling": ceiling, "fresh": fresh, "pitch_only": pitch}}, indent=2))
""")
    run([sys.executable, script], log_path=log)
    return result


def derive_targets(calibration_path: Path) -> tuple[dict, dict]:
    """(quality_targets, derivation) from a gate_calibration.json via the
    stated _GATE_FRACTIONS."""
    cal = json.loads(calibration_path.read_text())
    ceiling = cal["ceiling"]
    key = {"val/mcd": "mcd", "val/stoi": "stoi",
           "val/f1_score": "f1_score", "val/periodicity_loss": "periodicity_loss"}
    targets, derivation = {}, {}
    for metric, (op, frac) in _GATE_FRACTIONS.items():
        c = ceiling[key[metric]]
        targets[metric] = (op, round(c * frac, 4))
        derivation[metric] = (
            f"{op} {frac} x measured ceiling {c:.4g} (re-synthesis, "
            f"n={cal['n_utts']})"
        )
    return targets, derivation


_TRACK = """
def track(wav, sr):
    g = np.gcd(16000, sr)
    w16 = resample_poly(wav.astype(np.float64), 16000 // g, sr // g).astype(np.float32)
    f0 = autocorr_pitch(w16, 16000, 160, len(w16) // 160, interpolate=False)
    voiced = f0[f0 > 0]
    # frames pinned at the tracker's f_max (800 Hz) are autocorrelation
    # saturation (octave errors), not a rendered pitch: left out of the median
    sat = voiced >= 0.98 * 800.0
    clean = voiced[~sat]
    return (float(np.median(clean)) if len(clean) else 0.0,
            float((f0 > 0).mean()),
            float(sat.mean()) if len(voiced) else 0.0)
"""


def stage_speaker_check(work: Path, out_dir: Path, corpus: Path, log, device=None) -> Path:
    """Synthesise per sid from the trained checkpoint (fused, on `device`);
    the tracked F0 must land in each speaker's assigned range. The fused
    block's launches and the synthesise calls are recorded beside."""
    result = work / "speaker_f0.json"
    if _fresh(result, _latest_ckpt_mtime(out_dir)):
        return result
    script = work / "_speaker_check.py"
    script.write_text(f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
import numpy as np
from scipy.signal import resample_poly
from optispeech_tpu_torch.data import synthcorpus as _sc
from optispeech_tpu_torch.data.dsp import autocorr_pitch
from optispeech_tpu_torch.models.optispeech import OptiSpeech
from optispeech_tpu_torch.ops import fused_convnext

manifest = json.load(open({str(corpus / "manifest.json")!r}))
api = OptiSpeech.load_from_checkpoint({str(out_dir / "inference_ckpt")!r}, device={device!r},
                                      fused=True)
stats = api.cfg.data.statistics
if manifest.get("frontend") == "en-g2p":
    from optispeech_tpu_torch.text.english import phonemize_english
    text = "the water was ready in the morning light"
    def gt_synth(spk, lang, sr):
        return _sc.synth_utterance_ipa(phonemize_english(text), spk, lang, sr=sr, seed=7)
else:
    text = "dake mito nasebo kuna seta"
    def gt_synth(spk, lang, sr):
        return _sc.synth_utterance(text, spk, lang, sr=sr, seed=7)
out = {{}}
{_TRACK}
fused_convnext.convnext_block_fused.launches = 0
calls = 0
spk_by_name = {{s.name: s for s in _sc.DEFAULT_SPEAKERS}}
lang0 = _sc.DEFAULT_LANGUAGES[0]
for sid, name in enumerate(manifest["speakers"]):
    # neutral prosody factors: the config's styling defaults shift pitch and
    # energy; the check measures the raw speaker conditioning
    res = api.synthesise(api.prepare_input(
        text, speaker=sid, split_sentences=False, d_factor=1.0, p_factor=1.0, e_factor=1.0))
    calls += 1
    wav = np.asarray(res.wav)[0, : int(res.wav_lengths[0])]
    sr = api.sample_rate
    med, vf, sat = track(wav, sr)
    # control: the same tracker on a ground-truth utterance of this speaker
    gt_med, gt_vf, gt_sat = track(gt_synth(spk_by_name[name], lang0, sr), sr)
    # the pitch predictor's output for this sid, denormalised to Hz
    pred = np.asarray(res.pitch)[0] * stats.pitch_std + stats.pitch_mean
    pred_voiced = pred[pred > stats.pitch_min * 0.5]
    out[name] = {{
        "assigned_f0": manifest["speakers"][name]["f0_base"],
        "tracked_median_f0": med,
        "voiced_frac": vf,
        "tracker_saturated_frac": sat,
        "gt_control_median_f0": gt_med,
        "gt_control_voiced_frac": gt_vf,
        "gt_control_saturated_frac": gt_sat,
        "predicted_median_f0": float(np.median(pred_voiced)) if len(pred_voiced) else 0.0,
        "wav_seconds": float(len(wav) / sr),
    }}

# p_factor responsiveness: scaling the predicted pitch should move the
# rendered F0 of the lowest and the highest speaker
for sid, name in [(0, "spk_low"), (len(manifest["speakers"]) - 1, list(manifest["speakers"])[-1])]:
    sweep = {{}}
    for pf in (0.5, 0.7, 1.0, 1.3, 2.0):
        res = api.synthesise(api.prepare_input(
            text, speaker=sid, split_sentences=False, d_factor=1.0, p_factor=pf, e_factor=1.0))
        calls += 1
        wav = np.asarray(res.wav)[0, : int(res.wav_lengths[0])]
        med, vf, sat = track(wav, api.sample_rate)
        # on barely voiced audio the tracker reads its own floor: the
        # headline Hz is suppressed below half voiced or when saturated
        reliable = vf >= 0.5 and sat < 0.5
        sweep[str(pf)] = {{
            "f0": med if reliable else None,
            "raw_tracked_f0": med,
            "voiced_frac": vf,
            "tracker_saturated_frac": sat,
            "tracker_reliable": reliable,
        }}
    out.setdefault("p_factor_sweep", {{}})[name] = sweep
out["_kernels"] = {{"device": str(api.device), "synthesise_calls": calls,
                   "b1_launches": fused_convnext.convnext_block_fused.launches}}
json.dump(out, open({str(result)!r}, "w"), indent=2)
print(json.dumps(out, indent=2))
""")
    run([sys.executable, script], log_path=log)
    return result


def stage_export(work: Path, out_dir: Path, log):
    artifact = work / "artifact"
    if _fresh(artifact / "metadata.json", _latest_ckpt_mtime(out_dir)):
        return artifact
    if artifact.exists():  # a stale export from an earlier stop of this work dir
        shutil.rmtree(artifact)
    run([sys.executable, "-m", "optispeech_tpu_torch.cli.export",
         out_dir / "inference_ckpt", artifact,
         "--text-buckets", "32,64", "--batch-sizes", "1,2,4,8"], log_path=log)
    return artifact


def stage_serve_check(work: Path, artifact: Path, corpus: Path, log, device=None) -> Path:
    """Serve the exported artifact over HTTP on `device` and query each
    speaker and /stream; record latencies and the tracked F0 of the served
    audio."""
    result = work / "serve_check.json"
    meta = artifact / "metadata.json"
    if _fresh(result, meta.stat().st_mtime if meta.exists() else 0.0):
        return result
    script = work / "_serve_check.py"
    script.write_text(f"""
import base64, json, sys, threading, time, urllib.request
sys.path.insert(0, {str(REPO)!r})
import numpy as np
from scipy.signal import resample_poly
from optispeech_tpu_torch.cli.serve import load_model, serve
from optispeech_tpu_torch.data.dsp import autocorr_pitch

manifest = json.load(open({str(corpus / "manifest.json")!r}))
model = load_model({str(artifact)!r}, device={device!r})
httpd = serve(model, host="127.0.0.1", port=0, max_batch=8, batch_wait_ms=30.0,
              request_timeout_s=1800.0)
thread = threading.Thread(target=httpd.serve_forever, daemon=True)
thread.start()
base = f"http://127.0.0.1:{{httpd.server_address[1]}}"

def post(payload, path="/synthesise"):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={{"Content-Type": "application/json"}}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=1800) as r:
        body = r.read()
    return (time.perf_counter() - t0) * 1e3, body

try:
    post({{"text": "the water was ready in the morning", "speaker": 0, "format": "json"}})
    out = {{}}
    sr = model.sample_rate
    for sid, name in enumerate(manifest["speakers"]):
        wall_ms, body = post({{"text": "the water was ready in the morning",
                               "speaker": sid, "format": "json",
                               "d_factor": 1.0, "p_factor": 1.0, "e_factor": 1.0}})
        obj = json.loads(body)
        pcm = np.frombuffer(base64.b64decode(obj["pcm16_b64"]), "<i2")
        wav = pcm.astype(np.float32) / 32767.0
        g = np.gcd(16000, sr)
        w16 = resample_poly(wav.astype(np.float64), 16000 // g, sr // g).astype(np.float32)
        f0 = autocorr_pitch(w16, 16000, 160, len(w16) // 160, interpolate=False)
        voiced = f0[f0 > 0]
        clean = voiced[voiced < 0.98 * 800.0]
        out[name] = {{
            "assigned_f0": manifest["speakers"][name]["f0_base"],
            "served_median_f0": float(np.median(clean)) if len(clean) else 0.0,
            "served_saturated_frac": float((voiced >= 0.98 * 800.0).mean()) if len(voiced) else 0.0,
            "wall_ms": wall_ms,
            "audio_seconds": float(len(wav) / sr),
            "truncated": obj["truncated"],
        }}
    wall_ms, body = post({{"text": "the water was ready"}}, path="/stream")
    out["_stream"] = {{"bytes": len(body), "wall_ms": wall_ms}}
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        out["_health"] = json.load(r)
finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
json.dump(out, open({str(result)!r}, "w"), indent=2)
print(json.dumps(out, indent=2))
""")
    run([sys.executable, script], log_path=log)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--work-dir", default=str(REPO / "runs" / "port_campaign"),
                   help="stage outputs and checkpoints")
    p.add_argument("--n-utterances", type=int, default=600)
    p.add_argument("--max-steps", type=int, default=3000)
    p.add_argument("--evidence-dir", default=None,
                   help="where the evidence files are copied (default: WORK_DIR/evidence)")
    p.add_argument("--device", default=None,
                   help="the device of the training, speaker-check, averaging and serving "
                        "stages (default: the card; `cpu` runs them on the CPU)")
    p.add_argument("--f0-jitter", type=float, default=0.08,
                   help="sigma of the corpus's lognormal per-utterance F0 scale")
    p.add_argument("--target-mcd", type=float, default=None,
                   help="explicit quality-gate MCD ceiling (dB); default: derived from the "
                        "measured re-synthesis ceiling (stage_calibrate_gate)")
    p.add_argument("--target-stoi", type=float, default=None,
                   help="explicit quality-gate STOI floor; default: derived from the measured "
                        "re-synthesis ceiling")
    p.add_argument("--disc-on-step", type=int, default=500,
                   help="optimizer step where the discriminator turns on "
                        "(train_args.pretraining_steps): anchors the AM-subloss gate")
    p.add_argument("overrides", nargs="*",
                   help="extra dotted config overrides passed to the train CLI")
    args = p.parse_args(argv)

    work = Path(args.work_dir)
    work.mkdir(parents=True, exist_ok=True)
    log = work / "campaign.log"
    stage_seconds = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        stage_seconds[name] = time.perf_counter() - t0
        return out

    corpus = timed("corpus", stage_corpus, work, args.n_utterances, log,
                   f0_jitter=args.f0_jitter)
    pre = timed("preprocess", stage_preprocess, work, corpus, log)
    stats = timed("stats", stage_stats, work, pre, log)
    train_pak, val_pak = timed("pack", stage_pack, work, pre, log)
    calibration = timed("calibrate", stage_calibrate_gate, work, corpus, pre, log)
    out_dir = timed("train", stage_train, work, pre, train_pak, val_pak, stats,
                    args.max_steps, log, overrides=args.overrides, device=args.device)

    if args.target_mcd is not None or args.target_stoi is not None:
        targets = {
            "val/mcd": ("<=", args.target_mcd if args.target_mcd is not None else 75.0),
            "val/stoi": (">=", args.target_stoi if args.target_stoi is not None else 0.45),
        }
        derivation = {m: "explicit CLI override" for m in targets}
    else:
        targets, derivation = derive_targets(calibration)
    audit = audit_metrics(out_dir, disc_on_step=args.disc_on_step, quality_targets=targets)
    print(json.dumps(audit, indent=2))
    ok, failures = quality_verdict(audit, quality_targets=targets)
    if ok:
        print("QUALITY GATE: PASS (AM sublosses flat-or-better after disc-on; "
              "quality targets met)")
    else:
        print("QUALITY GATE: FAIL")
        for f in failures:
            print(f"  - {f}")

    f0_check = timed("speaker_check", stage_speaker_check, work, out_dir, corpus, log,
                     device=args.device)
    avg_compare = timed("average", stage_average, work, out_dir, val_pak, log,
                        device=args.device)
    artifact = timed("export", stage_export, work, out_dir, log)
    serve_check = timed("serve_check", stage_serve_check, work, artifact, corpus, log,
                        device=args.device)

    ev = Path(args.evidence_dir) if args.evidence_dir else work / "evidence"
    ev.mkdir(parents=True, exist_ok=True)
    shutil.copy(out_dir / "metrics.csv", ev / "metrics.csv")
    (ev / "metric_audit.json").write_text(json.dumps(audit, indent=2))
    shutil.copy(f0_check, ev / "speaker_f0.json")
    if avg_compare.exists():
        shutil.copy(avg_compare, ev / "avg_compare.json")
    shutil.copy(serve_check, ev / "serve_check.json")
    shutil.copy(corpus / "manifest.json", ev / "corpus_manifest.json")
    shutil.copy(stats, ev / "stats.json")
    shutil.copy(calibration, ev / "gate_calibration.json")
    info = {
        "max_steps": args.max_steps,
        "n_utterances": args.n_utterances,
        "device": args.device,
        "overrides": args.overrides,
        "disc_on_step": args.disc_on_step,
        "quality_targets": {m: list(t) for m, t in targets.items()},
        "quality_target_derivation": derivation,
        "quality_gate": "PASS" if ok else "FAIL",
        "quality_failures": failures,
        "stage_seconds": stage_seconds,
        "finished_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    (ev / "run_info.json").write_text(json.dumps(info, indent=2))
    print(f"campaign complete; evidence -> {ev}")
    return info


if __name__ == "__main__":
    main()
