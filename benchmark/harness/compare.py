"""The comparison that decides `correct` for a synthesis cell.

The program's answers for some rows (what its timed path produced: integer
durations, pitch and energy per token, and the audio it handed over, as
pcm16 or µ-law) are held against the plain reference, which runs the same
ids and factors at the same padded shapes, in float32 with TF32 off:

- `dur_mismatch_pct`: the share of valid tokens whose duration differs from
  the reference's. A duration is a ceiling, so a rounding difference near an
  integer moves it by one frame; a lower precision moves many more.
- `pitch_gap`, `energy_gap`: rms(program - reference) / rms(reference) over
  the valid tokens of every compared row.
- `wav_gap`: the worst row's rms(program - reference) / rms(reference) over
  its valid samples. The reference decodes the program's durations (the
  start of the frame-rate stage is the program's: one moved frame would
  shift every later sample), from its own hidden states; the durations are
  judged by themselves above. Both sides' audio go through the same wire
  (pcm16 rounding, or µ-law coding and decoding).

A row whose audio is not as long as its durations say fails the comparison
outright (`wav_gap` = MISSING).
"""

from dataclasses import dataclass

import numpy as np

MISSING = 1e9
MU = 255.0


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Rows:
    """Rows the program answered, at the shapes it ran them."""

    ids: np.ndarray  # (R, text_width) int64, zero-padded as the program padded them
    lengths: np.ndarray  # (R,) valid tokens
    factors: tuple  # (d, p, e)
    n_frames: int
    durations: np.ndarray  # (R, >= max length) int, the program's
    pitch: np.ndarray  # (R, >= max length) float, the program's
    energy: np.ndarray
    audio: list  # per row: int16 pcm samples or uint8 µ-law codes
    wire: str  # "pcm16" or "mulaw"


def mulaw_encode(x):
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(MU * np.abs(x)) / np.log1p(MU)
    return np.round((y + 1.0) * 0.5 * 255.0).astype(np.uint8)


def mulaw_decode(codes):
    y = np.asarray(codes).astype(np.float32) / 255.0 * 2.0 - 1.0
    return (np.sign(y) * ((1.0 + MU) ** np.abs(y) - 1.0) / MU).astype(np.float32)


def _wire(wav, wire):
    """Reference float audio through the wire, back to float."""
    if wire == "mulaw":
        return mulaw_decode(mulaw_encode(wav))
    return np.round(wav * 32767.0).astype(np.int16).astype(np.float32) / 32767.0


def _answer(audio, wire):
    if wire == "mulaw":
        return mulaw_decode(audio)
    return np.asarray(audio).astype(np.float32) / 32767.0


def _rms_rel(a, b):
    den = float(np.sqrt(np.mean(np.square(b, dtype=np.float64))))
    return float(np.sqrt(np.mean(np.square(a - b, dtype=np.float64)))) / max(den, 1e-12)


def reference_rows(ref, rows: Rows, device, block: int = 8):
    """The reference's token-rate outputs and frame-rate audio for `rows`,
    in blocks of `block` rows. Returns (durations, pitch, energy, wavs)."""
    import torch

    from .common import reference_mode

    d, p, e = rows.factors
    out = {"durations": [], "pitch": [], "energy": [], "wav": []}
    hop = ref.hop
    with reference_mode():
        for i in range(0, len(rows.lengths), block):
            x = torch.as_tensor(rows.ids[i:i + block], device=device)
            xl = torch.as_tensor(rows.lengths[i:i + block], device=device)
            enc = ref.encode(x, xl, d, p, e)
            prog_dur = torch.as_tensor(rows.durations[i:i + block, :x.shape[1]],
                                       device=device).to(torch.int32)
            y_len = torch.clamp(prog_dur.sum(1), max=rows.n_frames)
            wav = ref.decode(enc["hidden"], prog_dur, enc["x_mask"], y_len, rows.n_frames)
            wav_len = (y_len * hop).cpu().numpy()
            wav = wav.cpu().numpy()
            out["wav"] += [wav[j, :wav_len[j]] for j in range(len(wav_len))]
            for k in ("durations", "pitch", "energy"):
                out[k].append(enc[k].cpu().numpy())
    return (np.concatenate(out["durations"]), np.concatenate(out["pitch"]),
            np.concatenate(out["energy"]), out["wav"])


def compare(ref, batches: list, device) -> dict:
    """The compared numbers over every row of `batches` (a list of Rows)."""
    mismatched = tokens = 0
    pv = {"pitch": ([], []), "energy": ([], [])}
    worst = 0.0
    for rows in batches:
        r_dur, r_pitch, r_energy, r_wav = reference_rows(ref, rows, device)
        for j, n in enumerate(rows.lengths):
            n = int(n)
            mismatched += int((rows.durations[j, :n] != r_dur[j, :n]).sum())
            tokens += n
            for key, prog, refv in (("pitch", rows.pitch, r_pitch),
                                    ("energy", rows.energy, r_energy)):
                pv[key][0].append(prog[j, :n])
                pv[key][1].append(refv[j, :n])
            answer = _answer(rows.audio[j], rows.wire)
            if answer.shape != r_wav[j].shape:
                worst = MISSING
                continue
            worst = max(worst, _rms_rel(answer, _wire(r_wav[j], rows.wire)))
    out = {"dur_mismatch_pct": 100.0 * mismatched / max(tokens, 1), "wav_gap": worst}
    for key, (prog, refv) in pv.items():
        out[f"{key}_gap"] = _rms_rel(np.concatenate(prog), np.concatenate(refv)) if prog else 0.0
    return out


def checks(numbers: dict, limits: dict) -> list:
    """A Check for every limit; a number that is missing fails its limit."""
    return [Check(k, float(numbers.get(k, MISSING)), float(limits[k])) for k in limits]
