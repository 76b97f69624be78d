"""Speech-like synthetic corpus generator, formant synthesis (the port's own
copy of `optispeech_tpu/data/synthcorpus.py`).

A self-contained multi-speaker / multi-language corpus for driving the
workflow (preprocess -> stats -> train -> infer) without a speech dataset:
utterances are additive formant synthesis with

- per-SPEAKER voice identity: F0 base + vocal-tract (formant-scale) factor,
- per-LANGUAGE phone inventories and tempo, so language ids carry signal
  beyond the character distribution,
- a deterministic character -> phone mapping (`char` front end), or real
  English text rendered from the en-g2p tokenizer's IPA phones (`en-g2p`),
  so text-to-audio alignment is learnable by a TTS model.

The audio is not speech, but it has speech's structure: voiced harmonic
segments with formant resonances, noise consonants, stop gaps, pauses,
F0 declination + vibrato, and an amplitude envelope.

    python -m optispeech_tpu_torch.data.synthcorpus OUT_DIR [--n-utterances N]
        [--frontend char|en-g2p] [--seed S]
"""

import dataclasses
import json
from pathlib import Path

import numpy as np

# vowel formants (F1, F2, F3) Hz — rough adult-male targets
_VOWELS = {
    "a": (800.0, 1200.0, 2500.0),
    "e": (500.0, 1900.0, 2500.0),
    "i": (300.0, 2300.0, 3000.0),
    "o": (450.0, 800.0, 2400.0),
    "u": (325.0, 700.0, 2300.0),
}
# noise consonants: (band_lo, band_hi) Hz
_FRICATIVES = {
    "s": (4000.0, 9000.0),
    "f": (2000.0, 7000.0),
    "h": (500.0, 3000.0),
    "r": (1000.0, 3500.0),
}
# stops: closure gap + short burst centred at (hz)
_STOPS = {
    "t": 4500.0, "k": 2500.0, "b": 700.0, "d": 3000.0, "p": 1200.0, "g": 2000.0,
}
# nasal-ish voiced consonants: single low resonance
_NASALS = {"m": 280.0, "n": 320.0, "l": 400.0}


@dataclasses.dataclass(frozen=True)
class Speaker:
    name: str
    f0_base: float        # Hz
    formant_scale: float  # vocal-tract length factor (1.0 = neutral)
    vibrato_hz: float = 5.0
    vibrato_depth: float = 0.015


@dataclasses.dataclass(frozen=True)
class Language:
    name: str
    consonants: str
    vowels: str
    phone_ms: float  # mean phone duration (tempo)


DEFAULT_SPEAKERS = (
    Speaker("spk_low", 110.0, 1.06),
    Speaker("spk_mid", 150.0, 1.0),
    Speaker("spk_high", 205.0, 0.88),
    Speaker("spk_top", 255.0, 0.82),
)
DEFAULT_LANGUAGES = (
    Language("en-us", consonants="bdkmnst", vowels="aeiou", phone_ms=110.0),
    Language("de", consonants="fghlpr", vowels="aiu", phone_ms=140.0),
)


def _formant_envelope(freqs: np.ndarray, formants, bandwidths=(90.0, 120.0, 160.0)):
    """|H(f)| of cascaded resonators, normalized to peak 1."""
    h = np.ones_like(freqs)
    for fc, bw in zip(formants, bandwidths):
        h = h * (bw / 2.0) ** 2 / ((freqs - fc) ** 2 + (bw / 2.0) ** 2) * 4.0
    return h / max(h.max(), 1e-9)


def _voiced_segment(n, sr, f0_curve, formants, rng):
    """Additive harmonic synthesis under a formant envelope."""
    t = np.arange(n) / sr
    phase0 = 2 * np.pi * np.cumsum(f0_curve) / sr
    n_harm = max(int((sr / 2 - 200.0) / max(f0_curve.mean(), 50.0)), 3)
    n_harm = min(n_harm, 40)
    k = np.arange(1, n_harm + 1)
    freqs = k * f0_curve.mean()
    # -6 dB/oct glottal rolloff + an envelope floor so the fundamental stays
    # prominent (pitch trackers otherwise octave-jump onto the formant peaks)
    amps = (0.35 + _formant_envelope(freqs, formants)) / k
    sig = (np.sin(phase0[:, None] * k[None, :]) * amps[None, :]).sum(axis=1)
    return sig.astype(np.float32)


def _noise_segment(n, sr, lo, hi, rng):
    noise = rng.standard_normal(n)
    spec = np.fft.rfft(noise)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    gate = ((f >= lo) & (f <= hi)).astype(float)
    # soft band edges
    gate = np.convolve(gate, np.ones(9) / 9.0, mode="same")
    return np.fft.irfft(spec * gate, n).astype(np.float32) * 2.0


def _env(n, attack=0.15, release=0.2):
    e = np.ones(n)
    a, r = max(int(n * attack), 1), max(int(n * release), 1)
    e[:a] = np.linspace(0, 1, a)
    e[-r:] = np.linspace(1, 0, r)
    return e


def synth_utterance(text: str, speaker: Speaker, language: Language,
                    sr: int = 24000, seed: int = 0,
                    f0_scale: float = 1.0) -> np.ndarray:
    """Render `text` (chars from the language's inventory + spaces) to audio.

    `f0_scale` shifts the whole utterance's F0 contour off the speaker base.
    The round-3 campaign showed that when F0 is a pure function of speaker
    identity the GAN decoder can learn pitch from the sid embedding and
    ignore the pitch-embedding pathway entirely (campaign_r3/README.md layer
    3); per-utterance variation makes the pitch pathway load-bearing, like
    natural within-speaker F0 spread."""
    rng = np.random.default_rng(seed)
    pieces = []
    phones = [c for c in text]
    n_ph = max(len(phones), 1)
    for i, ch in enumerate(phones):
        progress = i / n_ph
        dur_ms = language.phone_ms * rng.uniform(0.75, 1.3)
        if i >= n_ph - 2:
            dur_ms *= 1.35  # final lengthening
        n = int(sr * dur_ms / 1000.0)
        if ch == " ":
            pieces.append(np.zeros(int(n * 0.8), np.float32))
            continue
        # F0: per-utterance scale + declination + vibrato + jitter
        f0 = speaker.f0_base * f0_scale * (1.12 - 0.2 * progress)
        t = np.arange(n) / sr
        f0_curve = f0 * (1.0
                         + speaker.vibrato_depth
                         * np.sin(2 * np.pi * speaker.vibrato_hz * t)
                         + 0.004 * rng.standard_normal(n).cumsum() / np.sqrt(n))
        if ch in _VOWELS:
            formants = tuple(f / speaker.formant_scale for f in _VOWELS[ch])
            seg = _voiced_segment(n, sr, f0_curve, formants, rng)
            seg *= _env(n, 0.12, 0.18) * 0.55
        elif ch in _FRICATIVES:
            lo, hi = _FRICATIVES[ch]
            seg = _noise_segment(n, sr, lo / speaker.formant_scale,
                                 hi / speaker.formant_scale, rng)
            seg *= _env(n, 0.3, 0.3) * 0.18
        elif ch in _STOPS:
            gap = np.zeros(int(n * 0.55), np.float32)
            nb = max(n - len(gap), 8)
            fc = _STOPS[ch] / speaker.formant_scale
            burst = _noise_segment(nb, sr, fc * 0.6, fc * 1.6, rng)
            seg = np.concatenate([gap, burst * _env(nb, 0.02, 0.7) * 0.3])
        elif ch in _NASALS:
            fc = _NASALS[ch] / speaker.formant_scale
            seg = _voiced_segment(n, sr, f0_curve, (fc, fc * 3.2, 2400.0), rng)
            seg *= _env(n, 0.2, 0.2) * 0.4
        else:  # unknown char: schwa-ish vowel
            formants = tuple(f / speaker.formant_scale for f in (500.0, 1500.0, 2500.0))
            seg = _voiced_segment(n, sr, f0_curve, formants, rng)
            seg *= _env(n, 0.15, 0.2) * 0.45
        pieces.append(seg.astype(np.float32))
    wav = np.concatenate(pieces) if pieces else np.zeros(sr // 10, np.float32)
    wav = wav + 1e-4 * rng.standard_normal(len(wav)).astype(np.float32)
    peak = np.abs(wav).max()
    return (0.7 * wav / max(peak, 1e-6)).astype(np.float32)


# ---------------------------------------------------------------------------
# IPA-phone frontend: synthesize audio from the en-g2p tokenizer's IPA output
# (text/english.py) so real English text drives a 1:1 phone->sound mapping —
# the campaign then exercises the SAME symbol inventory the espeak path uses
# (reference text/tokenizers.py:84-98).
# ---------------------------------------------------------------------------

# monophthong vowels: (F1, F2, F3); r-colored vowels get a lowered F3
_IPA_VOWELS = {
    "æ": (660.0, 1700.0, 2400.0), "ɑː": (750.0, 1100.0, 2500.0),
    "ʌ": (620.0, 1200.0, 2400.0), "ə": (500.0, 1500.0, 2500.0),
    "ɛ": (550.0, 1800.0, 2500.0), "ɪ": (400.0, 2000.0, 2600.0),
    "iː": (300.0, 2300.0, 3000.0), "ʊ": (450.0, 1000.0, 2300.0),
    "uː": (325.0, 700.0, 2300.0), "ɔː": (500.0, 850.0, 2400.0),
    "ɜː": (490.0, 1350.0, 1690.0), "ɚ": (490.0, 1350.0, 1690.0),
}
# diphthongs: (start, end) formant targets, interpolated across the phone
_IPA_DIPHTHONGS = {
    "eɪ": ((500.0, 1900.0, 2500.0), (350.0, 2200.0, 2800.0)),
    "aɪ": ((750.0, 1300.0, 2500.0), (400.0, 2100.0, 2700.0)),
    "aʊ": ((750.0, 1300.0, 2500.0), (450.0, 900.0, 2300.0)),
    "ɔɪ": ((500.0, 850.0, 2400.0), (400.0, 2100.0, 2700.0)),
    "oʊ": ((460.0, 900.0, 2400.0), (350.0, 750.0, 2300.0)),
}
_IPA_FRICATIVES = {  # (lo, hi, voiced)
    "s": (4000.0, 9000.0, False), "z": (4000.0, 9000.0, True),
    "f": (2000.0, 7000.0, False), "v": (2000.0, 7000.0, True),
    "θ": (3500.0, 8000.0, False), "ð": (3500.0, 8000.0, True),
    "ʃ": (2000.0, 6000.0, False), "ʒ": (2000.0, 6000.0, True),
    "h": (500.0, 3000.0, False),
}
_IPA_STOPS = {"p": 1200.0, "b": 700.0, "t": 4500.0, "d": 3000.0,
              "k": 2500.0, "ɡ": 2000.0}
_IPA_AFFRICATES = {"tʃ": (2000.0, 6000.0, False), "dʒ": (2000.0, 6000.0, True)}
# sonorant consonants: formant-like voiced resonances
_IPA_SONORANTS = {
    "m": (280.0, 900.0, 2200.0), "n": (320.0, 1100.0, 2400.0),
    "ŋ": (350.0, 1300.0, 2300.0), "l": (400.0, 1100.0, 2600.0),
    "ɹ": (450.0, 1200.0, 1600.0), "w": (350.0, 750.0, 2300.0),
    "j": (300.0, 2200.0, 3000.0),
}

_IPA_MULTI = sorted(
    list(_IPA_DIPHTHONGS) + list(_IPA_AFFRICATES) + ["ɑː", "iː", "uː", "ɔː", "ɜː"],
    key=len, reverse=True,
)


def parse_ipa(ipa: str) -> list[str]:
    """Split an IPA string into phones (multi-char units first); stress marks
    and unknown symbols are dropped; spaces become pause phones."""
    phones, i = [], 0
    while i < len(ipa):
        for m in _IPA_MULTI:
            if ipa.startswith(m, i):
                phones.append(m)
                i += len(m)
                break
        else:
            ch = ipa[i]
            if ch == " ":
                phones.append(" ")
            elif (ch in _IPA_VOWELS or ch in _IPA_FRICATIVES or ch in _IPA_STOPS
                  or ch in _IPA_SONORANTS):
                phones.append(ch)
            # else: stress mark / length mark / unknown -> drop
            i += 1
    return phones


def synth_utterance_ipa(ipa: str, speaker: Speaker, language: Language,
                        sr: int = 24000, seed: int = 0,
                        f0_scale: float = 1.0) -> np.ndarray:
    """Render an IPA phoneme string (en-g2p output) to formant audio with a
    1:1 phone->sound mapping; same speaker/F0 model as `synth_utterance`."""
    rng = np.random.default_rng(seed)
    pieces = []
    phones = parse_ipa(ipa)
    n_ph = max(len(phones), 1)
    for i, ph in enumerate(phones):
        progress = i / n_ph
        dur_ms = language.phone_ms * rng.uniform(0.75, 1.3)
        if ph in _IPA_VOWELS or ph in _IPA_DIPHTHONGS:
            dur_ms *= 1.2
        elif ph in _IPA_STOPS:
            dur_ms *= 0.7
        if i >= n_ph - 2:
            dur_ms *= 1.35
        n = int(sr * dur_ms / 1000.0)
        if ph == " ":
            pieces.append(np.zeros(int(n * 0.8), np.float32))
            continue
        f0 = speaker.f0_base * f0_scale * (1.12 - 0.2 * progress)
        t = np.arange(n) / sr
        f0_curve = f0 * (1.0
                         + speaker.vibrato_depth
                         * np.sin(2 * np.pi * speaker.vibrato_hz * t)
                         + 0.004 * rng.standard_normal(n).cumsum() / np.sqrt(n))
        fs = speaker.formant_scale
        if ph in _IPA_VOWELS:
            formants = tuple(f / fs for f in _IPA_VOWELS[ph])
            seg = _voiced_segment(n, sr, f0_curve, formants, rng)
            seg *= _env(n, 0.12, 0.18) * 0.55
        elif ph in _IPA_DIPHTHONGS:
            start, end = _IPA_DIPHTHONGS[ph]
            chunks = []
            for k in range(3):  # 3-step formant glide
                a = k / 2.0
                fmt = tuple((s * (1 - a) + e * a) / fs for s, e in zip(start, end))
                nk = n // 3 if k < 2 else n - 2 * (n // 3)
                chunks.append(_voiced_segment(nk, sr, f0_curve[:nk], fmt, rng))
            seg = np.concatenate(chunks)
            seg *= _env(n, 0.12, 0.18) * 0.55
        elif ph in _IPA_FRICATIVES:
            lo, hi, voiced = _IPA_FRICATIVES[ph]
            seg = _noise_segment(n, sr, lo / fs, hi / fs, rng) * 0.18
            if voiced:
                seg = seg * 0.6 + 0.25 * _voiced_segment(
                    n, sr, f0_curve, (300.0 / fs, 1400.0 / fs, 2500.0 / fs), rng)
            seg *= _env(n, 0.3, 0.3)
        elif ph in _IPA_AFFRICATES:
            lo, hi, voiced = _IPA_AFFRICATES[ph]
            gap = np.zeros(int(n * 0.4), np.float32)
            nb = max(n - len(gap), 8)
            burst = _noise_segment(nb, sr, lo / fs, hi / fs, rng) * 0.25
            if voiced:
                burst = burst * 0.7 + 0.2 * _voiced_segment(
                    nb, sr, f0_curve[:nb], (300.0 / fs, 1400.0 / fs, 2500.0 / fs), rng)
            seg = np.concatenate([gap, burst * _env(nb, 0.05, 0.5)])
        elif ph in _IPA_STOPS:
            gap = np.zeros(int(n * 0.55), np.float32)
            nb = max(n - len(gap), 8)
            fc = _IPA_STOPS[ph] / fs
            burst = _noise_segment(nb, sr, fc * 0.6, fc * 1.6, rng)
            seg = np.concatenate([gap, burst * _env(nb, 0.02, 0.7) * 0.3])
        elif ph in _IPA_SONORANTS:
            formants = tuple(f / fs for f in _IPA_SONORANTS[ph])
            seg = _voiced_segment(n, sr, f0_curve, formants, rng)
            seg *= _env(n, 0.2, 0.2) * 0.4
        else:  # unreachable after parse_ipa, defensive schwa
            formants = tuple(f / fs for f in (500.0, 1500.0, 2500.0))
            seg = _voiced_segment(n, sr, f0_curve, formants, rng)
            seg *= _env(n, 0.15, 0.2) * 0.45
        pieces.append(seg.astype(np.float32))
    wav = np.concatenate(pieces) if pieces else np.zeros(sr // 10, np.float32)
    wav = wav + 1e-4 * rng.standard_normal(len(wav)).astype(np.float32)
    peak = np.abs(wav).max()
    return (0.7 * wav / max(peak, 1e-6)).astype(np.float32)


# real-English word pools for the en-g2p frontend; the two "languages" use
# disjoint vocabulary + tempo so language ids still carry signal
_EN_WORDS_A = (
    "the water was ready and the morning light came over the hill "
    "she said the answer to the question was simple people walk and talk "
    "about the world every day a good book takes time to read the young "
    "children play near the old stone house think of a number between one "
    "and ten"
).split()
_EN_WORDS_B = (
    "money moves fast in the city market friends gather round the warm "
    "fire to share food and stories the teacher wrote seven words on the "
    "board this train leaves early so bring your coat work hard learn "
    "much and rest well the river runs south past the green field"
).split()


def random_english_text(language: Language, rng, n_words=(3, 7)) -> str:
    pool = _EN_WORDS_A if language.name.startswith("en") else _EN_WORDS_B
    k = int(rng.integers(n_words[0], n_words[1] + 1))
    return " ".join(pool[int(rng.integers(len(pool)))] for _ in range(k))


def random_text(language: Language, rng, n_words=(3, 7)) -> str:
    words = []
    for _ in range(rng.integers(n_words[0], n_words[1] + 1)):
        syls = []
        for _ in range(rng.integers(1, 4)):
            c = language.consonants[rng.integers(len(language.consonants))]
            v = language.vowels[rng.integers(len(language.vowels))]
            syls.append(c + v)
        words.append("".join(syls))
    return " ".join(words)


def generate_corpus(out_dir: str, n_utterances: int = 600,
                    speakers=DEFAULT_SPEAKERS, languages=DEFAULT_LANGUAGES,
                    sr: int = 24000, seed: int = 0,
                    f0_jitter: float = 0.08, frontend: str = "char") -> dict:
    """Write wavs/ + 4-column metadata.csv (file_id|speaker|lang|text), the
    exact layout cli/preprocess.py consumes. Returns a manifest dict.

    `f0_jitter` is the sigma of a lognormal per-utterance F0 scale (~±16% at
    2 sigma by default): speaker medians stay separated while within-speaker
    spread forces the pitch pathway to carry signal (see synth_utterance);
    0.0 reproduces the round-3 fixed-F0 corpus. Per-utterance scales are
    recorded in the manifest for F0-check layers.

    `frontend`: "char" renders the legacy pseudo-word corpus (deterministic
    char->sound); "en-g2p" samples REAL English text and renders audio from
    the en-g2p tokenizer's IPA phones (synth_utterance_ipa), so the trained
    model's text frontend is the IPA inventory itself."""
    from ..utils.wavio import save_wav

    out = Path(out_dir)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    f0_scales = {}
    if frontend == "en-g2p":
        from ..text.english import phonemize_english
    for i in range(n_utterances):
        spk = speakers[i % len(speakers)]
        lang = languages[(i // len(speakers)) % len(languages)]
        f0_scale = float(np.exp(f0_jitter * rng.standard_normal())) if f0_jitter else 1.0
        if frontend == "en-g2p":
            text = random_english_text(lang, rng)
            wav = synth_utterance_ipa(phonemize_english(text), spk, lang,
                                      sr=sr, seed=seed + i, f0_scale=f0_scale)
        else:
            text = random_text(lang, rng)
            wav = synth_utterance(text, spk, lang, sr=sr, seed=seed + i,
                                  f0_scale=f0_scale)
        fid = f"utt{i:05d}"
        save_wav(str(out / "wavs" / f"{fid}.wav"), wav, sr)
        rows.append(f"{fid}|{spk.name}|{lang.name}|{text}")
        f0_scales[fid] = round(f0_scale, 5)
    (out / "metadata.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    manifest = {
        "n_utterances": n_utterances,
        "sample_rate": sr,
        "speakers": {s.name: {"f0_base": s.f0_base, "formant_scale": s.formant_scale}
                     for s in speakers},
        "languages": [l.name for l in languages],
        "seed": seed,
        "f0_jitter": f0_jitter,
        "frontend": frontend,
        "f0_scales": f0_scales,
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate a formant-synthesis speech-like corpus")
    p.add_argument("out_dir")
    p.add_argument("--n-utterances", type=int, default=600)
    p.add_argument("--sample-rate", type=int, default=24000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f0-jitter", type=float, default=0.08,
                   help="sigma of the lognormal per-utterance F0 scale "
                        "(0 = fixed per-speaker F0, the round-3 corpus)")
    p.add_argument("--frontend", default="char", choices=("char", "en-g2p"),
                   help="char = legacy pseudo-words; en-g2p = real English "
                        "text rendered from the G2P's IPA phones")
    args = p.parse_args(argv)
    m = generate_corpus(args.out_dir, args.n_utterances, sr=args.sample_rate,
                        seed=args.seed, f0_jitter=args.f0_jitter,
                        frontend=args.frontend)
    print(json.dumps(m))


if __name__ == "__main__":
    main()
