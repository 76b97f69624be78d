"""Offline dataset preprocessing on the host (the port's own copy of
`optispeech_tpu/data/preprocess.py`).

metadata.csv (2/3/4 columns: file_id|[speaker]|[lang]|text) -> per-utterance
`.json` + `.npz` datafiles, train/val filelists, speaker/language id maps
sorted by frequency: the JAX package's and the reference OptiSpeech's
format, so a dataset preprocessed by any of them reads in the others.

Workers are spawned, not forked: a caller that has initialised CUDA (a
trainer, chip_smoke.py) can preprocess without its workers inheriting that
state. The utterances' outputs do not depend on the number of workers.
"""

import json
import multiprocessing
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import FeatureConfig
from ..text import TextProcessor
from ..utils.pylogger import get_pylogger
from ..utils.wavio import load_wav
from . import dsp

log = get_pylogger(__name__)


@dataclass
class FeatureExtractor:
    """Per-utterance DSP (reference FeatureExtractor, numpy backend)."""

    features: FeatureConfig
    loudness_norm_target_db: Optional[float] = -24.0
    preemphasis_filter_coef: Optional[float] = None
    # band-limit biquads (reference feature_extractors/__init__.py:88-95:
    # torchaudio lowpass_biquad/highpass_biquad, applied after preemphasis)
    lowpass_freq: Optional[float] = None
    highpass_freq: Optional[float] = None
    trim_silence: bool = False
    trim_silence_args: Optional[dict] = None
    # registry name ("ensemble"/"autocorr"/"yin", data/pitch.py) or an extractor
    # object; default mirrors the reference's EnsemblePitchExtractor default
    pitch_extractor: Optional[object] = "ensemble"

    def __post_init__(self):
        if self.pitch_extractor is None:
            self.pitch_extractor = "ensemble"
        if isinstance(self.pitch_extractor, str):
            from .pitch import make_pitch_extractor

            self.pitch_extractor = make_pitch_extractor(self.pitch_extractor, self.features)

    def __call__(self, audio_path: str):
        f = self.features
        wav, _ = load_wav(audio_path, sr=f.sample_rate, mono=True)
        if self.trim_silence:
            args = dict(self.trim_silence_args or {})
            if args.pop("method", "spectral") == "spectral":
                from .vad import trim_silence_spectral

                args.pop("threshold_db", None)
                chunk = args.pop("chunk", 480)
                wav = trim_silence_spectral(wav, f.sample_rate,
                                            samples_per_chunk=chunk, **args)
            else:
                args.pop("threshold", None)
                wav = dsp.trim_silence_energy(wav, f.sample_rate, **args)
        if self.preemphasis_filter_coef is not None:
            wav = np.append(wav[0], wav[1:] - self.preemphasis_filter_coef * wav[:-1]).astype(np.float32)
        if self.lowpass_freq is not None:
            wav = dsp.lowpass_biquad(wav, f.sample_rate, self.lowpass_freq)
        if self.highpass_freq is not None:
            wav = dsp.highpass_biquad(wav, f.sample_rate, self.highpass_freq)
        if self.loudness_norm_target_db is not None:
            wav = dsp.normalize_loudness(wav, f.sample_rate, self.loudness_norm_target_db)
        wav = dsp.peak_normalize(wav)
        mel = self.get_mel(wav)
        mel_length = mel.shape[-1]
        energy = dsp.trim_or_pad_to(
            dsp.frame_energy_np(wav, f.n_fft, f.hop_length, f.win_length, f.center), mel_length
        )
        pitch = self.pitch_extractor(wav, mel_length)
        return wav.squeeze(), mel.squeeze(), energy.squeeze(), pitch.squeeze()

    def get_mel(self, wav: np.ndarray) -> np.ndarray:
        f = self.features
        return dsp.log_mel_spectrogram_np(
            wav, f.sample_rate, f.n_fft, f.hop_length, f.win_length,
            f.n_feats, f.f_min, f.f_max, f.center,
        )


def do_preprocess_utterance(feature_extractor, text_processor, audio_filepath, text, lang):
    """(reference text_wav_datamodule.py:24-43)."""
    if text_processor.is_multi_language:
        assert lang is not None, "Language not provided for multi-language model"
    lang = lang if text_processor.is_multi_language else None
    phoneme_ids, text = text_processor(text, lang=lang)
    wav, mel, energy, pitch = feature_extractor(audio_filepath)
    return dict(phoneme_ids=phoneme_ids, text=text, wav=wav, mel=mel, energy=energy, pitch=pitch)


def parse_metadata(path: Path):
    """metadata.csv rows: file_id|[speaker]|[lang]|text (reference README.md:120-124)."""
    rows = []
    for line in path.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        parts = line.split("|")
        if len(parts) == 2:
            rows.append(dict(file_id=parts[0], speaker=None, lang=None, text=parts[1]))
        elif len(parts) == 3:
            rows.append(dict(file_id=parts[0], speaker=parts[1], lang=None, text=parts[2]))
        elif len(parts) == 4:
            rows.append(dict(file_id=parts[0], speaker=parts[1], lang=parts[2], text=parts[3]))
        else:
            raise ValueError(f"Invalid metadata row: {line}")
    return rows


def get_sids_and_lids(rows):
    """Frequency-sorted speaker/language id maps (reference
    tools/preprocess_dataset.py:81-101)."""
    speakers = Counter(r["speaker"] for r in rows if r["speaker"])
    langs = Counter(r["lang"] for r in rows if r["lang"])
    sid_map = {s: i for i, (s, _) in enumerate(speakers.most_common())}
    lid_map = {l: i for i, (l, _) in enumerate(langs.most_common())}
    return sid_map, lid_map


def _process_row(row, wavs_dir, out_data_dir, feature_extractor, text_processor, sid_map, lid_map):
    file_id = row["file_id"]
    audio_path = Path(wavs_dir) / f"{file_id}.wav"
    if not audio_path.exists():
        log.warning(f"missing audio file {audio_path}; skipping")
        return None
    data = do_preprocess_utterance(
        feature_extractor, text_processor, str(audio_path), row["text"], row["lang"]
    )
    out_json = {
        "phoneme_ids": data["phoneme_ids"],
        "text": data["text"],
    }
    if row["speaker"] is not None:
        out_json["sid"] = sid_map[row["speaker"]]
    if row["lang"] is not None:
        out_json["lid"] = lid_map[row["lang"]]
    out_base = Path(out_data_dir) / file_id
    with open(out_base.with_suffix(".json"), "w", encoding="utf-8") as f:
        json.dump(out_json, f, ensure_ascii=False)
    np.savez(
        out_base.with_suffix(".npz"),
        wav=data["wav"].astype(np.float32),
        mel=data["mel"].astype(np.float32),
        energy=data["energy"].astype(np.float32),
        pitch=data["pitch"].astype(np.float32),
    )
    return str(out_base)


def preprocess_dataset(
    dataset_dir: str,
    output_dir: str,
    text_processor: TextProcessor,
    feature_extractor: FeatureExtractor,
    val_fraction: float = 0.02,
    num_workers: int = 1,
):
    """Full dataset pass -> output_dir/{data/*.json,*.npz, train.txt, val.txt,
    speaker_ids.json, language_ids.json}."""
    dataset_dir = Path(dataset_dir)
    output_dir = Path(output_dir)
    data_dir = output_dir / "data"
    data_dir.mkdir(parents=True, exist_ok=True)

    metadata = dataset_dir / "metadata.csv"
    rows = parse_metadata(metadata)
    sid_map, lid_map = get_sids_and_lids(rows)
    wavs_dir = dataset_dir / "wavs" if (dataset_dir / "wavs").exists() else dataset_dir

    # eSpeak has process-global language state: multi-language runs must be
    # single-worker (reference tools/preprocess_dataset.py:186-187). Stateless
    # tokenizers (char/raw-ipa/arabic) parallelise fine.
    if text_processor.is_multi_language and getattr(
        text_processor.tokenizer, "name", ""
    ) == "ipa":
        num_workers = 1

    outputs = []
    if num_workers > 1:
        spawn = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(num_workers, mp_context=spawn) as ex:
            futures = [
                ex.submit(_process_row, r, wavs_dir, data_dir, feature_extractor,
                          text_processor, sid_map, lid_map)
                for r in rows
            ]
            outputs = [f.result() for f in futures]
    else:
        outputs = [
            _process_row(r, wavs_dir, data_dir, feature_extractor, text_processor, sid_map, lid_map)
            for r in rows
        ]
    outputs = [o for o in outputs if o]

    n_val = max(int(len(outputs) * val_fraction), 1)
    val, train = outputs[:n_val], outputs[n_val:]
    (output_dir / "train.txt").write_text("\n".join(train) + "\n", encoding="utf-8")
    (output_dir / "val.txt").write_text("\n".join(val) + "\n", encoding="utf-8")
    if sid_map:
        (output_dir / "speaker_ids.json").write_text(json.dumps(sid_map, ensure_ascii=False))
    if lid_map:
        (output_dir / "language_ids.json").write_text(json.dumps(lid_map, ensure_ascii=False))
    log.info(f"Preprocessed {len(outputs)} utterances -> {output_dir}")
    return train, val
