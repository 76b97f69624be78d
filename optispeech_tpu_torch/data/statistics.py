"""Dataset statistics (the port's own copy of
`optispeech_tpu/data/statistics.py`).

Streams the un-normalised train set, accumulating pitch/energy
min/max/mean/std (sum-of-squares form over each item's valid frames) and the
mel mean/std; emits the `data.statistics` block that training normalises by.
"""

import json
from pathlib import Path

import numpy as np

from ..utils.pylogger import get_pylogger

log = get_pylogger(__name__)


def calculate_data_statistics(loader) -> dict:
    total_pitch_sq = total_pitch = n_pitch = 0.0
    total_energy_sq = total_energy = n_energy = 0.0
    total_mel_sq = total_mel = n_mel = 0.0
    pitch_min, pitch_max = np.inf, -np.inf
    energy_min, energy_max = np.inf, -np.inf

    for batch in loader:
        for i in range(batch["mel"].shape[0]):
            ml = int(batch["mel_lengths"][i])
            mel = batch["mel"][i, :, :ml]
            pitch = batch["pitches"][i, :ml]
            energy = batch["energies"][i, :ml]
            pitch_min = min(pitch_min, float(pitch.min()))
            pitch_max = max(pitch_max, float(pitch.max()))
            energy_min = min(energy_min, float(energy.min()))
            energy_max = max(energy_max, float(energy.max()))
            total_pitch += float(pitch.sum()); total_pitch_sq += float((pitch**2).sum()); n_pitch += pitch.size
            total_energy += float(energy.sum()); total_energy_sq += float((energy**2).sum()); n_energy += energy.size
            total_mel += float(mel.sum()); total_mel_sq += float((mel**2).sum()); n_mel += mel.size

    def mean_std(total, total_sq, n):
        mean = total / n
        return mean, float(np.sqrt(max(total_sq / n - mean**2, 1e-12)))

    pitch_mean, pitch_std = mean_std(total_pitch, total_pitch_sq, n_pitch)
    energy_mean, energy_std = mean_std(total_energy, total_energy_sq, n_energy)
    mel_mean, mel_std = mean_std(total_mel, total_mel_sq, n_mel)
    return dict(
        pitch_min=round(pitch_min, 6), pitch_max=round(pitch_max, 6),
        pitch_mean=round(pitch_mean, 6), pitch_std=round(pitch_std, 6),
        energy_min=round(energy_min, 6), energy_max=round(energy_max, 6),
        energy_mean=round(energy_mean, 6), energy_std=round(energy_std, 6),
        mel_mean=round(mel_mean, 6), mel_std=round(mel_std, 6),
    )


def write_stats(stats: dict, output_file: str):
    Path(output_file).write_text(json.dumps(stats, indent=2))
    log.info(f"Wrote {output_file}:\n{json.dumps(stats, indent=2)}")
