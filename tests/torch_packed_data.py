"""Datafiles for the packed data path's tests (tests/test_torch_packed.py,
test_torch_device_cache.py, test_torch_average.py): one .json and one .npz
per utterance, as preprocessing writes them, and a filelist, all from a
numpy seed. Nothing here builds or loads a native library."""

import json

import numpy as np

N_FEATS = 20
HOP = 64


def write_datafiles(root, seed=0, n=12, n_feats=N_FEATS, hop=HOP, text_range=(5, 20),
                    mel_range=(30, 90), speakers=False, name="train"):
    """Write `n` utterances under root/<name>/ and root/<name>.txt; returns
    the filelist's path. Pitch straddles the uv threshold (22 Hz at f_min
    80), the waveform exceeds [-1, 1] now and then, and with `speakers`
    each item carries a speaker and a language id."""
    rng = np.random.default_rng(seed)
    data_dir = root / name
    data_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        t_text = int(rng.integers(*text_range))
        t_mel = int(rng.integers(*mel_range))
        base = data_dir / f"utt{i}"
        meta = {"phoneme_ids": rng.integers(1, 100, t_text).tolist(), "text": f"utterance {i}"}
        if speakers:
            meta.update(sid=int(rng.integers(0, 3)), lid=int(rng.integers(0, 2)))
        base.with_suffix(".json").write_text(json.dumps(meta))
        pitch = np.abs(rng.normal(size=t_mel) * 60 + 180).astype(np.float32)
        pitch[rng.random(t_mel) < 0.2] = rng.uniform(0, 30)
        np.savez(base.with_suffix(".npz"),
                 wav=(rng.normal(size=t_mel * hop - int(rng.integers(0, hop))) * 0.5
                      ).astype(np.float32),
                 mel=rng.normal(size=(n_feats, t_mel)).astype(np.float32) * 2 - 5,
                 energy=np.abs(rng.normal(size=t_mel)).astype(np.float32) * 20,
                 pitch=pitch)
        paths.append(str(base))
    filelist = root / f"{name}.txt"
    filelist.write_text("\n".join(paths) + "\n")
    return filelist


def statistics(cls):
    """Dataset statistics away from the defaults, as `cls` (either package's
    DataStatistics)."""
    return cls(mel_mean=-1.2, mel_std=2.1, energy_mean=18.0, energy_std=6.0,
               pitch_mean=180.0, pitch_std=55.0)
