"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

One configuration is built in both packages from the same dict, the JAX
model is initialised from a seed, and its params reach the port through
`state_dict_from_jax_params` as numpy, so both sides hold the same weights.
"""

import dataclasses

import jax
import numpy as np
import torch

from optispeech_tpu import config as jax_config
from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
from optispeech_tpu_torch import config as torch_config
from optispeech_tpu_torch.models.optispeech import OptiSpeech as TorchOptiSpeech


def small_config(dim=32, inter=64, voc_dim=48, voc_inter=96, layers=2, n_fft=64, hop=16,
                 num_speakers=1, languages=("en-us",), f0_cond=False, predictors=True,
                 separable=False):
    """A JAX ExperimentConfig at test size (en-g2p text front end). With
    `predictors=False` the variance predictors keep their published shapes;
    `separable` gives them the `light` variants' separable convs."""
    cfg = jax_config.ExperimentConfig()
    g = cfg.generator
    bb = jax_config.BackboneConfig(intermediate_dim=inter, num_layers=layers)
    kw = {}
    if predictors:
        vp = jax_config.VariancePredictorConfig(num_layers=2, intermediate_dim=48, kernel_size=3,
                                                separable=separable)
        kw = dict(duration_predictor=vp, pitch_predictor=vp, energy_predictor=vp)
    g = dataclasses.replace(
        g, dim=dim, encoder=bb, decoder=bb, **kw,
        vocoder=dataclasses.replace(g.vocoder, dim=voc_dim, intermediate_dim=voc_inter,
                                    num_layers=layers, f0_cond=f0_cond),
        features=dataclasses.replace(g.features, n_fft=n_fft, hop_length=hop),
        num_speakers=num_speakers, num_languages=len(languages),
    )
    tp = dataclasses.replace(cfg.data.text_processor, tokenizer="en-g2p", languages=languages)
    data = dataclasses.replace(cfg.data, text_processor=tp, num_speakers=num_speakers)
    return dataclasses.replace(cfg, generator=g, data=data)


def full_width_config(layers=2):
    """The flagship's widths (256/1024 backbones, 384/1152 trunk, n_fft 1024,
    hop 256, published predictors) with depth cut to `layers` per stack."""
    return small_config(dim=256, inter=1024, voc_dim=384, voc_inter=1152, layers=layers,
                        n_fft=1024, hop=256, predictors=False)


def to_torch_config(cfg):
    return torch_config.from_dict(torch_config.ExperimentConfig, jax_config.to_dict(cfg))


def params_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def build_pair(cfg, seed=0):
    """(JAX OptiSpeech, port OptiSpeech on the CPU) holding the same weights."""
    japi = JaxOptiSpeech(cfg, seed=seed)
    tapi = TorchOptiSpeech.load_from_jax_params(to_torch_config(cfg), params_np(japi.params),
                                                device="cpu")
    return japi, tapi


def no_dropout(cfg):
    """`cfg` with every dropout and drop-path rate at 0: JAX and torch draw
    different random bits, so parity runs without them."""
    g = cfg.generator
    vp = lambda v: dataclasses.replace(v, dropout=0.0, embed_dropout=0.0)  # noqa: E731
    g = dataclasses.replace(
        g, text_embedding=dataclasses.replace(g.text_embedding, dropout=0.0),
        encoder=dataclasses.replace(g.encoder, drop_path=0.0),
        decoder=dataclasses.replace(g.decoder, drop_path=0.0),
        vocoder=dataclasses.replace(g.vocoder, drop_path=0.0),
        duration_predictor=vp(g.duration_predictor), pitch_predictor=vp(g.pitch_predictor),
        energy_predictor=vp(g.energy_predictor))
    return dataclasses.replace(cfg, generator=g)


def train_setup(cfg, seed=0, bf16=False):
    """JAX generator and discriminator modules with a TrainState from `seed`,
    and the port's TrainState on the CPU holding the same weights. With
    `bf16` both generators compute in bfloat16 (the discriminators stay
    float32), as `train_args.compute_dtype: bfloat16` builds them."""
    from optispeech_tpu.models.discriminator.vocos import VocosDiscriminator as JaxDisc
    from optispeech_tpu.models.generator import OptiSpeechGenerator as JaxGen
    from optispeech_tpu.training.state import init_train_state
    from optispeech_tpu_torch.compat.from_jax import (
        discriminator_state_dict_from_jax_params,
        state_dict_from_jax_params,
    )
    from optispeech_tpu_torch.models.discriminator import VocosDiscriminator
    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator
    from optispeech_tpu_torch.training.state import TrainState

    jgen = JaxGen(cfg.generator, dtype=jax.numpy.bfloat16 if bf16 else jax.numpy.float32)
    jdisc = JaxDisc(cfg.discriminator, cfg.generator.features)
    jstate = init_train_state(cfg, jgen, jdisc, jax.random.PRNGKey(seed))
    tcfg = to_torch_config(cfg)
    gen = OptiSpeechGenerator(tcfg.generator, dtype=torch.bfloat16 if bf16 else torch.float32)
    gen.load_state_dict(state_dict_from_jax_params(params_np(jstate.g_params), tcfg.generator))
    disc = VocosDiscriminator(tcfg.discriminator, tcfg.generator.features)
    disc.load_state_dict(discriminator_state_dict_from_jax_params(params_np(jstate.d_params),
                                                                  tcfg.discriminator))
    return jgen, jdisc, jstate, TrainState(tcfg, gen, disc, torch.Generator().manual_seed(seed))


def train_batch(rng, cfg, b=4, host_seg=True):
    """A numpy training batch at the config's buckets, with segment starts
    sampled on the host and the matching ground-truth crop (`wav_seg`), as
    the JAX trainer ships them, or with the full `wav`."""
    from optispeech_tpu.ops.segments import host_sample_segment_starts, host_slice_wav_segments

    t_text, t_mel = cfg.data.text_bucket_size, cfg.data.mel_bucket_size
    feats = cfg.generator.features
    seg = min(cfg.generator.segment_size, t_mel)
    mel_lengths = rng.integers(t_mel // 2, t_mel + 1, b).astype(np.int32)
    x_lengths = rng.integers(t_text // 2, t_text + 1, b).astype(np.int32)
    x = rng.integers(1, 100, (b, t_text)).astype(np.int32)
    x[np.arange(t_text)[None, :] >= x_lengths[:, None]] = 0
    batch = dict(
        x=x, x_lengths=x_lengths,
        mel=rng.normal(size=(b, feats.n_feats, t_mel)).astype(np.float32),
        mel_lengths=mel_lengths,
        pitches=rng.normal(size=(b, t_mel)).astype(np.float32),
        energies=rng.normal(size=(b, t_mel)).astype(np.float32),
    )
    wav = (rng.normal(size=(b, t_mel * feats.hop_length)) * 0.1).astype(np.float32)
    if not host_seg:
        return {**batch, "wav": wav}
    starts = host_sample_segment_starts(rng, mel_lengths, seg)
    return {**batch, "start_idx": starts,
            "wav_seg": host_slice_wav_segments(wav, starts, seg, feats.hop_length)}


def random_tokens(rng, lengths, bucket=32):
    """(B, bucket) int ids in 3..149 with zero padding past each length."""
    x = np.zeros((len(lengths), bucket), np.int32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(3, 150, n)
    return x, np.asarray(lengths, np.int32)
