"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

One configuration is built in both packages from the same dict, the JAX
model is initialised from a seed, and its params reach the port through
`state_dict_from_jax_params` as numpy, so both sides hold the same weights.
"""

import dataclasses

import jax
import numpy as np

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


def random_tokens(rng, lengths, bucket=32):
    """(B, bucket) int ids in 3..149 with zero padding past each length."""
    x = np.zeros((len(lengths), bucket), np.int32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(3, 150, n)
    return x, np.asarray(lengths, np.int32)
