"""Typed configuration tree (the reference's Hydra capability, L7).

The port's own copy of the JAX package's `config.py`: the same frozen
dataclasses, field for field, so a config dict written by either package
builds in the other. No YAML loader here; build configs in code or with
`from_dict`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Feature extraction (reference configs/data/feature_extractor/default.yaml)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FeatureConfig:
    sample_rate: int = 24000
    n_feats: int = 100
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    f_min: float = 80.0
    f_max: float = 8000.0
    center: bool = True


# (reference configs/data/ljspeech.yaml data_statistics block)
@dataclass(frozen=True)
class DataStatistics:
    pitch_min: float = 67.836174
    pitch_max: float = 792.962036
    pitch_mean: float = 211.046158
    pitch_std: float = 53.012085
    energy_min: float = 0.023226
    energy_max: float = 241.037918
    energy_mean: float = 21.821531
    energy_std: float = 18.17124
    mel_mean: float = -5.536622
    mel_std: float = 2.116101


# ---------------------------------------------------------------------------
# Model components
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BackboneConfig:
    """One struct covering every interchangeable backbone; each kind reads the
    fields it needs (reference configs/model/generator/encoder/*.yaml)."""

    kind: str = "convnext"
    # convnext
    intermediate_dim: int = 1024
    num_layers: int = 4
    drop_path: float = 0.2
    layer_scale_init_value: Optional[float] = None
    # inference-only fused blocks (convnext kind, decoder only): the CUDA
    # kernel of ops/fused_convnext.py on the card, its plain twin on the CPU
    fused_pallas: bool = False
    # lightspeech
    kernel_sizes: Tuple[int, ...] = (5, 25, 13, 9)
    activation: str = "relu"
    dropout: float = 0.2
    # transformer / conformer
    attention_heads: int = 2
    linear_units: int = 1024
    num_blocks: int = 4
    attention_dropout_rate: float = 0.2
    positional_dropout_rate: float = 0.2
    cnn_module_kernel: int = 7
    # conformer conv-module norm: "layernorm" (training default) or "affine"
    # (frozen-BatchNorm import path, see compat.torch_import)
    conv_norm: str = "layernorm"
    # leanspeech
    kernel_size: int = 9


@dataclass(frozen=True)
class TextEmbeddingConfig:
    n_vocab: int = 250
    dropout: float = 0.1
    padding_idx: int = 0
    max_source_positions: int = 2000


@dataclass(frozen=True)
class VariancePredictorConfig:
    num_layers: int = 2
    intermediate_dim: int = 384
    kernel_size: int = 3
    dropout: float = 0.1
    separable: bool = False  # "lite" variants use ConvSeparable
    embed_kernel_size: int = 9
    embed_dropout: float = 0.2


@dataclass(frozen=True)
class VocoderConfig:
    dim: int = 384
    intermediate_dim: int = 1152
    num_layers: int = 8
    drop_path: float = 0.1
    # inference-only fused trunk blocks (ops/fused_convnext.py)
    fused_pallas: bool = False
    # Condition the vocoder directly on frame-level pitch (normalized domain):
    # teacher-forced GT frames in training, duration-expanded predictor output
    # (x p_factor) at inference. The reference already PASSES f0 to every
    # vocoder (generator/__init__.py:161) — WaveNeXt ignores it there, only the
    # unfinished streaming_hifigan consumed it — but with the reference's
    # detached-vocoder training the pitch EMBEDDING pathway (modules/core.py:
    # 136-178) is unlearnable by the renderer: measured across three campaigns
    # (docs/evidence/campaign_r3, _r4, _r4b) rendered F0 never follows
    # p_factor. Direct conditioning closes the d/p/e control contract.
    f0_cond: bool = False


@dataclass(frozen=True)
class LossCoeffs:
    lambda_align: float = 5.0
    lambda_duration: float = 1.0
    lambda_pitch: float = 1.0
    lambda_energy: float = 1.0


@dataclass(frozen=True)
class GeneratorConfig:
    dim: int = 256
    segment_size: int = 64
    text_embedding: TextEmbeddingConfig = field(default_factory=TextEmbeddingConfig)
    encoder: BackboneConfig = field(default_factory=BackboneConfig)
    decoder: BackboneConfig = field(default_factory=BackboneConfig)
    duration_predictor: VariancePredictorConfig = field(
        default_factory=lambda: VariancePredictorConfig(num_layers=2, intermediate_dim=384, kernel_size=3, dropout=0.1)
    )
    pitch_predictor: VariancePredictorConfig = field(
        default_factory=lambda: VariancePredictorConfig(
            num_layers=5, intermediate_dim=256, kernel_size=5, dropout=0.5, embed_dropout=0.2
        )
    )
    energy_predictor: VariancePredictorConfig = field(
        default_factory=lambda: VariancePredictorConfig(
            num_layers=2, intermediate_dim=384, kernel_size=3, dropout=0.5, embed_dropout=0.5
        )
    )
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    loss_coeffs: LossCoeffs = field(default_factory=LossCoeffs)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    num_speakers: int = 1
    num_languages: int = 1
    # Reference behavior (generator/__init__.py:161): the vocoder trains on
    # STOP-GRADIENT decoder output, so mel/adversarial losses never reach the
    # acoustic model. The r4b root-cause analysis (docs/evidence/campaign_r4b)
    # argues this detach is why the hidden-stream pitch pathway stays
    # unlearnable by the renderer. False = config-flagged DEVIATION from the
    # reference: the waveform losses backpropagate through decoder, variance
    # predictors, and encoder.
    detach_vocoder_input: bool = True


@dataclass(frozen=True)
class DiscriminatorLossCoeffs:
    lambda_mrd: float = 1.0
    lambda_mel: float = 45.0
    lambda_mr_stft: float = 2.5


@dataclass(frozen=True)
class DiscriminatorConfig:
    kind: str = "vocos"
    loss_coeffs: DiscriminatorLossCoeffs = field(default_factory=DiscriminatorLossCoeffs)
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    resolutions: Tuple[Tuple[int, int, int], ...] = (
        (1024, 256, 1024), (2048, 512, 2048), (512, 128, 512),
    )
    mrd_channels: int = 64


# ---------------------------------------------------------------------------
# Training / inference / data
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW (reference configs/model/optimizer/adamw.yaml)."""

    lr: float = 2e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    weight_decay: float = 1e-2
    eps: float = 1e-8


@dataclass(frozen=True)
class SchedulerConfig:
    """Cosine-with-warmup (reference configs/model/scheduler/cosine_with_warmup.yaml)."""

    kind: str = "cosine_with_warmup"
    num_warmup_steps: int = 1000
    num_training_steps: int = 1_000_000


@dataclass(frozen=True)
class TrainArgs:
    """(reference configs/model/optispeech.yaml train_args)."""

    cache_generator_outputs: bool = True
    gradient_clip_val: float = 10.0
    gradient_accumulate_batches: Optional[int] = None
    pretraining_steps: int = 1000
    evaluate_periodicity: bool = False
    evaluate_utmos: bool = False
    evaluate_pesq: bool = False
    evaluate_mcd: bool = False
    # self-contained numpy STOI (training/metrics.py) — always available,
    # unlike the import-gated pesq/utmos external deps
    evaluate_stoi: bool = False
    # full-utterance synthesis eval: how many val utterances go through the
    # real inference path per validation (reference on_validation_end runs 2;
    # perceptual metrics here cover up to this many full wavs, not GAN segments)
    val_synth_utterances: int = 8
    # Training activation dtype. f32 is the default BY MEASUREMENT on v5e:
    # XLA's f32 matmuls already take bf16 MXU passes, so explicit bf16
    # activations only add cast overhead (74.6 vs 65.3 ms/step at batch 16,
    # docs/evidence/training_profile.md) while costing GAN numerical margin.
    # bf16 pays off for inference serving (--bf16), not training.
    compute_dtype: str = "float32"
    # wire format for the mel batch on the host->device link ("float32" |
    # "bfloat16"). bf16 halves the dominant per-step transfer term (the step
    # upcasts back to f32 on entry); padding/mask semantics are unchanged.
    # Opt-in: the ~3-decimal-digit mel quantization perturbs alignment
    # affinities at training-noise level. Useful on bandwidth-limited or
    # memory-leaking host links (see trainer._default_rss_limit_kb).
    wire_mel_dtype: str = "float32"


@dataclass(frozen=True)
class InferenceArgs:
    d_factor: float = 1.1
    p_factor: float = 1.6
    e_factor: float = 1.2


@dataclass(frozen=True)
class TextProcessorConfig:
    """(reference configs/data/text_processor/default.yaml)."""

    tokenizer: str = "ipa"
    add_blank: bool = False
    add_bos_eos: bool = False
    normalize_text: bool = True
    languages: Tuple[str, ...] = ("en-us",)


@dataclass(frozen=True)
class PreprocessConfig:
    """Offline feature-extraction knobs
    (reference configs/data/feature_extractor/default.yaml:15-24)."""

    preemphasis_filter_coef: Optional[float] = None
    # band-limit biquads applied after preemphasis (reference
    # feature_extractors/__init__.py:88-95, default.yaml:17-18)
    lowpass_freq: Optional[float] = None
    highpass_freq: Optional[float] = None
    loudness_norm_target_db: Optional[float] = -24.0
    # pitch tracker registry name (data/pitch.py): ensemble | autocorr | yin
    pitch_extractor: str = "ensemble"
    trim_silence: bool = False
    # "spectral" = VAD-style chunk speech probabilities (data/vad.py, the
    # silero role); "energy" = plain RMS gate (data/dsp.py fallback)
    trim_method: str = "spectral"
    trim_silence_threshold: float = 0.2  # spectral VAD probability threshold
    trim_silence_threshold_db: float = -40.0  # energy-gate threshold
    trim_silence_chunk: int = 720
    trim_keep_chunks_before: int = 1
    trim_keep_chunks_after: int = 1


@dataclass(frozen=True)
class DataConfig:
    name: str = "ljspeech"
    num_speakers: int = 1
    train_filelist_path: str = "data/LJSpeech-1.1/train.txt"
    valid_filelist_path: str = "data/LJSpeech-1.1/val.txt"
    batch_size: int = 128
    num_workers: int = 8
    text_processor: TextProcessorConfig = field(default_factory=TextProcessorConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    statistics: DataStatistics = field(default_factory=DataStatistics)
    seed: int = 1234
    # static-shape bucketing (TPU-specific; no reference analogue)
    text_bucket_size: int = 32
    mel_bucket_size: int = 128
    max_text_len: int = 384
    max_mel_len: int = 1024


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level config (reference configs/train.yaml composition)."""

    run_name: str = "dev"
    seed: int = 1234
    model_variant: str = "convnext"
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    train_args: TrainArgs = field(default_factory=TrainArgs)
    inference_args: InferenceArgs = field(default_factory=InferenceArgs)
    data: DataConfig = field(default_factory=DataConfig)
    max_steps: int = 2_000_000
    val_every_n_steps: int = 5000
    ckpt_every_n_steps: int = 10000
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 10
    log_every_n_steps: int = 100
    num_devices: Optional[int] = None  # None = all visible
    # optional wandb sink (reference configs/logger/wandb.yaml); CSV + JSONL
    # (+ TensorBoard when installed) are always on
    wandb_project: Optional[str] = None
    # additional named metric sinks from training/loggers.py's registry
    # (reference configs/logger/*.yaml: tensorboard/wandb/mlflow/neptune/
    # comet/aim); each is import-gated — missing packages warn and skip
    loggers: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# dict <-> dataclass plumbing (for YAML layering and checkpoint metadata)
# ---------------------------------------------------------------------------

def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _build(cls, data):
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"Unknown config key `{key}` for {cls.__name__}")
        f = fields[key]
        ftype = f.type if not isinstance(f.type, str) else None
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = _build(type(default), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def from_dict(cls, data: dict):
    """Build a (nested) frozen config from a plain dict (YAML round-trip)."""
    return _build(cls, data)


def finalize(cfg: "ExperimentConfig") -> "ExperimentConfig":
    """Propagate data-level facts into the generator config, mirroring how the
    reference constructs the generator from data_args
    (model/optispeech.py:48-55): num_speakers, num_languages and the feature
    extractor parameters come from the data block."""
    gen = dataclasses.replace(
        cfg.generator,
        num_speakers=cfg.data.num_speakers,
        num_languages=len(cfg.data.text_processor.languages),
        features=cfg.data.features,
    )
    return dataclasses.replace(cfg, generator=gen)


def merge_overrides(cfg, overrides: dict):
    """Apply dotted-path overrides, e.g. {"generator.dim": 192}."""
    d = to_dict(cfg)
    for path, value in overrides.items():
        node = d
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"Unknown override path `{path}`")
        node[parts[-1]] = value
    return from_dict(type(cfg), d)
