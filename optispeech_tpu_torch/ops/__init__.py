"""Primitive sequence and DSP ops and the kernels' wrappers (layer L0)."""

from .audio import dynamic_range_compression, safe_log
from .ctc import forward_sum_loss
from .duration import (
    average_by_duration,
    duration_to_frame_index,
    expand_by_duration,
    gaussian_upsample,
)
from .fused_convnext import (
    convnext_block_fused,
    convnext_block_fused_int8,
    convnext_block_int8_reference,
    convnext_block_reference,
)
from .masking import make_non_pad_mask, make_pad_mask, sequence_mask
from .mas import (
    viterbi_decode,
    viterbi_decode_extract,
    viterbi_decode_extract_reference,
    viterbi_decode_reference,
)
from .prior import beta_binomial_log_prior
from .segments import get_random_segments, get_segments
from .stft import log_mel_spectrogram, mel_filterbank, stft_magnitude

__all__ = [
    "sequence_mask",
    "make_pad_mask",
    "make_non_pad_mask",
    "expand_by_duration",
    "gaussian_upsample",
    "average_by_duration",
    "duration_to_frame_index",
    "get_segments",
    "get_random_segments",
    "beta_binomial_log_prior",
    "forward_sum_loss",
    "safe_log",
    "dynamic_range_compression",
    "stft_magnitude",
    "mel_filterbank",
    "log_mel_spectrogram",
    "viterbi_decode",
    "viterbi_decode_reference",
    "viterbi_decode_extract",
    "viterbi_decode_extract_reference",
    "convnext_block_fused",
    "convnext_block_reference",
    "convnext_block_fused_int8",
    "convnext_block_int8_reference",
]
