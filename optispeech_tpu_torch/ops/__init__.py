"""Primitive sequence ops and the fused ConvNeXt-block kernel (layer L0)."""

from .duration import expand_by_duration, gaussian_upsample
from .fused_convnext import convnext_block_fused, convnext_block_reference
from .masking import sequence_mask

__all__ = [
    "sequence_mask",
    "expand_by_duration",
    "gaussian_upsample",
    "convnext_block_fused",
    "convnext_block_reference",
]
