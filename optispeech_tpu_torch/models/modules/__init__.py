from .convnext import ConvNeXtBackbone, ConvNeXtBlock
from .core import (
    ConvSeparable,
    DurationPredictor,
    EnergyPredictor,
    PitchPredictor,
    ScaledSinusoidalEmbedding,
    TextEmbedding,
    VariancePredictor,
)

__all__ = [
    "ConvNeXtBackbone",
    "ConvNeXtBlock",
    "ConvSeparable",
    "TextEmbedding",
    "VariancePredictor",
    "DurationPredictor",
    "PitchPredictor",
    "EnergyPredictor",
    "ScaledSinusoidalEmbedding",
]
