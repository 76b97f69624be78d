from .conformer import ConformerBackbone
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
from .leanspeech import LeanSpeechBackbone
from .lightspeech import LightSpeechTransformerDecoder, LightSpeechTransformerEncoder
from .transformer import TransformerBackbone

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
    "LightSpeechTransformerEncoder",
    "LightSpeechTransformerDecoder",
    "TransformerBackbone",
    "ConformerBackbone",
    "LeanSpeechBackbone",
]
