"""Model layer: neural modules, generator composition, vocoder, and the
top-level OptiSpeech API."""

from .generator import OptiSpeechGenerator
from .optispeech import OptiSpeech

__all__ = ["OptiSpeechGenerator", "OptiSpeech"]
