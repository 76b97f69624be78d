from .wavenext import WaveNeXt, WaveNeXtHead

__all__ = ["WaveNeXt", "WaveNeXtHead"]
