from .exporter import ExportedOptiSpeech, ExportedStreamingSynthesiser, export_model

__all__ = ["export_model", "ExportedOptiSpeech", "ExportedStreamingSynthesiser"]
