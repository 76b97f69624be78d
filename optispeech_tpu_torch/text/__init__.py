"""Text frontend (L1): TextProcessor facade over the tokenizer registry.

Role of reference optispeech/text/__init__.py: language validation with a
default, tokenizer resolution by registry name or an explicit class, and an
asdict/from_dict round-trip so exported artifacts can rebuild the frontend
from metadata alone (used by export/exporter.py, mirroring the reference's
ONNX-metadata capability).
"""

from typing import Any

from .normalization import UNICODE_NORM_FORM  # noqa: F401  (public re-export)
from .tokenizers import BaseTokenizer
from . import arabic  # noqa: F401  (registers the `arabic-buck` tokenizer)


class TextProcessor:
    def __init__(self, tokenizer, add_blank: bool, add_bos_eos: bool,
                 normalize_text: bool, languages):
        self.add_blank = add_blank
        self.add_bos_eos = add_bos_eos
        self.normalize_text = normalize_text
        self.languages = [l.strip().lower() for l in languages]
        self.num_languages = len(self.languages)
        self.is_multi_language = self.num_languages > 1
        self.default_language = self.languages[0]

        cls = BaseTokenizer.get_tokenizer_by_name(tokenizer) if isinstance(tokenizer, str) else tokenizer
        self.tokenizer = cls(add_blank=add_blank, add_bos_eos=add_bos_eos,
                             normalize_text=normalize_text)

    def __call__(self, text, lang=None, split_sentences: bool = False):
        """Tokenize `text` -> (ids | per-sentence id lists, normalized text)."""
        lang = self.default_language if lang is None else lang.strip().lower()
        if lang not in self.languages:
            raise ValueError(
                f"Language {lang} does not exist in the supported language list."
            )
        return self.tokenizer(text, language=lang, split_sentences=split_sentences)

    # -- (de)serialization -------------------------------------------------
    def asdict(self) -> dict:
        return {
            "tokenizer": self.tokenizer.name,
            "add_blank": self.add_blank,
            "add_bos_eos": self.add_bos_eos,
            "normalize_text": self.normalize_text,
            "languages": self.languages,
        }

    @classmethod
    def from_dict(cls, kwargs: dict) -> "TextProcessor":
        return cls(**kwargs)

    @classmethod
    def from_config(cls, cfg) -> "TextProcessor":
        """Build from a TextProcessorConfig dataclass."""
        return cls(tokenizer=cfg.tokenizer, add_blank=cfg.add_blank,
                   add_bos_eos=cfg.add_bos_eos, normalize_text=cfg.normalize_text,
                   languages=list(cfg.languages))
