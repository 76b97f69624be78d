"""Tokenizer registry + IPA tokenizer.

Capability parity with the reference optispeech/text/tokenizers.py: subclass
auto-registry, IPA path (NFKC preprocess -> espeak phonemization -> symbol
ids, optional blank interspersal and BOS/EOS, per-sentence or flattened).

The espeak binding (piper_phonemize, a C++ dependency) is host-side and
optional: when absent, `IPATokenizer` raises the same actionable error as the
reference, and two fallbacks are available — `RawIPATokenizer` for
pre-phonemized text and `CharacterTokenizer` for smoke tests.
"""

from abc import ABC, abstractmethod

from . import symbols
from .normalization import collapse_whitespace, intersperse, preprocess_text

_TOKENIZERS: dict = {}


class BaseTokenizer(ABC):
    name: str
    input_symbols: dict
    special_symbols: dict

    def __init_subclass__(cls, /, **kwargs):
        super().__init_subclass__(**kwargs)
        _TOKENIZERS.setdefault(cls.name, cls)

    @classmethod
    def get_tokenizer_by_name(cls, name):
        try:
            return _TOKENIZERS[name]
        except KeyError:
            raise ValueError(f"Tokenizer `{name}` does not exist.")

    def __init__(self, add_blank: bool, add_bos_eos: bool, normalize_text: bool):
        self.add_blank = add_blank
        self.add_bos_eos = add_bos_eos
        self.normalize_text = normalize_text

    @abstractmethod
    def __call__(self, text: str, language: str, *, split_sentences: bool = True):
        """Return (input ids | list of per-sentence id lists, normalized text)."""

    def preprocess_text(self, text: str, language: str = None) -> str:
        return preprocess_text(text, language, normalize=self.normalize_text)

    def _encode_sentences(self, sentences: list[list[str]], split_sentences: bool):
        """Shared phoneme-list -> id-list path (reference tokenizers.py:54-80)."""
        if not split_sentences:
            flat = [ph for sent in sentences for ph in sent]
            phonemes = list(collapse_whitespace("".join(flat)))
            ids = symbols.phonemes_to_ids(phonemes)
            if self.add_blank:
                ids = intersperse(ids, 0)
            if self.add_bos_eos:
                ids = [symbols.BOS_ID, *ids, symbols.EOS_ID]
            return ids
        out = []
        for sent in sentences:
            phonemes = list(collapse_whitespace("".join(sent)))
            ids = symbols.phonemes_to_ids(phonemes)
            if self.add_blank:
                ids = intersperse(ids, 0)
            if self.add_bos_eos:
                ids = [symbols.BOS_ID, *ids, symbols.EOS_ID]
            out.append(ids)
        return out


class IPATokenizer(BaseTokenizer):
    name = "ipa"
    input_symbols = symbols.SYMBOL_TO_ID
    special_symbols = dict(pad=symbols.PAD, bos=symbols.BOS, eos=symbols.EOS)

    def __call__(self, text: str, language: str, *, split_sentences: bool = True):
        phoneme_sentences, normalized_text = self.phonemize_text(text, language)
        return self._encode_sentences(phoneme_sentences, split_sentences), normalized_text

    def phonemize_text(self, text: str, language: str):
        try:
            from piper_phonemize import phonemize_espeak
        except ImportError:
            raise ImportError(
                "piper-phonemize package is needed for the IPA tokenizer.\n"
                "pip install piper-phonemize\n"
                "or build it yourself from the following repository:\n"
                "https://github.com/rhasspy/piper-phonemize\n"
                "For pre-phonemized input use tokenizer `raw-ipa`; for smoke "
                "tests use `char`."
            )
        text = self.preprocess_text(text, language)
        return phonemize_espeak(text, language), text


class RawIPATokenizer(BaseTokenizer):
    """Input text is already IPA; sentences split on `.`-like boundaries."""

    name = "raw-ipa"
    input_symbols = symbols.SYMBOL_TO_ID
    special_symbols = dict(pad=symbols.PAD, bos=symbols.BOS, eos=symbols.EOS)

    def __call__(self, text: str, language: str, *, split_sentences: bool = True):
        text = self.preprocess_text(text, language)
        known = [ch for ch in text if ch in symbols.SYMBOL_TO_ID]
        sentences = [known]
        return self._encode_sentences(sentences, split_sentences), text


class EnglishG2PTokenizer(BaseTokenizer):
    """Self-contained English G2P (text/english.py): exception lexicon +
    NRL-style letter-to-sound rules, emitting the same IPA inventory as the
    espeak path — the role of reference tokenizers.py:84-98 without the
    piper_phonemize C++ binding. American English only; `language` is
    accepted for interface symmetry."""

    name = "en-g2p"
    input_symbols = symbols.SYMBOL_TO_ID
    special_symbols = dict(pad=symbols.PAD, bos=symbols.BOS, eos=symbols.EOS)

    _SENT_RE = __import__("re").compile(r"[^.!?]+[.!?]*")

    def __call__(self, text: str, language: str = "en-us", *, split_sentences: bool = True):
        from .english import phonemize_english

        text = self.preprocess_text(text, language)
        if split_sentences:
            parts = [m.group(0).strip() for m in self._SENT_RE.finditer(text)]
            parts = [p for p in parts if p] or [text]
        else:
            parts = [text]
        sentences = [[phonemize_english(p)] for p in parts]
        return self._encode_sentences(sentences, split_sentences), text


class GermanG2PTokenizer(BaseTokenizer):
    """Self-contained German G2P (text/german.py): exception lexicon +
    context-sensitive letter-to-sound rules emitting the shared IPA
    inventory — the second instance of the self-contained-G2P pattern that
    replaces the reference's espeak multi-language path
    (tokenizers.py:84-98) in this binding-free image."""

    name = "de-g2p"
    input_symbols = symbols.SYMBOL_TO_ID
    special_symbols = dict(pad=symbols.PAD, bos=symbols.BOS, eos=symbols.EOS)

    _SENT_RE = __import__("re").compile(r"[^.!?]+[.!?]*")

    def __call__(self, text: str, language: str = "de", *, split_sentences: bool = True):
        from .german import phonemize_german

        text = self.preprocess_text(text, language)
        if split_sentences:
            parts = [m.group(0).strip() for m in self._SENT_RE.finditer(text)]
            parts = [p for p in parts if p] or [text]
        else:
            parts = [text]
        sentences = [[phonemize_german(p)] for p in parts]
        return self._encode_sentences(sentences, split_sentences), text


class CharacterTokenizer(BaseTokenizer):
    """Grapheme fallback: lowercased characters restricted to the symbol set.
    No reference analogue; exists so the full pipeline runs without espeak.
    Sentence splitting uses terminal punctuation (espeak does this inside
    phonemize_espeak for the IPA path)."""

    name = "char"
    input_symbols = symbols.SYMBOL_TO_ID
    special_symbols = dict(pad=symbols.PAD, bos=symbols.BOS, eos=symbols.EOS)

    _SENT_RE = __import__("re").compile(r"[^.!?]+[.!?]*")

    def __call__(self, text: str, language: str, *, split_sentences: bool = True):
        text = self.preprocess_text(text, language)
        if split_sentences:
            parts = [m.group(0).strip() for m in self._SENT_RE.finditer(text)]
            parts = [p for p in parts if p] or [text]
        else:
            parts = [text]
        sentences = [[ch for ch in p.lower() if ch in symbols.SYMBOL_TO_ID] for p in parts]
        return self._encode_sentences(sentences, split_sentences), text
