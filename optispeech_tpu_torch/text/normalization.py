"""Text normalization utilities (role of reference optispeech/text/normalization.py).

Exports: preprocess_text, collapse_whitespace, intersperse, UNICODE_NORM_FORM.
"""

import re
import unicodedata

UNICODE_NORM_FORM = "NFKC"

_WS = re.compile(r"\s+")


def collapse_whitespace(text: str) -> str:
    """Fold any whitespace run (tabs, newlines, multiple spaces) to one space."""
    return _WS.sub(" ", text)


def preprocess_text(text: str, language: str = None, *, normalize: bool = False) -> str:
    """Optionally NFKC-normalize, then collapse whitespace. `language` is
    accepted for tokenizer-interface symmetry and currently unused."""
    if normalize:
        text = unicodedata.normalize(UNICODE_NORM_FORM, text)
    return collapse_whitespace(text)


def intersperse(lst: list, item) -> list:
    """[a, b] -> [item, a, item, b, item] (blank-token interleaving used by
    tokenizers when add_blank is set)."""
    out = [item]
    for x in lst:
        out.append(x)
        out.append(item)
    return out
