"""Arabic (Buckwalter) tokenizer.

Capability parity with the reference's vendored Arabic phonetizer
(the reference optispeech/vendor/arabic_tokenizer/, registered as
`arabic-buck`, used by configs/data/kareem.yaml): diacritized Arabic (or
Buckwalter transliteration) -> phoneme tokens -> ids over the same 50-symbol
inventory (pad/eos/sil/doubling/separator + punctuation + consonants +
vowels), geminates encoded as consonant + `_dbl_`, `_+_` word separators and a
trailing `_eos_`.

This is a fresh implementation of the standard rules (Buckwalter
transliteration is a public standard; the G2P here covers: short vowels from
diacritics, tanween -> vowel + n, shadda -> doubling, long vowels aa/uu/ii,
sun-letter assimilation of the definite article, ta-marbuta, hamza forms,
madda). It is intended for fully diacritized text, like the reference.
"""

import re

from .tokenizers import BaseTokenizer

PADDING_TOKEN = "_pad_"
EOS_TOKEN = "_eos_"
SILENCE_TOKEN = "_sil_"
DOUBLING_TOKEN = "_dbl_"
SEPARATOR_TOKEN = "_+_"

# Same inventory/order as the reference's vendor symbol table (id contract).
ARABIC_SYMBOLS = [
    PADDING_TOKEN, EOS_TOKEN, SILENCE_TOKEN, DOUBLING_TOKEN, SEPARATOR_TOKEN,
    ".", "،", "؟", "!", ":", "؛", "-", ")", "(",
    "<", "b", "t", "^", "j", "H", "x", "d", "*", "r", "z", "s", "$", "S", "D",
    "T", "Z", "E", "g", "f", "q", "k", "l", "m", "n", "h", "w", "y", "v",
    "a", "u", "i", "aa", "uu", "ii",
]
PHON_TO_ID = {p: i for i, p in enumerate(ARABIC_SYMBOLS)}

# Standard Buckwalter transliteration (public standard).
_AR2BW = {
    "ء": "'", "آ": "|", "أ": ">", "ؤ": "&", "إ": "<",
    "ئ": "}", "ا": "A", "ب": "b", "ة": "p", "ت": "t",
    "ث": "v", "ج": "j", "ح": "H", "خ": "x", "د": "d",
    "ذ": "*", "ر": "r", "ز": "z", "س": "s", "ش": "$",
    "ص": "S", "ض": "D", "ط": "T", "ظ": "Z", "ع": "E",
    "غ": "g", "ـ": "_", "ف": "f", "ق": "q", "ك": "k",
    "ل": "l", "م": "m", "ن": "n", "ه": "h", "و": "w",
    "ى": "Y", "ي": "y", "ً": "F", "ٌ": "N", "ٍ": "K",
    "َ": "a", "ُ": "u", "ِ": "i", "ّ": "~", "ْ": "o",
    "ٰ": "`",
}
_BW2AR = {v: k for k, v in _AR2BW.items()}

# Buckwalter consonant -> phoneme symbol
_CONS = {
    "'": "<", ">": "<", "<": "<", "&": "<", "}": "<", "|": "<",  # hamza forms
    "b": "b", "t": "t", "v": "^", "j": "j", "H": "H", "x": "x", "d": "d",
    "*": "*", "r": "r", "z": "z", "s": "s", "$": "$", "S": "S", "D": "D",
    "T": "T", "Z": "Z", "E": "E", "g": "g", "f": "f", "q": "q", "k": "k",
    "l": "l", "m": "m", "n": "n", "h": "h", "w": "w", "y": "y",
}
_SUN = set("tv^djs$SDTZnrz*dl")  # sun letters (assimilate the article's laam)
_PUNCT = {".", "،", "؟", "!", ":", "؛", "-", ")", "("}


def arabic_to_buckwalter(text: str) -> str:
    return "".join(_AR2BW.get(ch, ch) for ch in text)


def buckwalter_to_arabic(text: str) -> str:
    return "".join(_BW2AR.get(ch, ch) for ch in text)


def _phonetise_word(word: str) -> list[str]:
    """Diacritized Buckwalter word -> phoneme token list."""
    out: list[str] = []
    i = 0
    n = len(word)

    # definite article: Al + sun letter -> assimilated (a + doubled consonant)
    if word.startswith("Al") and n > 2:
        nxt = word[2]
        if nxt in _SUN and nxt in _CONS:
            out.append("a")
            i = 2  # laam dropped; the sun letter usually carries shadda
        else:
            out.extend(["a", "l"])
            i = 2
    elif word.startswith(">al") or word.startswith("<al"):
        out.extend(["<", "a", "l"])
        i = 3

    while i < n:
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        nxt2 = word[i + 2] if i + 2 < n else ""

        if ch == "|":  # madda: hamza + long aa
            out.extend(["<", "aa"])
            i += 1
        elif ch == "A":
            # alif lengthens a preceding fatha; after a bare consonant the
            # fatha is implicit (salAm -> s a l aa m); word-initial = glottal
            if out and out[-1] == "a":
                out[-1] = "aa"
            elif out and out[-1] not in ("u", "i", "aa", "uu", "ii"):
                out.append("aa")
            elif not out:
                out.append("<")
                if nxt not in ("a", "u", "i", "o"):
                    out.append("a")
            i += 1
        elif ch == "Y":  # alif maqsura -> aa
            if out and out[-1] == "a":
                out[-1] = "aa"
            else:
                out.append("aa")
            i += 1
        elif ch == "p":  # ta marbuta: 't' when vowelled, else silent 'h'
            out.append("t" if nxt in ("a", "u", "i", "F", "N", "K") else "h")
            i += 1
        elif ch in _CONS:
            sym = _CONS[ch]
            # long vowels: w/y acting as mater lectionis
            if ch == "w" and out and out[-1] == "u" and nxt not in ("a", "u", "i", "~"):
                out[-1] = "uu"
                i += 1
                continue
            if ch == "y" and out and out[-1] == "i" and nxt not in ("a", "u", "i", "~"):
                out[-1] = "ii"
                i += 1
                continue
            out.append(sym)
            if nxt == "~":  # shadda: gemination
                out.append(DOUBLING_TOKEN)
                i += 1
            i += 1
        elif ch == "a":
            out.append("a")
            i += 1
        elif ch == "u":
            out.append("u")
            i += 1
        elif ch == "i":
            out.append("i")
            i += 1
        elif ch == "F":  # tanween fath
            out.extend(["a", "n"])
            i += 1
        elif ch == "N":  # tanween damm
            out.extend(["u", "n"])
            i += 1
        elif ch == "K":  # tanween kasr
            out.extend(["i", "n"])
            i += 1
        elif ch == "~":
            # shadda reached AFTER a vowel (NFC canonical ordering puts
            # fatha/damma/kasra before shadda): double the consonant that
            # precedes the vowel
            if out and out[-1] in ("a", "u", "i", "aa", "uu", "ii") and len(out) >= 2:
                out.insert(len(out) - 1, DOUBLING_TOKEN)
            elif out:
                out.append(DOUBLING_TOKEN)
            i += 1
        elif ch in ("o", "_", "`"):  # sukun / tatweel / dagger alif
            if ch == "`":
                out.append("aa")
            i += 1
        else:
            i += 1
    return out


def arabic_to_tokens(text: str, append_space: bool = False) -> list[str]:
    buckw = arabic_to_buckwalter(text)
    tokens: list[str] = []
    words = re.split(r"\s+", buckw.strip())
    for wi, word in enumerate(words):
        if not word:
            continue
        # peel punctuation
        core = word
        trail = []
        while core and core[-1] in _PUNCT:
            trail.append(core[-1])
            core = core[:-1]
        if core:
            if wi > 0 and tokens:
                tokens.append(SEPARATOR_TOKEN)
            tokens.extend(_phonetise_word(core))
        for t in reversed(trail):
            tokens.append(t)
    if append_space:
        tokens.append(SEPARATOR_TOKEN)
    tokens.append(EOS_TOKEN)
    return tokens


def tokens_to_ids(tokens: list[str]) -> list[int]:
    return [PHON_TO_ID[t] for t in tokens if t in PHON_TO_ID]


class ArabicTokenizer(BaseTokenizer):
    name = "arabic-buck"
    input_symbols = dict(PHON_TO_ID)
    special_symbols = dict(pad=PHON_TO_ID[PADDING_TOKEN], bos=None, eos=PHON_TO_ID[EOS_TOKEN])

    def __call__(self, text: str, language: str, *, split_sentences: bool = True):
        """No sentence splitting (reference vendor/arabic_tokenizer behaviour)."""
        import warnings

        if split_sentences:
            warnings.warn("Arabic tokenizer does not support sentence splitting for now.")
        tokens = arabic_to_tokens(self.preprocess_text(text, language))
        return tokens_to_ids(tokens), text
