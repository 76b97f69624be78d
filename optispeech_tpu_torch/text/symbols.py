"""Phoneme symbol inventory.

Data-compatible with the reference optispeech/text/symbols.py (161 IPA
symbols; PAD `_`=0, BOS `^`=1, EOS `$`=2) so preprocessed reference datasets
and id sequences are directly reusable (an explicit parity requirement). The
inventory is stored compactly as strings; ids are positional.
"""

# fmt: off
_SYMBOL_GROUPS = [
    "_^$ !\"#'(),-.",            # specials + punctuation
    "0123456789",                 # digits
    ":;?X",                       # more punctuation + X
    "abcdefghijklmnopqrstuvwxyz",  # latin
    "æçðøħŋœǀǁǂǃ",
    "ɐɑɒɓɔɕɖɗɘəɚɛɜɞɟɠɡɢɣɤɥɦɧɨɪɫɬɭɮɯɰɱɲɳɴɵɶɸɹɺɻɽɾ",
    "ʀʁʂʃʄʈʉʊʋʌʍʎʏʐʑʒʔʕʘʙʛʜʝʟʡʢʦ",
    "ʰʲˈˌːˑ˞ˤ",
    "̧̝̩̪̯̺̻̃̊",  # combining marks
    "βεθχᵻ↑↓ⱱ",
]
# fmt: on

SYMBOLS = [ch for group in _SYMBOL_GROUPS for ch in group]

PAD = "_"
BOS = "^"
EOS = "$"

PAD_ID = SYMBOLS.index(PAD)
BOS_ID = SYMBOLS.index(BOS)
EOS_ID = SYMBOLS.index(EOS)
SPACE_ID = SYMBOLS.index(" ")

SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(SYMBOLS)}


def phonemes_to_ids(text) -> list[int]:
    """(reference symbols.py:180-191)."""
    return [SYMBOL_TO_ID[symbol] for symbol in text]


def ids_to_phonemes(sequence) -> str:
    """(reference symbols.py:194-200)."""
    return "".join(ID_TO_SYMBOL[i] for i in sequence)
