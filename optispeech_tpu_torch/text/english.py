"""Self-contained English G2P (no espeak / network dependency).

Role: the reference's primary frontend phonemizes with espeak via the
piper_phonemize C++ binding (the reference optispeech/text/tokenizers.py:84-98),
which is unavailable in this image. This module provides a rule/lexicon
grapheme-to-phoneme converter so real English text can drive the SAME IPA
symbol inventory (text/symbols.py) end-to-end: a ~300-word exception lexicon
for function words and irregulars, plus a letter-to-sound rule engine in the
style of the public-domain NRL ruleset (Elovitz et al., NRL Report 7948,
1976): context-sensitive rules ``left [match] right -> phones`` with the
classic context classes (#, :, ^, ., +, &, @, %).

Output conventions (espeak-like General American):
- phones are ARPAbet internally, mapped to IPA at the end (ASCII letters
  where the inventory has them, ɡ/ɹ/ʃ/ʒ/... otherwise; long vowels carry ː),
- primary stress ˈ is placed immediately before the stressed vowel phone
  (lexicon entries carry curated stress digits; rule-derived words stress
  their first vowel — right for most 1-2 syllable English words),
- every emitted character is in symbols.SYMBOL_TO_ID.
"""

import re

# --------------------------------------------------------------------------
# ARPAbet -> inventory-IPA
# --------------------------------------------------------------------------

ARPA_TO_IPA = {
    "AA": "ɑː", "AE": "æ", "AH": "ʌ", "AX": "ə", "AO": "ɔː", "AW": "aʊ",
    "AY": "aɪ", "EH": "ɛ", "ER": "ɜː", "AXR": "ɚ", "EY": "eɪ", "IH": "ɪ",
    "IY": "iː", "OW": "oʊ", "OY": "ɔɪ", "UH": "ʊ", "UW": "uː",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}

VOWEL_PHONES = {
    "AA", "AE", "AH", "AX", "AO", "AW", "AY", "EH", "ER", "AXR", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}

# --------------------------------------------------------------------------
# Exception lexicon: function words + irregulars + rule misses.
# ARPAbet; digits mark stress (1 primary, 2 secondary, 0 reduced).
# Unstressed AH0 is rendered ə, stressed AH1 is ʌ; ER0 is ɚ, ER1 is ɜː.
# --------------------------------------------------------------------------

LEXICON = {
    # articles / pronouns / auxiliaries
    "a": "AH0", "an": "AH0 N", "the": "DH AH0", "of": "AH1 V",
    "to": "T UW1", "and": "AH0 N D", "is": "IH1 Z", "was": "W AA1 Z",
    "are": "AA1 R", "were": "W ER1", "be": "B IY1", "been": "B IH1 N",
    "am": "AE1 M", "do": "D UW1", "does": "D AH1 Z", "did": "D IH1 D",
    "done": "D AH1 N", "has": "HH AE1 Z", "have": "HH AE1 V",
    "had": "HH AE1 D", "he": "HH IY1", "she": "SH IY1", "we": "W IY1",
    "i": "AY1", "you": "Y UW1", "they": "DH EY1", "it": "IH1 T",
    "me": "M IY1", "him": "HH IH1 M", "her": "HH ER1", "us": "AH1 S",
    "them": "DH EH1 M", "my": "M AY1", "your": "Y AO1 R", "his": "HH IH1 Z",
    "its": "IH1 T S", "our": "AW1 ER0", "their": "DH EH1 R",
    "this": "DH IH1 S", "that": "DH AE1 T", "these": "DH IY1 Z",
    "those": "DH OW1 Z", "who": "HH UW1", "whom": "HH UW1 M",
    "whose": "HH UW1 Z", "what": "W AH1 T", "which": "W IH1 CH",
    "there": "DH EH1 R", "here": "HH IY1 R", "where": "W EH1 R",
    "when": "W EH1 N", "why": "W AY1", "how": "HH AW1",
    "as": "AE1 Z", "at": "AE1 T", "by": "B AY1", "for": "F AO1 R",
    "from": "F R AH1 M", "in": "IH1 N", "into": "IH1 N T UW2",
    "on": "AA1 N", "or": "AO1 R", "with": "W IH1 DH", "without": "W IH0 DH AW1 T",
    "not": "N AA1 T", "no": "N OW1", "nor": "N AO1 R", "so": "S OW1",
    "if": "IH1 F", "but": "B AH1 T", "because": "B IH0 K AH1 Z",
    "could": "K UH1 D", "would": "W UH1 D", "should": "SH UH1 D",
    "can": "K AE1 N", "may": "M EY1", "might": "M AY1 T",
    "must": "M AH1 S T", "shall": "SH AE1 L", "will": "W IH1 L",
    # contractions
    "don't": "D OW1 N T", "won't": "W OW1 N T", "can't": "K AE1 N T",
    "i'm": "AY1 M", "i'll": "AY1 L", "i've": "AY1 V", "i'd": "AY1 D",
    "it's": "IH1 T S", "let's": "L EH1 T S", "you're": "Y UH1 R",
    "we're": "W IY1 R", "they're": "DH EH1 R", "he's": "HH IY1 Z",
    "she's": "SH IY1 Z", "that's": "DH AE1 T S", "there's": "DH EH1 R Z",
    "what's": "W AH1 T S", "o'clock": "AH0 K L AA1 K",
    # irregular everyday words
    "one": "W AH1 N", "once": "W AH1 N S", "two": "T UW1",
    "says": "S EH1 Z", "said": "S EH1 D", "again": "AH0 G EH1 N",
    "against": "AH0 G EH1 N S T", "any": "EH1 N IY0", "many": "M EH1 N IY0",
    "only": "OW1 N L IY0", "very": "V EH1 R IY0", "every": "EH1 V R IY0",
    "people": "P IY1 P AH0 L", "woman": "W UH1 M AH0 N",
    "women": "W IH1 M IH0 N", "busy": "B IH1 Z IY0", "business": "B IH1 Z N AH0 S",
    "pretty": "P R IH1 T IY0", "friend": "F R EH1 N D", "gone": "G AO1 N",
    "some": "S AH1 M", "come": "K AH1 M", "something": "S AH1 M TH IH0 NG",
    "nothing": "N AH1 TH IH0 NG", "mother": "M AH1 DH ER0",
    "father": "F AA1 DH ER0", "brother": "B R AH1 DH ER0",
    "other": "AH1 DH ER0", "another": "AH0 N AH1 DH ER0",
    "money": "M AH1 N IY0", "month": "M AH1 N TH", "monday": "M AH1 N D EY2",
    "love": "L AH1 V", "above": "AH0 B AH1 V", "move": "M UW1 V",
    "lose": "L UW1 Z", "whole": "HH OW1 L", "who's": "HH UW1 Z",
    "water": "W AO1 T ER0", "want": "W AA1 N T", "watch": "W AA1 CH",
    "was n't": "W AA1 Z AH0 N T", "wasn't": "W AA1 Z AH0 N T",
    "isn't": "IH1 Z AH0 N T", "doesn't": "D AH1 Z AH0 N T",
    "world": "W ER1 L D", "word": "W ER1 D", "work": "W ER1 K",
    "earth": "ER1 TH", "early": "ER1 L IY0", "learn": "L ER1 N",
    "heard": "HH ER1 D", "heart": "HH AA1 R T", "great": "G R EY1 T",
    "break": "B R EY1 K", "steak": "S T EY1 K", "bear": "B EH1 R",
    "wear": "W EH1 R", "eye": "AY1", "eyes": "AY1 Z", "buy": "B AY1",
    "guy": "G AY1", "dead": "D EH1 D", "head": "HH EH1 D",
    "bread": "B R EH1 D", "ready": "R EH1 D IY0", "sure": "SH UH1 R",
    "sugar": "SH UH1 G ER0", "cow": "K AW1", "town": "T AW1 N",
    "down": "D AW1 N", "brown": "B R AW1 N", "crowd": "K R AW1 D",
    "flower": "F L AW1 ER0", "power": "P AW1 ER0", "hour": "AW1 ER0",
    "tower": "T AW1 ER0", "food": "F UW1 D", "mood": "M UW1 D",
    "blood": "B L AH1 D", "flood": "F L AH1 D", "foot": "F UH1 T",
    "door": "D AO1 R", "floor": "F L AO1 R", "poor": "P UH1 R",
    "cost": "K AO1 S T", "lost": "L AO1 S T", "frost": "F R AO1 S T",
    "both": "B OW1 TH", "most": "M OW1 S T", "post": "P OW1 S T",
    "front": "F R AH1 N T", "none": "N AH1 N", "son": "S AH1 N",
    "ton": "T AH1 N", "won": "W AH1 N", "yes": "Y EH1 S",
    "bus": "B AH1 S", "gas": "G AE1 S", "plus": "P L AH1 S",
    "thus": "DH AH1 S", "during": "D UH1 R IH0 NG", "truth": "T R UW1 TH",
    "true": "T R UW1", "blue": "B L UW1", "shoe": "SH UW1",
    "shoes": "SH UW1 Z", "half": "HH AE1 F", "calm": "K AA1 M",
    "talk": "T AO1 K", "walk": "W AO1 K", "island": "AY1 L AH0 N D",
    "iron": "AY1 ER0 N", "answer": "AE1 N S ER0", "often": "AO1 F AH0 N",
    "listen": "L IH1 S AH0 N", "castle": "K AE1 S AH0 L",
    "beautiful": "B Y UW1 T AH0 F AH0 L", "beauty": "B Y UW1 T IY0",
    "idea": "AY0 D IY1 AH0", "area": "EH1 R IY0 AH0",
    "ocean": "OW1 SH AH0 N", "colonel": "K ER1 N AH0 L",
    "choir": "K W AY1 ER0", "tongue": "T AH1 NG", "young": "Y AH1 NG",
    "touch": "T AH1 CH", "tough": "T AH1 F", "enough": "IH0 N AH1 F",
    "rough": "R AH1 F", "laugh": "L AE1 F", "cough": "K AO1 F",
    "though": "DH OW1", "through": "TH R UW1", "thought": "TH AO1 T",
    "daughter": "D AO1 T ER0", "friends": "F R EH1 N D Z",
    "minute": "M IH1 N AH0 T", "sword": "S AO1 R D",
    "climb": "K L AY1 M", "comb": "K OW1 M", "lamb": "L AE1 M",
    "thumb": "TH AH1 M", "debt": "D EH1 T", "doubt": "D AW1 T",
    "receipt": "R IH0 S IY1 T", "subtle": "S AH1 T AH0 L",
    "honest": "AA1 N AH0 S T", "honor": "AA1 N ER0",
    "stomach": "S T AH1 M AH0 K", "ache": "EY1 K",
    "machine": "M AH0 SH IY1 N", "police": "P AH0 L IY1 S",
    "pizza": "P IY1 T S AH0", "quay": "K IY1", "suite": "S W IY1 T",
    "yacht": "Y AA1 T", "aisle": "AY1 L", "height": "HH AY1 T",
    "weight": "W EY1 T", "neighbor": "N EY1 B ER0", "either": "IY1 DH ER0",
    "neither": "N IY1 DH ER0", "heights": "HH AY1 T S",
    "caught": "K AO1 T", "bought": "B AO1 T", "brought": "B R AO1 T",
    "fought": "F AO1 T", "taught": "T AO1 T",
    "course": "K AO1 R S", "source": "S AO1 R S", "court": "K AO1 R T",
    "journey": "JH ER1 N IY0", "country": "K AH1 N T R IY0",
    "cousin": "K AH1 Z AH0 N", "couple": "K AH1 P AH0 L",
    "double": "D AH1 B AH0 L", "trouble": "T R AH1 B AH0 L",
    "southern": "S AH1 DH ER0 N", "south": "S AW1 TH",
    "wolf": "W UH1 L F", "wool": "W UH1 L", "bosom": "B UH1 Z AH0 M",
    "bury": "B EH1 R IY0", "burial": "B EH1 R IY0 AH0 L",
    "evil": "IY1 V AH0 L", "even": "IY1 V AH0 N",
    "china": "CH AY1 N AH0", "christmas": "K R IH1 S M AH0 S",
    "clothes": "K L OW1 DH Z", "column": "K AA1 L AH0 M",
    "autumn": "AO1 T AH0 M", "exact": "IH0 G Z AE1 K T",
    "example": "IH0 G Z AE1 M P AH0 L", "exist": "IH0 G Z IH1 S T",
    "examine": "IH0 G Z AE1 M AH0 N", "exhaust": "IH0 G Z AO1 S T",
    "anxiety": "AE0 NG Z AY1 AH0 T IY0", "luxury": "L AH1 K SH ER0 IY0",
    "genre": "ZH AA1 N R AH0", "garage": "G ER0 AA1 ZH",
    "mirage": "M ER0 AA1 ZH", "massage": "M AH0 S AA1 ZH",
    "vision": "V IH1 ZH AH0 N", "measure": "M EH1 ZH ER0",
    "pleasure": "P L EH1 ZH ER0", "treasure": "T R EH1 ZH ER0",
    "usual": "Y UW1 ZH UW0 AH0 L", "usually": "Y UW1 ZH UW0 AH0 L IY0",
    "casual": "K AE1 ZH UW0 AH0 L", "visual": "V IH1 ZH UW0 AH0 L",
    "television": "T EH1 L AH0 V IH2 ZH AH0 N",
    "decision": "D IH0 S IH1 ZH AH0 N", "occasion": "AH0 K EY1 ZH AH0 N",
    "version": "V ER1 ZH AH0 N", "asia": "EY1 ZH AH0",
    "says,": "S EH1 Z", "toward": "T AH0 W AO1 R D",
    "forward": "F AO1 R W ER0 D", "war": "W AO1 R", "warm": "W AO1 R M",
    "quarter": "K W AO1 R T ER0", "square": "S K W EH1 R",
    "sergeant": "S AA1 R JH AH0 N T", "recipe": "R EH1 S AH0 P IY0",
    "café": "K AE0 F EY1", "cafe": "K AE0 F EY1",
    "ballet": "B AE0 L EY1", "buffet": "B AH0 F EY1",
    "bouquet": "B UW0 K EY1", "debris": "D AH0 B R IY1",
    "corps": "K AO1 R", "chef": "SH EH1 F", "chic": "SH IY1 K",
    "niche": "N IH1 CH", "cache": "K AE1 SH", "epoch": "EH1 P AH0 K",
    "children": "CH IH1 L D R AH0 N", "river": "R IH1 V ER0",
    "given": "G IH1 V AH0 N", "liver": "L IH1 V ER0",
    "limit": "L IH1 M AH0 T", "between": "B IH0 T W IY1 N",
    "zero": "Z IY1 R OW0", "hundred": "HH AH1 N D R AH0 D",
    "thousand": "TH AW1 Z AH0 N D", "million": "M IH1 L Y AH0 N",
    "billion": "B IH1 L Y AH0 N", "trillion": "T R IH1 L Y AH0 N",
    "eleven": "IH0 L EH1 V AH0 N", "twelve": "T W EH1 L V",
    "twenty": "T W EH1 N T IY0", "thirty": "TH ER1 T IY0",
    "forty": "F AO1 R T IY0", "fifty": "F IH1 F T IY0",
    "sixty": "S IH1 K S T IY0", "seventy": "S EH1 V AH0 N T IY0",
    "eighty": "EY1 T IY0", "ninety": "N AY1 N T IY0",
    "eight": "EY1 T", "eighth": "EY1 T TH", "ninth": "N AY1 N TH",
    "twelfth": "T W EH1 L F TH", "fifth": "F IH1 F TH",
    # -se words where intervocalic s stays voiceless (the #[s]# rule says z)
    "house": "HH AW1 S", "mouse": "M AW1 S", "case": "K EY1 S",
    "base": "B EY1 S", "goose": "G UW1 S", "loose": "L UW1 S",
    "purpose": "P ER1 P AH0 S", "promise": "P R AA1 M AH0 S",
    "increase": "IH1 N K R IY2 S", "release": "R IH0 L IY1 S",
    "chase": "CH EY1 S", "dose": "D OW1 S", "horse": "HH AO1 R S",
    "else": "EH1 L S", "sense": "S EH1 N S", "house's": "HH AW1 S IH0 Z",
    "point": "P OY1 N T", "percent": "P ER0 S EH1 N T",
    "dollar": "D AA1 L ER0", "dollars": "D AA1 L ER0 Z",
}

# --------------------------------------------------------------------------
# NRL-style letter-to-sound rules
#
# Rule = (left_context, match, right_context, phones). Context classes:
#   #  one or more vowel letters        :  zero or more consonant letters
#   ^  exactly one consonant letter     .  one voiced consonant (bdvgjlmnrwz)
#   +  one front vowel (e, i, y)        &  a sibilant spelling
#   @  a consonant that palatalizes a following long u
#   %  a suffix (-e, -er, -es, -ed, -ing, -ely)   (right context only)
#   ' ' word boundary
# First matching rule wins; rules are tried in order within the letter group.
# --------------------------------------------------------------------------

_VOWELS = set("aeiouy")
_CONSONANTS = set("bcdfghjklmnpqrstvwxz")
_VOICED = set("bdvgjlmnrwz")
_FRONT = set("eiy")
_SIBILANT_1 = set("scgzxj")
_PALATAL_1 = set("tsrdlznj")

RULES = {
    "a": [
        ("", "a", " ", "AX"),
        (" ", "are", " ", "AA R"),
        (" ", "ar", "o", "AX R"),
        ("", "ar", "#", "EH R"),
        ("^", "as", "#", "EY S"),
        ("", "a", "wa", "AX"),
        ("", "aw", "", "AO"),
        (" :", "any", "", "EH N IY"),
        ("", "a", "^+#", "EY"),
        ("#:", "ally", "", "AX L IY"),
        (" ", "al", "#", "AX L"),
        ("", "again", "", "AX G EH N"),
        ("#:", "ag", "e", "IH JH"),
        ("", "a", "^+:#", "AE"),
        (" :", "a", "^+ ", "EY"),
        ("", "a", "^%", "EY"),
        (" ", "arr", "", "AX R"),
        ("", "arr", "", "AE R"),
        (" :", "ar", " ", "AA R"),
        ("", "ar", " ", "ER"),
        ("", "ar", "", "AA R"),
        ("", "air", "", "EH R"),
        ("", "ai", "", "EY"),
        ("", "ay", "", "EY"),
        ("", "au", "", "AO"),
        ("#:", "al", " ", "AX L"),
        ("#:", "als", " ", "AX L Z"),
        ("", "alk", "", "AO K"),
        ("", "al", "^", "AO L"),
        (" :", "able", "", "EY B AX L"),
        ("", "able", "", "AX B AX L"),
        ("", "ang", "+", "EY N JH"),
        (" ", "a", "^#", "AX"),
        ("", "a", "", "AE"),
    ],
    "b": [
        (" ", "be", "^#", "B IH"),
        ("", "being", "", "B IY IH NG"),
        (" ", "both", " ", "B OW TH"),
        (" ", "bus", "#", "B IH Z"),
        ("", "buil", "", "B IH L"),
        ("", "b", "b", ""),
        ("", "b", "", "B"),
    ],
    "c": [
        (" ", "ch", "^", "K"),
        ("^e", "ch", "", "K"),
        ("", "ch", "", "CH"),
        (" s", "ci", "#", "S AY"),
        ("", "ci", "a", "SH"),
        ("", "ci", "o", "SH"),
        ("", "ci", "en", "SH"),
        ("", "c", "+", "S"),
        ("", "ck", "", "K"),
        ("", "com", "%", "K AH M"),
        ("", "c", "c", ""),
        ("", "c", "", "K"),
    ],
    "d": [
        ("#:", "ded", " ", "D IH D"),
        (".e", "d", " ", "D"),
        ("#:^e", "d", " ", "T"),
        (" ", "de", "^#", "D IH"),
        (" ", "do", " ", "D UW"),
        (" ", "does", "", "D AH Z"),
        (" ", "doing", "", "D UW IH NG"),
        (" ", "dow", "", "D AW"),
        ("", "du", "a", "JH UW"),
        ("", "d", "d", ""),
        ("", "d", "", "D"),
    ],
    "e": [
        ("#:", "e", " ", ""),
        ("':^", "e", " ", ""),
        (" :", "e", " ", "IY"),
        ("#", "ed", " ", "D"),
        ("#:", "e", "d ", ""),
        ("", "ev", "er", "EH V"),
        ("", "e", "^%", "IY"),
        ("", "eri", "#", "IY R IY"),
        ("", "eri", "", "EH R IH"),
        ("#:", "er", "#", "ER"),
        ("", "er", "#", "EH R"),
        ("", "er", "", "ER"),
        (" ", "even", "", "IY V EH N"),
        ("#:", "e", "w", ""),
        ("@", "ew", "", "UW"),
        ("", "ew", "", "Y UW"),
        ("", "e", "o", "IY"),
        ("#:&", "es", " ", "IH Z"),
        ("#:", "e", "s ", ""),
        ("#:", "ely", " ", "L IY"),
        ("#:", "ement", "", "M EH N T"),
        ("", "eful", "", "F UH L"),
        ("", "ee", "", "IY"),
        ("", "earn", "", "ER N"),
        (" ", "ear", "^", "ER"),
        ("", "ead", "", "EH D"),
        ("#:", "ea", " ", "IY AX"),
        ("", "ea", "su", "EH"),
        ("", "ea", "", "IY"),
        ("", "eigh", "", "EY"),
        ("", "ei", "", "IY"),
        (" ", "eye", "", "AY"),
        ("", "ey", "", "IY"),
        ("", "eu", "", "Y UW"),
        ("", "e", "", "EH"),
    ],
    "f": [
        ("", "ful", "", "F UH L"),
        ("", "f", "f", ""),
        ("", "f", "", "F"),
    ],
    "g": [
        ("", "giv", "", "G IH V"),
        (" ", "g", "i^", "G"),
        ("", "ge", "t", "G EH"),
        ("su", "gges", "", "G JH EH S"),
        ("", "gg", "", "G"),
        (" b#", "g", "", "G"),
        ("", "g", "+", "JH"),
        ("", "great", "", "G R EY T"),
        ("#", "gh", "", ""),
        ("", "g", "", "G"),
    ],
    "h": [
        (" ", "hav", "", "HH AE V"),
        (" ", "here", "", "HH IY R"),
        (" ", "hour", "", "AW ER"),
        ("", "how", "", "HH AW"),
        ("", "h", "#", "HH"),
        ("", "h", "", ""),
    ],
    "i": [
        (" ", "in", "", "IH N"),
        (" ", "i", " ", "AY"),
        ("", "in", "d", "AY N"),
        ("", "ier", "", "IY ER"),
        ("#:r", "ied", "", "IY D"),
        ("", "ied", " ", "AY D"),
        ("", "ien", "", "IY EH N"),
        ("", "ie", "t", "AY EH"),
        (" :", "i", "%", "AY"),
        ("", "i", "%", "IY"),
        ("", "ie", "", "IY"),
        ("", "i", "^+:#", "IH"),
        ("", "ir", "#", "AY R"),
        ("", "iz", "%", "AY Z"),
        ("", "is", "%", "AY Z"),
        ("", "i", "d%", "AY"),
        ("+^", "i", "^+", "IH"),
        ("", "i", "t%", "AY"),
        ("#:^", "i", "^+", "IH"),
        ("", "i", "^y ", "IH"),
        ("", "i", "^+", "AY"),
        ("", "ir", "", "ER"),
        ("", "igh", "", "AY"),
        ("", "ild", "", "AY L D"),
        ("", "ign", " ", "AY N"),
        ("", "ign", "^", "AY N"),
        ("", "ign", "%", "AY N"),
        ("", "ique", "", "IY K"),
        ("", "i", "", "IH"),
    ],
    "j": [
        ("", "j", "", "JH"),
    ],
    "k": [
        (" ", "k", "n", ""),
        ("", "k", "", "K"),
    ],
    "l": [
        ("", "lo", "c#", "L OW"),
        ("l", "l", "", ""),
        ("#:^", "l", "%", "AX L"),
        ("", "lead", "", "L IY D"),
        ("", "l", "", "L"),
    ],
    "m": [
        ("", "mov", "", "M UW V"),
        ("", "m", "m", ""),
        ("", "m", "", "M"),
    ],
    "n": [
        ("e", "ng", "+", "N JH"),
        ("", "ng", "r", "NG G"),
        ("", "ng", "#", "NG G"),
        ("", "ngl", "%", "NG G AX L"),
        ("", "ng", "", "NG"),
        ("", "nk", "", "NG K"),
        (" ", "now", " ", "N AW"),
        ("", "n", "n", ""),
        ("", "n", "", "N"),
    ],
    "o": [
        ("", "of", " ", "AX V"),
        ("", "orough", "", "ER OW"),
        ("#:", "or", " ", "ER"),
        ("#:", "ors", " ", "ER Z"),
        ("", "or", "", "AO R"),
        (" ", "one", "", "W AH N"),
        ("", "ow", "", "OW"),
        (" ", "over", "", "OW V ER"),
        ("", "ov", "", "AH V"),
        ("", "o", "^%", "OW"),
        ("", "o", "^en", "OW"),
        ("", "o", "^i#", "OW"),
        ("", "ol", "d", "OW L"),
        ("", "ought", "", "AO T"),
        ("", "ough", "", "AH F"),
        (" ", "ou", "", "AW"),
        ("h", "ou", "s#", "AW"),
        ("", "ous", "", "AX S"),
        ("", "our", "", "AO R"),
        ("", "ould", "", "UH D"),
        ("^", "ou", "^l", "AH"),
        ("", "oup", "", "UW P"),
        ("", "ou", "", "AW"),
        ("", "oy", "", "OY"),
        ("", "oing", "", "OW IH NG"),
        ("", "oi", "", "OY"),
        ("", "oor", "", "AO R"),
        ("", "ook", "", "UH K"),
        ("", "ood", "", "UH D"),
        ("", "oo", "", "UW"),
        ("", "o", "e", "OW"),
        ("", "o", " ", "OW"),
        ("", "oa", "", "OW"),
        (" ", "only", "", "OW N L IY"),
        (" ", "once", "", "W AH N S"),
        ("", "on't", "", "OW N T"),
        ("c", "o", "n", "AA"),
        ("", "o", "ng", "AO"),
        (" :^", "o", "n", "AH"),
        ("i", "on", "", "AX N"),
        ("#:", "on", " ", "AX N"),
        ("#^", "on", "", "AX N"),
        ("", "o", "st ", "OW"),
        ("", "of", "^", "AO F"),
        ("", "other", "", "AH DH ER"),
        ("", "oss", " ", "AO S"),
        ("#:^", "om", "", "AX M"),
        ("", "o", "", "AA"),
    ],
    "p": [
        ("", "ph", "", "F"),
        ("", "peop", "", "P IY P"),
        ("", "pow", "", "P AW"),
        ("", "put", " ", "P UH T"),
        ("", "p", "p", ""),
        ("", "p", "", "P"),
    ],
    "q": [
        ("", "quar", "", "K W AO R"),
        ("", "qu", "", "K W"),
        ("", "q", "", "K"),
    ],
    "r": [
        (" ", "re", "^#", "R IY"),
        ("", "r", "r", ""),
        ("", "r", "", "R"),
    ],
    "s": [
        ("", "sh", "", "SH"),
        ("#", "sion", "", "ZH AX N"),
        ("", "some", "", "S AH M"),
        ("#", "sur", "#", "ZH ER"),
        ("", "sur", "#", "SH ER"),
        ("#", "su", "#", "ZH UW"),
        ("#", "ssu", "#", "SH UW"),
        ("#", "sed", " ", "Z D"),
        ("#", "s", "#", "Z"),
        ("", "said", "", "S EH D"),
        ("^", "sion", "", "SH AX N"),
        ("", "s", "s", ""),
        (".", "s", " ", "Z"),
        ("#e", "s", " ", "Z"),
        ("#:.e", "s", " ", "Z"),
        ("#:^##", "s", " ", "Z"),
        ("#:^#", "s", " ", "S"),
        ("u", "s", " ", "S"),
        (" :#", "s", " ", "Z"),
        (" ", "sch", "", "S K"),
        ("", "s", "c+", ""),
        ("#", "sm", "", "Z M"),
        ("#", "sn", "'", "Z AX N"),
        ("", "s", "", "S"),
    ],
    "t": [
        (" ", "the", " ", "DH AX"),
        (" ", "to", " ", "T UW"),
        ("", "that", " ", "DH AE T"),
        (" ", "this", " ", "DH IH S"),
        (" ", "they", "", "DH EY"),
        (" ", "there", "", "DH EH R"),
        ("", "ther", "", "DH ER"),
        ("", "their", "", "DH EH R"),
        (" ", "than", " ", "DH AE N"),
        (" ", "them", " ", "DH EH M"),
        ("", "these", " ", "DH IY Z"),
        (" ", "then", "", "DH EH N"),
        ("", "through", "", "TH R UW"),
        ("", "those", "", "DH OW Z"),
        ("", "though", " ", "DH OW"),
        (" ", "thus", "", "DH AH S"),
        ("", "th", "", "TH"),
        ("#:", "ted", " ", "T IH D"),
        ("s", "ti", "#n", "CH"),
        ("", "ti", "o", "SH"),
        ("", "ti", "a", "SH"),
        ("", "tien", "", "SH AX N"),
        ("", "tur", "#", "CH ER"),
        ("", "tu", "a", "CH UW"),
        (" ", "two", "", "T UW"),
        ("", "t", "t", ""),
        ("", "t", "", "T"),
    ],
    "u": [
        (" ", "un", "i", "Y UW N"),
        (" ", "un", "", "AH N"),
        (" ", "upon", "", "AX P AO N"),
        ("@", "ur", "#", "ER"),
        ("", "ur", "#", "Y UH R"),
        ("", "ur", "", "ER"),
        ("", "u", "^ ", "AH"),
        ("", "u", "^^", "AH"),
        ("", "uy", "", "AY"),
        (" g", "u", "#", ""),
        ("g", "u", "%", ""),
        ("g", "u", "#", "W"),
        ("#n", "u", "", "Y UW"),
        ("", "ui", "t", "UW"),
        ("@", "u", "", "UW"),
        ("", "u", "", "Y UW"),
    ],
    "v": [
        ("", "view", "", "V Y UW"),
        ("", "v", "", "V"),
    ],
    "w": [
        (" ", "were", "", "W ER"),
        ("", "wa", "s", "W AA"),
        ("", "wa", "t", "W AA"),
        ("", "where", "", "W EH R"),
        ("", "what", "", "W AA T"),
        ("", "whol", "", "HH OW L"),
        ("", "who", "", "HH UW"),
        ("", "wh", "", "W"),
        ("", "war", "", "W AO R"),
        ("", "wor", "^", "W ER"),
        ("", "wr", "", "R"),
        ("", "wom", "a", "W UH M"),
        ("", "wom", "e", "W IH M"),
        ("", "wea", "r", "W EH"),
        ("", "wan", "t", "W AA N"),
        ("ans", "wer", "", "ER"),
        ("", "w", "", "W"),
    ],
    "x": [
        (" ", "x", "", "Z"),
        ("", "x", "", "K S"),
    ],
    "y": [
        ("", "young", "", "Y AH NG"),
        (" ", "you", "r", "Y AO"),
        (" ", "you", "", "Y UW"),
        (" ", "yes", "", "Y EH S"),
        (" ", "y", "", "Y"),
        ("#:^", "y", " ", "IY"),
        ("#:^", "y", "i", "IY"),
        (" :", "y", " ", "AY"),
        (" :", "y", "#", "AY"),
        ("", "y", "^+:#", "IH"),
        ("", "y", "^#", "AY"),
        ("", "y", "", "IH"),
    ],
    "z": [
        ("", "z", "z", ""),
        ("", "z", "", "Z"),
    ],
    "'": [
        (".", "'s", " ", "Z"),
        ("#", "'s", " ", "Z"),
        ("", "'s", " ", "S"),
        ("", "'", "", ""),
    ],
}


def _is_suffix(s: str) -> int:
    """Match a % suffix at the START of right-context string s; return the
    matched length or -1. Suffixes: er, e, es, ed, ing, ely."""
    for suf in ("ely", "ing", "er", "ed", "es", "e"):
        if s.startswith(suf):
            rest = s[len(suf):]
            if rest == "" or rest[0] == " ":
                return len(suf)
            # suffix may itself be followed by s/d (e.g. "makes" -> e + s)
            if suf in ("e",) and rest[0] in "sd":
                return len(suf)
    return -1


def _match_right(ctx: str, s: str) -> bool:
    """Match context pattern ctx against the string s, left-to-right."""
    ci = si = 0
    while ci < len(ctx):
        c = ctx[ci]
        if c == "#":
            if si >= len(s) or s[si] not in _VOWELS:
                return False
            while si < len(s) and s[si] in _VOWELS:
                si += 1
        elif c == ":":
            while si < len(s) and s[si] in _CONSONANTS:
                si += 1
        elif c == "^":
            if si >= len(s) or s[si] not in _CONSONANTS:
                return False
            si += 1
        elif c == ".":
            if si >= len(s) or s[si] not in _VOICED:
                return False
            si += 1
        elif c == "+":
            if si >= len(s) or s[si] not in _FRONT:
                return False
            si += 1
        elif c == "&":
            if si < len(s) - 1 and s[si : si + 2] in ("ch", "sh"):
                si += 2
            elif si < len(s) and s[si] in _SIBILANT_1:
                si += 1
            else:
                return False
        elif c == "@":
            if si < len(s) - 1 and s[si : si + 2] in ("th", "ch", "sh"):
                si += 2
            elif si < len(s) and s[si] in _PALATAL_1:
                si += 1
            else:
                return False
        elif c == "%":
            n = _is_suffix(s[si:])
            if n < 0:
                return False
            si += n
        elif c == " ":
            if si < len(s) and s[si] != " ":
                return False
            si += 1
        else:
            if si >= len(s) or s[si] != c:
                return False
            si += 1
        ci += 1
    return True


def _match_left(ctx: str, s: str) -> bool:
    """Match context pattern ctx against s where s ENDS at the match point
    (scan both right-to-left)."""
    ci = len(ctx) - 1
    si = len(s) - 1
    while ci >= 0:
        c = ctx[ci]
        if c == "#":
            if si < 0 or s[si] not in _VOWELS:
                return False
            while si >= 0 and s[si] in _VOWELS:
                si -= 1
        elif c == ":":
            while si >= 0 and s[si] in _CONSONANTS:
                si -= 1
        elif c == "^":
            if si < 0 or s[si] not in _CONSONANTS:
                return False
            si -= 1
        elif c == ".":
            if si < 0 or s[si] not in _VOICED:
                return False
            si -= 1
        elif c == "+":
            if si < 0 or s[si] not in _FRONT:
                return False
            si -= 1
        elif c == "&":
            if si >= 1 and s[si - 1 : si + 1] in ("ch", "sh"):
                si -= 2
            elif si >= 0 and s[si] in _SIBILANT_1:
                si -= 1
            else:
                return False
        elif c == "@":
            if si >= 1 and s[si - 1 : si + 1] in ("th", "ch", "sh"):
                si -= 2
            elif si >= 0 and s[si] in _PALATAL_1:
                si -= 1
            else:
                return False
        elif c == " ":
            if si >= 0 and s[si] != " ":
                return False
            si -= 1
        else:
            if si < 0 or s[si] != c:
                return False
            si -= 1
        ci -= 1
    return True


def word_to_arpabet(word: str) -> list[str]:
    """Letter-to-sound conversion of one lowercase word (no lexicon)."""
    text = f" {word.lower()} "
    phones: list[str] = []
    i = 1
    while i < len(text) - 1:
        ch = text[i]
        group = RULES.get(ch)
        if group is None:
            i += 1  # unknown character: skip
            continue
        for left, match, right, out in group:
            j = i + len(match)
            if text[i:j] != match:
                continue
            if left and not _match_left(left, text[:i]):
                continue
            if right and not _match_right(right, text[j:]):
                continue
            if out:
                phones.extend(out.split())
            i = j
            break
        else:
            i += 1  # no rule matched (defensive; default rules always match)
    return phones


def _arpa_to_ipa(phones: list[str], stress_index: int = -1) -> str:
    """Render ARPAbet phones to inventory IPA. `stress_index` marks the phone
    (a vowel) that receives ˈ; -1 = none."""
    out = []
    for k, p in enumerate(phones):
        base = p.rstrip("012")
        if base == "ER" and k != stress_index:
            base = "AXR"  # unstressed r-colored schwa (over -> ˈoʊvɚ)
        if k == stress_index:
            out.append("ˈ")
        out.append(ARPA_TO_IPA[base])
    return "".join(out)


def _lexicon_to_ipa(entry: str) -> str:
    """Render a stress-marked lexicon entry. AH0 reduces to ə, ER0 to ɚ."""
    out = []
    for p in entry.split():
        base, stress = p.rstrip("012"), p[-1] if p[-1] in "012" else ""
        if base == "AH" and stress == "0":
            base = "AX"
        elif base == "ER" and stress == "0":
            base = "AXR"
        if stress == "1":
            out.append("ˈ")
        elif stress == "2":
            out.append("ˌ")
        out.append(ARPA_TO_IPA[base])
    return "".join(out)


def _first_vowel(phones: list[str]) -> int:
    for k, p in enumerate(phones):
        if p.rstrip("012") in VOWEL_PHONES:
            return k
    return -1


_CLITICS = {
    "'ll": ["AX", "L"], "'ve": ["V"], "'re": ["ER"], "'d": ["D"], "'m": ["M"],
}
_SIBILANT_PHONES = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOICED_PHONES = VOWEL_PHONES | {
    "B", "D", "G", "V", "DH", "Z", "ZH", "JH", "L", "M", "N", "NG", "R", "W", "Y",
}


def g2p_word(word: str) -> str:
    """One word -> IPA string (lexicon first, then clitic split, then rules)."""
    w = word.lower()
    if not w:
        return ""
    if w in LEXICON:
        return _lexicon_to_ipa(LEXICON[w])
    # clitics: possessive 's / n't / 'll 've 're 'd 'm on any stem
    if w.endswith("'s"):
        stem = g2p_word(w[:-2])
        last = _ipa_final_class(stem)
        return stem + {"sib": "ɪz", "voiced": "z", "voiceless": "s"}[last]
    if w.endswith("n't"):
        return g2p_word(w[:-3]) + "ənt"
    for cl, phones in _CLITICS.items():
        if w.endswith(cl) and len(w) > len(cl):
            return g2p_word(w[: -len(cl)]) + _arpa_to_ipa(phones)
    phones = word_to_arpabet(w)
    return _arpa_to_ipa(phones, stress_index=_first_vowel(phones))


_IPA_SIBILANT_TAILS = ("s", "z", "ʃ", "ʒ", "tʃ", "dʒ")
_IPA_VOICELESS_TAILS = ("p", "t", "k", "f", "θ", "h")


def _ipa_final_class(ipa: str) -> str:
    s = ipa.rstrip("ˈˌː")
    for t in _IPA_SIBILANT_TAILS:
        if s.endswith(t):
            return "sib"
    for t in _IPA_VOICELESS_TAILS:
        if s.endswith(t):
            return "voiceless"
    return "voiced"


# --------------------------------------------------------------------------
# Number / abbreviation expansion
# --------------------------------------------------------------------------

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand"), (100, "hundred")]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    for scale, name in _SCALES:
        if n >= scale:
            q, r = divmod(n, scale)
            head = number_to_words(q) + " " + name
            return head + (" " + number_to_words(r) if r else "")
    return _ONES[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n).split()
    last = words[-1]
    if last in _ORDINAL_SPECIAL:
        words[-1] = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


_ABBREV = {
    "mr": "mister", "mrs": "missus", "dr": "doctor", "st": "saint",
    "etc": "et cetera", "vs": "versus", "no": "number",
}

_NUM_RE = re.compile(r"\d[\d,]*(\.\d+)?")
_ORD_RE = re.compile(r"\b(\d+)(st|nd|rd|th)\b", re.IGNORECASE)


def expand_text(text: str) -> str:
    """Expand digits, ordinals, % and & into words (reference role: espeak
    does this internally during phonemization)."""
    text = _MONEY_RE.sub(lambda m: m.group(1) + " dollars", text)
    text = _ORD_RE.sub(lambda m: ordinal_to_words(int(m.group(1))), text)

    def _num(m):
        s = m.group(0).replace(",", "")
        if "." in s:
            intpart, frac = s.split(".", 1)
            words = number_to_words(int(intpart)) + " point " + " ".join(
                _ONES[int(d)] for d in frac
            )
        else:
            words = number_to_words(int(s))
        return words

    text = _NUM_RE.sub(_num, text)
    text = text.replace("%", " percent").replace("&", " and ")
    return text


_MONEY_RE = re.compile(r"\$\s*(\d[\d,]*(\.\d+)?)")


_WORD_RE = re.compile(r"[a-zA-Z']+")


def phonemize_english(text: str) -> str:
    """Full sentence -> IPA phoneme string (words separated by spaces).

    Abbreviation expansion happens only on `<abbr>.`-style tokens via the
    word path (periods are sentence punctuation upstream)."""
    text = expand_text(text)
    out = []
    for m in _WORD_RE.finditer(text):
        w = m.group(0).strip("'")
        if not w:
            continue
        wl = w.lower()
        if wl in _ABBREV and wl not in LEXICON:
            out.extend(g2p_word(p) for p in _ABBREV[wl].split())
        else:
            out.append(g2p_word(w))
    return " ".join(p for p in out if p)
