"""Self-contained German G2P (no espeak / network dependency).

Role: extends the reference's espeak frontend coverage
(the reference optispeech/text/tokenizers.py:84-98 phonemizes any espeak
language) to German without the piper_phonemize C++ binding, following the
same pattern as the English module (text/english.py): a small exception
lexicon for function words / irregulars / loanwords plus a context-sensitive
letter-to-sound scanner. German orthography is far more regular than English,
so the rule core is compact:

- vowel length from orthography: doubled vowel, vowel+h, and ``ie`` are long;
  a vowel before a doubled consonant or a 2+ consonant cluster is short; an
  open syllable (single consonant then vowel) is long,
- diphthongs ei/ai -> aɪ, au -> aʊ, eu/äu -> ɔʏ,
- ``ch`` is ç after front vowels/consonants (ich-Laut) and x after back
  vowels (ach-Laut); ``-ig`` word-finally -> ɪç,
- Auslautverhärtung: b/d/g devoice to p/t/k in coda position,
- s is voiced (z) before a vowel, ``sp``/``st`` word-initially -> ʃp/ʃt,
- r is ʁ before a vowel, vocalised to ɐ in coda; final ``-er`` -> ɐ,
- unstressed e -> ə in final syllables and the unstressed prefixes
  be-/ge-/ver-/zer-/er-/ent-/emp-, which also shift primary stress to the
  stem (otherwise German stresses the first syllable).

Every emitted character is in symbols.SYMBOL_TO_ID (the espeak-compatible
IPA inventory), so ``de-g2p`` output feeds the same embedding table as the
other frontends.
"""

import re

VOWELS = "aeiouäöüy"

# --------------------------------------------------------------------------
# Exception lexicon: IPA directly (stress ˈ before the stressed vowel).
# Function words, irregulars, common loanwords the rules would mangle.
# --------------------------------------------------------------------------

LEXICON = {
    # articles / pronouns
    "der": "dˈeːɐ", "die": "dˈiː", "das": "dˈas", "den": "dˈeːn",
    "dem": "dˈeːm", "des": "dˈɛs", "ein": "ˈaɪn", "eine": "ˈaɪnə",
    "einen": "ˈaɪnən", "einem": "ˈaɪnəm", "einer": "ˈaɪnɐ",
    "ich": "ˈɪç", "du": "dˈuː", "er": "ˈeːɐ", "sie": "zˈiː", "es": "ˈɛs",
    "wir": "vˈiːɐ", "ihr": "ˈiːɐ", "mich": "mˈɪç", "dich": "dˈɪç",
    "sich": "zˈɪç", "uns": "ˈʊns", "euch": "ˈɔʏç", "mir": "mˈiːɐ",
    "dir": "dˈiːɐ", "ihm": "ˈiːm", "ihn": "ˈiːn", "ihnen": "ˈiːnən",
    "mein": "mˈaɪn", "dein": "dˈaɪn", "sein": "zˈaɪn", "ihre": "ˈiːʁə",
    "unser": "ˈʊnzɐ", "euer": "ˈɔʏɐ",
    # auxiliaries / modals
    "bin": "bˈɪn", "bist": "bˈɪst", "ist": "ˈɪst", "sind": "zˈɪnt",
    "seid": "zˈaɪt", "war": "vˈaːɐ", "waren": "vˈaːʁən", "sei": "zˈaɪ",
    "habe": "hˈaːbə", "hast": "hˈast", "hat": "hˈat", "haben": "hˈaːbən",
    "hatte": "hˈatə", "wird": "vˈɪɐt", "werden": "vˈeːɐdən",
    "wurde": "vˈʊɐdə", "kann": "kˈan", "können": "kˈœnən",
    "muss": "mˈʊs", "müssen": "mˈʏsən", "soll": "zˈɔl", "will": "vˈɪl",
    "wollen": "vˈɔlən", "darf": "dˈaɐf", "mag": "mˈaːk",
    "möchte": "mˈœçtə",
    # prepositions / conjunctions / adverbs
    "und": "ˈʊnt", "oder": "ˈoːdɐ", "aber": "ˈaːbɐ", "auch": "ˈaʊx",
    "nicht": "nˈɪçt", "kein": "kˈaɪn", "mit": "mˈɪt", "von": "fˈɔn",
    "zu": "tsˈuː", "zum": "tsˈʊm", "zur": "tsˈuːɐ", "im": "ˈɪm",
    "am": "ˈam", "um": "ˈʊm", "an": "ˈan", "auf": "ˈaʊf", "aus": "ˈaʊs",
    "bei": "bˈaɪ", "nach": "nˈaːx", "vor": "fˈoːɐ", "über": "ˈyːbɐ",
    "unter": "ˈʊntɐ", "durch": "dˈʊɐç", "für": "fˈyːɐ", "ohne": "ˈoːnə",
    "bis": "bˈɪs", "wenn": "vˈɛn", "als": "ˈals", "wie": "vˈiː",
    "wo": "vˈoː", "was": "vˈas", "wer": "vˈeːɐ", "warum": "vaʁˈʊm",
    "dass": "dˈas", "denn": "dˈɛn", "doch": "dˈɔx", "noch": "nˈɔx",
    "nur": "nˈuːɐ", "schon": "ʃˈoːn", "sehr": "zˈeːɐ", "hier": "hˈiːɐ",
    "dort": "dˈɔɐt", "heute": "hˈɔʏtə", "morgen": "mˈɔɐɡən",
    "gestern": "ɡˈɛstɐn", "immer": "ˈɪmɐ", "wieder": "vˈiːdɐ",
    "jetzt": "jˈɛtst", "dann": "dˈan", "ja": "jˈaː", "nein": "nˈaɪn",
    # irregular spellings / loanwords
    "vier": "fˈiːɐ", "viel": "fˈiːl", "viele": "fˈiːlə",
    "familie": "famˈiːliə", "nation": "natsiˈoːn",
    "chef": "ʃˈɛf", "chance": "ʃˈãːsə".replace("ã", "a"),  # nasal not in inventory
    "computer": "kɔmpjˈuːtɐ", "baby": "bˈeːbi", "genau": "ɡənˈaʊ",
    "orange": "oʁˈaŋʒə", "garage": "ɡaʁˈaːʒə", "etage": "etˈaːʒə",
    "restaurant": "ʁɛstoʁˈaŋ", "café": "kafˈeː", "cafe": "kafˈeː",
    "taxi": "tˈaksi", "s": "ˈɛs",
    # morpheme boundaries / prefix lookalikes the rules cannot see
    "mädchen": "mˈɛːtçən", "geben": "ɡˈeːbən", "gehen": "ɡˈeːən",
    "gegen": "ɡˈeːɡən", "gerne": "ɡˈɛɐnə", "gelb": "ɡˈɛlp",
    "geld": "ɡˈɛlt", "gerade": "ɡəʁˈaːdə", "erst": "ˈeːɐst",
    "erste": "ˈeːɐstə", "ersten": "ˈeːɐstən", "erster": "ˈeːɐstɐ",
    "ernst": "ˈɛɐnst", "berg": "bˈɛɐk", "hoch": "hˈoːx",
    "sprache": "ʃpʁˈaːxə", "verb": "vˈɛɐp", "werden": "vˈeːɐdən",
}

# unstressed verb/noun prefixes: shift primary stress to the stem
UNSTRESSED_PREFIXES = ("be", "ge", "ent", "emp", "er", "ver", "zer")

# --------------------------------------------------------------------------
# number expansion (0 .. 999_999)
# --------------------------------------------------------------------------

_ONES = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
         "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
         "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn"]
_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
         "siebzig", "achtzig", "neunzig"]


def number_to_german(n: int) -> str:
    if n < 0:
        return "minus " + number_to_german(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        if o == 0:
            return _TENS[t]
        one = "ein" if o == 1 else _ONES[o]
        return f"{one}und{_TENS[t]}"
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("ein" if h == 1 else _ONES[h]) + "hundert"
        return head + (number_to_german(r) if r else "")
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        head = ("ein" if k == 1 else number_to_german(k)) + "tausend"
        return head + (number_to_german(r) if r else "")
    return " ".join(number_to_german(int(d)) for d in str(n))


# --------------------------------------------------------------------------
# rule engine
# --------------------------------------------------------------------------

def _is_vowel(ch: str) -> bool:
    return ch in VOWELS


_FRONT = set("eiäöüy")  # ich-Laut context


def _vowel_long(word: str, i: int, vlen: int) -> bool:
    """Length of the vowel group starting at i (vlen letters): long iff
    doubled / +h / open syllable / single final consonant; short before
    clusters, geminates, and the -ig / -tion suffixes."""
    j = i + vlen
    if j < len(word) and word[j] == "h":
        return True  # Dehnungs-h (Jahr, sehen)
    # count following consonant letters up to the next vowel
    k = j
    while k < len(word) and not _is_vowel(word[k]):
        k += 1
    ncons = k - j
    if ncons == 0:
        return True  # word-final vowel (See, Auto)
    cluster = word[j:k]
    if word.startswith("tion", j):
        return False  # Nation, Station: short vowel before -tion
    if ncons >= 2 and cluster[0] == cluster[1]:
        return False  # geminate closes the syllable (Mann, kommen)
    if cluster[:2] in ("ck", "tz"):
        return False  # orthographic geminates
    if cluster[:2] == "ch":
        # length before bare ch is lexical; u/ü/i are regularly long (Buch,
        # Bücher, suchen), a/o/e regularly short (machen, Loch). ch inside a
        # bigger cluster (richtig, Nacht) always closes the syllable.
        return len(cluster) == 2 and word[i] in "uüi"
    if ncons == 1 and k < len(word):
        return True  # open syllable: single consonant then vowel (Name)
    if ncons == 1 and k == len(word):
        if word[i] == "i" and word[j] == "g":
            return False  # -ig -> ɪç
        return True  # Tag, grün, schön
    if word[i] == "e" and cluster[0] == "r":
        return True  # e before r+consonant: Pferd, werden, erste
    return False


_SHORT = {"a": "a", "e": "ɛ", "i": "ɪ", "o": "ɔ", "u": "ʊ",
          "ä": "ɛ", "ö": "œ", "ü": "ʏ", "y": "ʏ"}
_LONG = {"a": "aː", "e": "eː", "i": "iː", "o": "oː", "u": "uː",
         "ä": "ɛː", "ö": "øː", "ü": "yː", "y": "yː"}


def _g2p_word(word: str) -> list[str]:
    """One lowercase alphabetic word -> list of IPA phones (no stress yet)."""
    w = word
    out: list[str] = []
    i = 0
    n = len(w)

    def prev_front() -> bool:
        """ich- vs ach-Laut: ç unless the preceding phone is a back vowel."""
        for ph in reversed(out):
            if ph in ("aː", "a", "ɔ", "oː", "ʊ", "uː", "aʊ"):
                return False
            if ph[0] in "aeiouyɐəɛɪœøʏ" or ph in ("aɪ", "ɔʏ"):
                return True
        return True  # word-initial / after consonant (Milch, China)

    while i < n:
        c = w[i]
        rest = w[i:]
        nxt = w[i + 1] if i + 1 < n else ""

        # --- multi-letter consonant graphemes -------------------------------
        if rest.startswith("sch"):
            out.append("ʃ"); i += 3; continue
        if rest.startswith("tsch"):
            out += ["t", "ʃ"]; i += 4; continue
        if rest.startswith("chs"):
            out += ["k", "s"]; i += 3; continue
        if rest.startswith("ch"):
            out.append("ç" if prev_front() else "x"); i += 2; continue
        if rest.startswith("ck"):
            out.append("k"); i += 2; continue
        if rest.startswith("ph"):
            out.append("f"); i += 2; continue
        if rest.startswith("th"):
            out.append("t"); i += 2; continue
        if rest.startswith("qu"):
            out += ["k", "v"]; i += 2; continue
        if rest.startswith("tz"):
            out += ["t", "s"]; i += 2; continue
        if rest.startswith("ng"):
            out.append("ŋ"); i += 2; continue
        if rest.startswith("pf"):
            out += ["p", "f"]; i += 2; continue
        if rest.startswith("sp") and i == 0:
            out += ["ʃ", "p"]; i += 2; continue
        if rest.startswith("st") and i == 0:
            out += ["ʃ", "t"]; i += 2; continue
        if rest.startswith("tion"):  # -tion -> tsioːn
            out += ["t", "s", "i", "oː", "n"]; i += 4; continue
        if c == "ß":
            out.append("s"); i += 1; continue

        # --- diphthongs -----------------------------------------------------
        if rest.startswith("ei") or rest.startswith("ai") or rest.startswith("ay") or rest.startswith("ey"):
            out.append("aɪ"); i += 2; continue
        if rest.startswith("au"):
            out.append("aʊ"); i += 2; continue
        if rest.startswith("eu") or rest.startswith("äu"):
            out.append("ɔʏ"); i += 2; continue
        if rest.startswith("ie"):
            out.append("iː")
            i += 2
            if i < n and w[i] == "h":  # zieht
                i += 1
            continue

        # --- vowels ---------------------------------------------------------
        if _is_vowel(c):
            vlen = 2 if (nxt == c) else 1  # doubled vowel (Meer, Boot)
            # unstressed e in the word-final syllable reduces: -e, -en, -el,
            # -end, -es ... -> ə; -er (coda) -> ɐ. Only when an earlier
            # syllable carries a full vowel (so "geht" keeps eː).
            if (c == "e" and vlen == 1
                    and not any(_is_vowel(ch) for ch in w[i + 1:])
                    and any(p[0] in "aeiouyɐɛɪœøʏʊɔ" or p in ("aɪ", "aʊ", "ɔʏ")
                            for p in out)):
                if i == n - 2 and w[-1] == "r":
                    out.append("ɐ"); i += 2; continue  # -er -> ɐ (eats the r)
                out.append("ə"); i += 1; continue
            long = vlen == 2 or _vowel_long(w, i, vlen)
            out.append(_LONG[c] if long else _SHORT[c])
            i += vlen
            # Dehnungs-h is silent (Jahr, Uhr, sehen) — but a stem-initial h
            # right after an unstressed prefix is spoken (ge-heim, er-holen)
            if (long and i < n and w[i] == "h"
                    and not any(w[:i] == p for p in UNSTRESSED_PREFIXES)):
                i += 1
            continue

        # --- single consonants ---------------------------------------------
        if c in "bdg":
            if nxt == c:  # geminate
                nxt = w[i + 2] if i + 2 < n else ""
                i += 1
            # Auslautverhärtung: coda (end or before a consonant that is not
            # l/r in an onset cluster) devoices
            coda = (i + 1 == n) or (not _is_vowel(nxt) and nxt not in "lr")
            if c == "g" and i + 1 == n and i >= 1 and w[i - 1] == "i":
                # -ig -> ɪç: rewrite the just-emitted ɪ stays; emit ç
                out.append("ç"); i += 1; continue
            out.append({"b": "p", "d": "t", "g": "k"}[c] if coda
                       else {"b": "b", "d": "d", "g": "ɡ"}[c])
            i += 1; continue
        if c == "s":
            if nxt == "s":  # ss geminate: always voiceless
                out.append("s"); i += 2; continue
            voiced = i + 1 < n and _is_vowel(nxt)
            out.append("z" if voiced else "s"); i += 1; continue
        if c == "v":
            out.append("f"); i += 1; continue
        if c == "w":
            out.append("v"); i += 1; continue
        if c == "z":
            out += ["t", "s"]; i += 1; continue
        if c == "j":
            out.append("j"); i += 1; continue
        if c == "c":  # rare outside digraphs: hard k (Clown)
            out.append("k"); i += 1; continue
        if c == "r":
            step = 2 if nxt == "r" else 1  # geminate (Herr)
            after = w[i + step] if i + step < n else ""
            if after and _is_vowel(after):
                out.append("ʁ")
            else:
                # vocalised coda r: ɐ offglide
                out.append("ɐ")
            i += step; continue
        if c == "h":
            # onset h is spoken; post-vocalic h was consumed by the vowel rule
            out.append("h"); i += 1; continue
        if c in "fklmnpt":
            out.append(c)
            i += 2 if nxt == c else 1  # collapse geminates (Wetter, kommen)
            continue
        if c == "x":
            out += ["k", "s"]; i += 1; continue
        i += 1  # drop anything else (apostrophes etc.)
    return out


def _stress_word(word: str, phones: list[str]) -> list[str]:
    """Primary stress before the first full stem vowel (German default);
    -tion words stress the suffix vowel. Prefix destressing happens in
    _word_ipa (the prefix is rewritten and the stem stressed on its own)."""
    if not phones:
        return phones
    vowel_idx = [k for k, ph in enumerate(phones)
                 if ph[0] in "aeiouyɐəɛɪœøʏʊɔ" or ph in ("aɪ", "aʊ", "ɔʏ")]
    if not vowel_idx:
        return phones
    target = len(vowel_idx) - 1 if word.endswith("tion") else 0
    # never stress a schwa/ɐ if an alternative exists
    while target < len(vowel_idx) - 1 and phones[vowel_idx[target]] in ("ə", "ɐ"):
        target += 1
    k = vowel_idx[target]
    return phones[:k] + ["ˈ"] + phones[k:]


_TOKEN_RE = re.compile(r"[a-zäöüß]+(?:'[a-zäöüß]+)?|\d+|[^\sa-zäöüß\d]+")


def phonemize_german(text: str) -> str:
    """German text -> IPA string in the shared symbol inventory.

    Words run through the lexicon, then the rule engine; numbers are expanded
    to words first; punctuation known to the inventory passes through."""
    from .symbols import SYMBOL_TO_ID

    out: list[str] = []
    for tok in _TOKEN_RE.findall(text.lower()):
        if tok.isdigit():
            num = int(tok) if len(tok) <= 6 else None
            words = (number_to_german(num).replace("und", " und ").split()
                     if num is not None else [])
            # number words are regular compounds; phonemize each part
            for wpart in (words or [tok]):
                if wpart.isdigit():
                    continue
                out.append(_word_ipa(wpart))
            continue
        if tok[0].isalpha() or "'" in tok:
            out.append(_word_ipa(tok.replace("'", "")))
        else:
            kept = "".join(ch for ch in tok if ch in SYMBOL_TO_ID)
            if kept:
                out.append(kept)
    ipa = " ".join(out)
    return "".join(ch for ch in ipa if ch in SYMBOL_TO_ID or ch == " ").strip()


# unstressed prefixes rewrite to fixed reduced phones and shift stress to
# the stem (which is scanned as its own word, so e.g. ver|stehen gets the
# word-initial st -> ʃt rule)
PREFIX_IPA = {"be": "bə", "ge": "ɡə", "ent": "ɛnt", "emp": "ɛmp",
              "er": "ɐ", "ver": "fɐ", "zer": "tsɐ"}


def _word_ipa(word: str) -> str:
    hit = LEXICON.get(word)
    if hit is not None:
        return hit
    for pref in sorted(PREFIX_IPA, key=len, reverse=True):
        stem = word[len(pref):]
        if (word.startswith(pref) and len(stem) >= 3
                and any(_is_vowel(ch) for ch in stem)
                # be-/ge- before i/u would more often be a diphthong
                # spelling (beide, Geist) than a prefix
                and not (pref in ("be", "ge") and stem[0] in "iu")):
            return PREFIX_IPA[pref] + "".join(_stress_word(stem, _g2p_word(stem)))
    return "".join(_stress_word(word, _g2p_word(word)))
