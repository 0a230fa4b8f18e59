"""Extended grapheme clusters (Unicode UAX #29), for the Precompiled
normalizer (:mod:`.charsmap`).

The Rust ``tokenizers`` library's ``Precompiled`` normalizer looks each
extended grapheme cluster up whole where it is under 6 bytes, and code
point by code point otherwise (``unicode-segmentation``'s clusters). A
cluster of two code points or more is under 6 bytes only where some of
them take one or two bytes, so the rules that matter are the ones such
clusters reach: CR LF (GB3); Control, CR and LF alone (GB4, GB5); Extend,
ZWJ and SpacingMark joined to what precedes them (GB9, GB9a); Prepend
joined to what follows (GB9b); emoji ZWJ sequences (GB11, whose pictographs
include the two-byte (C) and (R)); and the clusters that keep a later
consonant of an Indic conjunct off a cluster of its own (GB9c). The
Hangul (GB6-GB8) and regional-indicator (GB12, GB13) rules join only code
points of three bytes or more; they are kept so that the clusters are
UAX #29's.

Python's :mod:`unicodedata` has no Grapheme_Cluster_Break: the classes are
built from general categories and explicit ranges, and corrected where
the Rust library's tables (Unicode 16) differ from Unicode
``UNIDATA_VERSION``'s categories (``_EXTEND_EXTRA``, ``_SPACING_EXTRA``,
``_PREPEND_EXTRA``).
:func:`clusters` maps each code point to its class's letter and runs
UAX #29's regular expression (table 1b) over the letters. ``tests/test_torch_etl_unigram.py`` sweeps every code point
through probes of each rule against the installed ``tokenizers``; rerun
that sweep to take the tables anew.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from typing import Dict, List, Tuple

# the Unicode database (``unicodedata.unidata_version``) that the tables
# below correct
UNIDATA_VERSION = "15.0.0"


def _ranges(*pairs) -> frozenset:
    return frozenset(c for lo, hi in pairs for c in range(lo, hi + 1))


# Prepended_Concatenation_Mark and the other Prepend code points
PREPEND = _ranges(
    (0x600, 0x605), (0x6DD, 0x6DD), (0x70F, 0x70F), (0x890, 0x891),
    (0x8E2, 0x8E2), (0xD4E, 0xD4E), (0x110BD, 0x110BD), (0x110CD, 0x110CD),
    (0x111C2, 0x111C3), (0x1193F, 0x1193F), (0x11941, 0x11941),
    (0x11A3A, 0x11A3A), (0x11A84, 0x11A89), (0x11D46, 0x11D46),
    (0x11F02, 0x11F02))
# Other_Grapheme_Extend (spacing marks and others that extend) and the
# Emoji_Modifier skin tones
_OTHER_EXTEND = _ranges(
    (0x9BE, 0x9BE), (0x9D7, 0x9D7), (0xB3E, 0xB3E), (0xB57, 0xB57),
    (0xBBE, 0xBBE), (0xBD7, 0xBD7), (0xCC2, 0xCC2), (0xCD5, 0xCD6),
    (0xD3E, 0xD3E), (0xD57, 0xD57), (0xDCF, 0xDCF), (0xDDF, 0xDDF),
    (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F), (0xFF9E, 0xFF9F),
    (0x1133E, 0x1133E), (0x11357, 0x11357), (0x114B0, 0x114B0),
    (0x114BD, 0x114BD), (0x115AF, 0x115AF), (0x11930, 0x11930),
    (0x1D165, 0x1D165), (0x1D16E, 0x1D172), (0xE0020, 0xE007F),
    (0x1F3FB, 0x1F3FF))
# spacing marks (Mc) that are not SpacingMark, and two letters that are
_MC_NOT_SPACING = _ranges(
    (0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D),
    (0x1083, 0x1083), (0x1087, 0x108C), (0x108F, 0x108F), (0x109A, 0x109C),
    (0x1A61, 0x1A61), (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
    (0x11720, 0x11721))
_SPACING_LETTERS = _ranges((0xE33, 0xE33), (0xEB3, 0xEB3))
# default-ignorable code points unassigned in UNIDATA_VERSION: Control
_IGNORABLE_UNASSIGNED = _ranges(
    (0x2065, 0x2065), (0xFFF0, 0xFFF8), (0xE0000, 0xE0000),
    (0xE0002, 0xE001F), (0xE0080, 0xE00FF), (0xE01F0, 0xE0FFF))
ZWJ, ZWNJ = 0x200D, 0x200C
REGIONAL = _ranges((0x1F1E6, 0x1F1FF))
# Extended_Pictographic (emoji-data.txt)
PICTOGRAPHIC = _ranges(
    (0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))
# Indic_Conjunct_Break: the viramas that link, and the consonants they
# link (Devanagari, Bengali, Gujarati, Oriya, Telugu, Malayalam)
LINKERS = _ranges(
    (0x94D, 0x94D), (0x9CD, 0x9CD), (0xACD, 0xACD), (0xB4D, 0xB4D),
    (0xC4D, 0xC4D), (0xD4D, 0xD4D))
CONSONANTS = _ranges(
    (0x915, 0x939), (0x958, 0x95F), (0x978, 0x97F), (0x995, 0x9A8),
    (0x9AA, 0x9B0), (0x9B2, 0x9B2), (0x9B6, 0x9B9), (0x9DC, 0x9DD),
    (0x9DF, 0x9DF), (0x9F0, 0x9F1), (0xA95, 0xAA8), (0xAAA, 0xAB0),
    (0xAB2, 0xAB3), (0xAB5, 0xAB9), (0xAF9, 0xAF9), (0xB15, 0xB28),
    (0xB2A, 0xB30), (0xB32, 0xB33), (0xB35, 0xB39), (0xB5C, 0xB5D),
    (0xB5F, 0xB5F), (0xB71, 0xB71), (0xC15, 0xC28), (0xC2A, 0xC39),
    (0xC58, 0xC5A), (0xD15, 0xD3A))
# Hangul jamo and syllables
_HANGUL_L = _ranges((0x1100, 0x115F), (0xA960, 0xA97C))
_HANGUL_V = _ranges((0x1160, 0x11A7), (0xD7B0, 0xD7C6))
_HANGUL_T = _ranges((0x11A8, 0x11FF), (0xD7CB, 0xD7FB))
_SYLLABLES = (0xAC00, 0xD7A3)

# where the Rust library's tables (a newer Unicode) differ from the
# classes that UNIDATA_VERSION's categories give
_EXTEND_EXTRA = _ranges(
    (0x897, 0x897), (0xCC0, 0xCC0), (0xCC7, 0xCC8), (0xCCA, 0xCCB),
    (0x1715, 0x1715), (0x1734, 0x1734), (0x1B3B, 0x1B3B), (0x1B3D, 0x1B3D),
    (0x1B43, 0x1B44), (0x1BAA, 0x1BAA), (0x1BF2, 0x1BF3), (0xA953, 0xA953),
    (0xA9C0, 0xA9C0), (0x10D69, 0x10D6D), (0x10EFC, 0x10EFC),
    (0x111C0, 0x111C0), (0x11235, 0x11235), (0x1134D, 0x1134D),
    (0x113B8, 0x113B8), (0x113BB, 0x113C0), (0x113C2, 0x113C2),
    (0x113C5, 0x113C5), (0x113C7, 0x113C9), (0x113CE, 0x113D0),
    (0x113D2, 0x113D2), (0x113E1, 0x113E2), (0x116B6, 0x116B6),
    (0x1193D, 0x1193D), (0x11F41, 0x11F41),
    (0x11F5A, 0x11F5A), (0x1611E, 0x16129), (0x1612D, 0x1612F),
    (0x16FF0, 0x16FF1), (0x1D166, 0x1D166), (0x1D16D, 0x1D16D),
    (0x1E5EE, 0x1E5EF))
_SPACING_EXTRA = _ranges(
    (0x113B9, 0x113BA), (0x113CA, 0x113CA), (0x113CC, 0x113CD),
    (0x1171E, 0x1171E), (0x1612A, 0x1612C))
_PREPEND_EXTRA = _ranges((0x113D1, 0x113D1))


def _class_of(cp: int) -> str:
    """The Grapheme_Cluster_Break class of ``cp`` (``Other`` for none), with
    the Indic consonants as ``Consonant``."""
    if cp == 0x0D:
        return "CR"
    if cp == 0x0A:
        return "LF"
    if cp == ZWJ:
        return "ZWJ"
    if cp == ZWNJ:       # Extend, and none of a conjunct's
        return "ZWNJ"
    if cp in PREPEND or cp in _PREPEND_EXTRA:
        return "Prepend"
    if cp in _IGNORABLE_UNASSIGNED:
        return "Control"
    if cp in _EXTEND_EXTRA or cp in _OTHER_EXTEND:
        return "Linker" if cp in LINKERS else "Extend"
    if cp in _SPACING_EXTRA or cp in _SPACING_LETTERS:
        return "SpacingMark"
    category = unicodedata.category(chr(cp))
    if category in ("Cc", "Zl", "Zp", "Cf"):
        return "Control"
    if category in ("Mn", "Me"):
        return "Linker" if cp in LINKERS else "Extend"
    if category == "Mc" and cp not in _MC_NOT_SPACING:
        return "SpacingMark"
    if cp in REGIONAL:
        return "RI"
    if cp in PICTOGRAPHIC:
        return "ExtPict"
    if cp in CONSONANTS:
        return "Consonant"
    if cp in _HANGUL_L:
        return "L"
    if cp in _HANGUL_V:
        return "V"
    if cp in _HANGUL_T:
        return "T"
    if _SYLLABLES[0] <= cp <= _SYLLABLES[1]:
        return "LV" if (cp - _SYLLABLES[0]) % 28 == 0 else "LVT"
    return "Other"


@functools.lru_cache(maxsize=None)
def classes() -> Dict[str, List[Tuple[int, int]]]:
    """The code point ranges of each class of :func:`_class_of`
    (surrogates left out)."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    start, current = 0, _class_of(0)
    for cp in range(1, 0x110001):
        if 0xD800 <= cp <= 0xDFFF:
            kind = "surrogate"
        else:
            kind = _class_of(cp) if cp < 0x110000 else None
        if kind != current:
            out.setdefault(current, []).append((start, cp - 1))
            start, current = cp, kind
    out.pop("surrogate", None)
    return out


# one letter per class
LETTERS = {"CR": "C", "LF": "F", "Control": "X", "Extend": "E",
           "Linker": "K", "ZWNJ": "N", "ZWJ": "Z", "SpacingMark": "S",
           "Prepend": "P", "RI": "R", "ExtPict": "I", "Consonant": "O",
           "L": "L", "V": "V", "T": "T", "LV": "W", "LVT": "Y",
           "Other": "o"}
# UAX #29's extended grapheme cluster (table 1b, with GB9c's conjuncts)
# over the letters
CLUSTER = re.compile(
    "CF|[CFX]|P*(?:L*(?:V+|WV*|Y)T*|L+|T+|RR|I(?:[EKN]*ZI)*"
    "|O(?:[EKZ]*K[EKZ]*O)+|[^CFX])[EKNZS]*")


@functools.lru_cache(maxsize=None)
def letter_table() -> List[str]:
    """``str.translate``'s table: the letter in ``LETTERS`` of each code
    point's class, by code point."""
    table = ["o"] * 0x110000
    for kind, ranges in classes().items():
        for lo, hi in ranges:
            table[lo:hi + 1] = [LETTERS[kind]] * (hi + 1 - lo)
    return table


def clusters(text: str) -> List[str]:
    """``text``'s extended grapheme clusters, in order."""
    out = []
    start = 0
    for part in CLUSTER.findall(text.translate(letter_table())):
        end = start + len(part)
        out.append(text[start:end])
        start = end
    return out
