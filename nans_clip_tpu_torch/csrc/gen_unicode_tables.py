"""Generate unicode_tables.inc for the C++ tokenizer.

The C++ tokenizer must match the Python tokenizer (and thus Google BERT's)
byte-for-byte. Its Unicode behavior comes from CPython's unicodedata:
category ranges (whitespace/control/punct/Mn), per-codepoint lowercase
mappings, and full NFD decompositions. Rather than approximate them in C++,
this script dumps exact tables from the running CPython.
"""

import sys
import unicodedata

MAX_CP = 0x110000


def ranges_from_pred(pred):
    ranges = []
    start = None
    for cp in range(MAX_CP):
        try:
            ch = chr(cp)
        except ValueError:
            ok = False
        else:
            ok = pred(ch)
        if ok and start is None:
            start = cp
        elif not ok and start is not None:
            ranges.append((start, cp - 1))
            start = None
    if start is not None:
        ranges.append((start, MAX_CP - 1))
    return ranges


def is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def is_punct(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def is_mn(ch):
    return unicodedata.category(ch) == "Mn"


def is_cased(ch):
    # Unicode Cased property as CPython's casing rules see it:
    # Lu/Ll/Lt plus Other_{Upper,Lower}case (str.isupper/islower flags)
    return ch.isupper() or ch.islower() or unicodedata.category(ch) == "Lt"


# Word_Break MidLetter/MidNumLet/Single_Quote members of Case_Ignorable
_CASE_IGN_EXTRA = {0x27, 0x2E, 0x3A, 0xB7, 0x387, 0x5F4, 0x2018, 0x2019,
                   0x2024, 0x2027, 0xFE13, 0xFE52, 0xFE55, 0xFF07, 0xFF0E,
                   0xFF1A}


def is_case_ignorable(ch):
    # Case_Ignorable ~= categories Mn/Me/Cf/Lm/Sk + the word-break
    # punctuation members (good to the precision the Final_Sigma rule
    # needs in running text)
    if ord(ch) in _CASE_IGN_EXTRA:
        return True
    return unicodedata.category(ch) in ("Mn", "Me", "Cf", "Lm", "Sk")


def is_pyspace(ch):
    return ch.isspace()


def main(out_path):
    lower_entries = []   # (cp, [lowered cps])
    for cp in range(MAX_CP):
        ch = chr(cp)
        low = ch.lower()
        if low != ch:
            lower_entries.append((cp, [ord(c) for c in low]))

    nfd_entries = []     # (cp, [decomposed cps]) where NFD(ch) != ch
    for cp in range(MAX_CP):
        ch = chr(cp)
        d = unicodedata.normalize("NFD", ch)
        if d != ch:
            nfd_entries.append((cp, [ord(c) for c in d]))

    tables = {
        "WHITESPACE": ranges_from_pred(is_whitespace),
        "CONTROL": ranges_from_pred(is_control),
        "PUNCT": ranges_from_pred(is_punct),
        "MN": ranges_from_pred(is_mn),
        "CASED": ranges_from_pred(is_cased),
        "CASEIGN": ranges_from_pred(is_case_ignorable),
        "PYSPACE": ranges_from_pred(is_pyspace),
    }

    with open(out_path, "w") as f:
        f.write("// Auto-generated by gen_unicode_tables.py — do not edit.\n")
        f.write(f"// python {sys.version.split()[0]}, unicodedata "
                f"{unicodedata.unidata_version}\n\n")
        for name, ranges in tables.items():
            f.write(f"static const uint32_t k{name.title()}Ranges[][2] = {{\n")
            for lo, hi in ranges:
                f.write(f"  {{{lo}, {hi}}},\n")
            f.write("};\n")
            f.write(f"static const size_t k{name.title()}Count = {len(ranges)};\n\n")

        # mapping tables: flat arrays of (cp, offset, len) into a pool
        for name, entries in (("Lower", lower_entries), ("Nfd", nfd_entries)):
            pool = []
            f.write(f"static const uint32_t k{name}Keys[] = {{\n  ")
            f.write(", ".join(str(cp) for cp, _ in entries))
            f.write("\n};\n")
            offsets = []
            for _, seq in entries:
                offsets.append((len(pool), len(seq)))
                pool.extend(seq)
            f.write(f"static const uint32_t k{name}Offsets[][2] = {{\n  ")
            f.write(", ".join(f"{{{o}, {l}}}" for o, l in offsets))
            f.write("\n};\n")
            f.write(f"static const uint32_t k{name}Pool[] = {{\n  ")
            f.write(", ".join(str(c) for c in pool) or "0")
            f.write("\n};\n")
            f.write(f"static const size_t k{name}Count = {len(entries)};\n\n")
    print(f"wrote {out_path}: lower={len(lower_entries)} nfd={len(nfd_entries)} "
          + " ".join(f"{k}={len(v)}" for k, v in tables.items()))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "unicode_tables.inc")
