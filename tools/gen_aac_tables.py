"""Generate native/aac_tables.inc from hpfw_jax/io/_aac_tables.py.

Same house rule as tools/gen_mpeg_tables.py: the probe-recovered Python
tables are the source of truth; the C++ twin's include is GENERATED and
never edited by hand.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpfw_jax.io._aac_tables import (SF_BOOK, SPEC_BOOKS, SWB_LONG,
                                     SWB_SHORT)
from hpfw_jax.io.aac import (ADTS_RATES, TNS_MAX_BANDS_LONG,
                             TNS_MAX_BANDS_SHORT)


def main():
    out = os.path.join(os.path.dirname(__file__), "..", "native",
                       "aac_tables.inc")
    with open(out, "w") as f:
        f.write("// GENERATED by tools/gen_aac_tables.py from\n"
                "// hpfw_jax/io/_aac_tables.py (probe-recovered, certified"
                " tables).\n// Do not edit.\n\n")
        f.write("static const int kAacRates[12] = {%s};\n\n"
                % ", ".join(str(r) for r in ADTS_RATES))

        for name, table in (("kSwbLong", SWB_LONG), ("kSwbShort", SWB_SHORT)):
            maxlen = max(len(v) for v in table.values())
            f.write(f"static const int {name}Count[12] = {{%s}};\n"
                    % ", ".join(str(len(table[r]) - 1) for r in ADTS_RATES))
            f.write(f"static const int {name}[12][{maxlen}] = {{\n")
            for r in ADTS_RATES:
                v = list(table[r]) + [0] * (maxlen - len(table[r]))
                f.write("  {%s},\n" % ", ".join(str(x) for x in v))
            f.write("};\n\n")

        for name, table in (("kTnsMaxLong", TNS_MAX_BANDS_LONG),
                            ("kTnsMaxShort", TNS_MAX_BANDS_SHORT)):
            f.write(f"static const int {name}[12] = {{%s}};\n"
                    % ", ".join(str(table[r]) for r in ADTS_RATES))
        f.write("\n")

        # Scalefactor codebook: (length, code, delta) triplets.
        rows = sorted(((ln, code, delta)
                       for (ln, code), delta in SF_BOOK.items()))
        f.write(f"static const int kSfBookN = {len(rows)};\n")
        f.write("static const int kSfBook[][3] = {\n")
        for ln, code, delta in rows:
            f.write(f"  {{{ln}, {code}, {delta}}},\n")
        f.write("};\n\n")

        # Spectral codebooks: per book, (length, code, v0..v3) rows
        # (pairs pad v2/v3 with 0; dims/signed are structural constants).
        f.write("static const int kSpecDims[12] = "
                "{0, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2};\n")
        f.write("static const int kSpecSigned[12] = "
                "{0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0};\n")
        for cb in range(1, 12):
            book = SPEC_BOOKS[cb]
            rows = sorted(((ln, code) + tuple(vals) + (0,) * (4 - len(vals))
                           for (ln, code), vals in book.items()))
            f.write(f"static const int kSpecBook{cb}N = {len(rows)};\n")
            f.write(f"static const int kSpecBook{cb}[][6] = {{\n")
            for row in rows:
                f.write("  {%s},\n" % ", ".join(str(x) for x in row))
            f.write("};\n")
        f.write("\nstatic const int* kSpecBooks[12] = {nullptr, "
                + ", ".join(f"&kSpecBook{cb}[0][0]" for cb in range(1, 12))
                + "};\n")
        f.write("static const int kSpecBookN[12] = {0, "
                + ", ".join(f"kSpecBook{cb}N" for cb in range(1, 12))
                + "};\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
