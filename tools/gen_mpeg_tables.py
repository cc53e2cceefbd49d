"""Generate native/mpeg_tables.inc from the recovered MPEG-1 tables.

The C++ MP3 twin (native/hpfw_mp3.cc) must use byte-for-byte the same
constants as the NumPy decoder (io/_mpeg_window.py, io/_mpeg_l2_tables.py,
io/_mp3_huffman.py — recovered from the system reference decoder by
probing). Emitting them from the Python source of truth removes any
transcription risk; the .inc is checked in so the native build does not
depend on Python. Re-run after changing any recovered table:

    python tools/gen_mpeg_tables.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from hpfw_jax.io._mp3_huffman import BIG_VALUE_TABLES, COUNT1_TABLES
from hpfw_jax.io._mp3_layer3 import (_NR_OF_SFB, PRETAB, SFB_LONG,
                                     SFB_LONG_LSF, SFB_SHORT,
                                     SFB_SHORT_LSF, SLEN)
from hpfw_jax.io._mpeg_l2_tables import ALLOC_TABLES, QCLASS, _TRANSLATE
from hpfw_jax.io._mpeg_window import SYNTH_WINDOW

OUT = os.path.join(os.path.dirname(__file__), "..", "native",
                   "mpeg_tables.inc")


def fmt_rows(vals, fmt, per_row=6):
    lines = []
    for i in range(0, len(vals), per_row):
        lines.append("  " + ", ".join(fmt(v) for v in vals[i:i + per_row])
                     + ",")
    return "\n".join(lines)


def main():
    w = []
    w.append("// Generated by tools/gen_mpeg_tables.py — DO NOT EDIT.")
    w.append("// Source of truth: hpfw_jax/io/_mpeg_window.py,")
    w.append("// _mpeg_l2_tables.py, _mp3_huffman.py (probe-recovered; see")
    w.append("// their docstrings for provenance).")
    w.append("")

    # --- synthesis window (float64 exact) ---
    w.append("static const double kSynthWindow[512] = {")
    w.append(fmt_rows(list(SYNTH_WINDOW), lambda v: "%.17g" % v, 4))
    w.append("};")
    w.append("")

    # --- Layer II allocation tables ---
    w.append(f"static const int kL2NumTables = {len(ALLOC_TABLES)};")
    sblimits = [len(t) for t in ALLOC_TABLES]
    w.append("static const int kL2Sblimit[] = {"
             + ", ".join(map(str, sblimits)) + "};")
    nbal_flat, class_off, classes_flat = [], [], []
    table_off = [0]
    for t in ALLOC_TABLES:
        for nbal, classes in t:
            nbal_flat.append(nbal)
            class_off.append(len(classes_flat))
            classes_flat.extend(classes)
        table_off.append(len(nbal_flat))
    w.append("static const int kL2TableOff[] = {"
             + ", ".join(map(str, table_off)) + "};")
    w.append("static const int kL2Nbal[] = {")
    w.append(fmt_rows(nbal_flat, str, 16))
    w.append("};")
    w.append("static const int kL2ClassOff[] = {")
    w.append(fmt_rows(class_off, str, 12))
    w.append("};")
    w.append("static const int kL2Classes[] = {")
    w.append(fmt_rows(classes_flat, str, 12))
    w.append("};")
    # translate[sr_idx][mono][bitrate_idx]
    tr = []
    for sr in range(3):
        for mono in (0, 1):
            tr.extend(_TRANSLATE[sr][mono])
    w.append("static const int kL2Translate[3][2][15] = {")
    for sr in range(3):
        w.append("  {")
        for mono in (0, 1):
            w.append("    {" + ", ".join(
                str(_TRANSLATE[sr][mono][b]) for b in range(15)) + "},")
        w.append("  },")
    w.append("};")
    # quantization classes: levels -> (bits, grouped)
    levels = sorted(QCLASS)
    w.append("static const int kQClassN = %d;" % len(levels))
    w.append("static const int kQClassLevels[] = {"
             + ", ".join(map(str, levels)) + "};")
    w.append("static const int kQClassBits[] = {"
             + ", ".join(str(QCLASS[n][0]) for n in levels) + "};")
    w.append("static const int kQClassGrouped[] = {"
             + ", ".join(str(int(QCLASS[n][1])) for n in levels) + "};")
    w.append("")

    # --- Layer III scalefactor bands / slen / pretab ---
    w.append("static const int kSfbLong[3][23] = {")
    for sr in range(3):
        w.append("  {" + ", ".join(map(str, SFB_LONG[sr])) + "},")
    w.append("};")
    w.append("static const int kSfbShort[3][14] = {")
    for sr in range(3):
        w.append("  {" + ", ".join(map(str, SFB_SHORT[sr])) + "},")
    w.append("};")
    w.append("static const int kSlen[16][2] = {")
    w.append("  " + ", ".join("{%d, %d}" % s for s in SLEN))
    w.append("};")
    w.append("static const int kPretab[22] = {"
             + ", ".join(map(str, PRETAB)) + "};")
    # LSF/2.5 band tables keyed by sample rate order
    lsf_rates = (22050, 24000, 16000, 11025, 12000, 8000)
    w.append("static const int kLsfRates[6] = {"
             + ", ".join(map(str, lsf_rates)) + "};")
    w.append("static const int kSfbLongLsf[6][23] = {")
    for r in lsf_rates:
        w.append("  {" + ", ".join(map(str, SFB_LONG_LSF[r])) + "},")
    w.append("};")
    w.append("static const int kSfbShortLsf[6][14] = {")
    for r in lsf_rates:
        w.append("  {" + ", ".join(map(str, SFB_SHORT_LSF[r])) + "},")
    w.append("};")
    w.append("// [partition class][block class 0=long 1=short 2=mixed][group]")
    w.append("static const int kNrOfSfb[6][3][4] = {")
    for bn in range(6):
        w.append("  {" + ", ".join(
            "{" + ", ".join(map(str, _NR_OF_SFB[bn][c])) + "}"
            for c in range(3)) + "},")
    w.append("};")
    w.append("")

    # --- Layer III Huffman tables ---
    # Big-value tables: flattened entries (len, code, x, y); codes are the
    # bit strings reinterpreted MSB-first.
    entries, ent_off, linbits = [], [0], []
    for t in range(32):
        lb, tab = BIG_VALUE_TABLES[t]
        linbits.append(lb)
        for bits, (x, y) in sorted(tab.items(), key=lambda kv: (len(kv[0]),
                                                                kv[0])):
            entries.append((len(bits), int(bits, 2), x, y))
        ent_off.append(len(entries))
    w.append("static const int kHuffLinbits[32] = {"
             + ", ".join(map(str, linbits)) + "};")
    w.append("static const int kHuffOff[33] = {")
    w.append(fmt_rows(ent_off, str, 12))
    w.append("};")
    w.append("// {len, code, x, y}")
    w.append("static const int kHuffEntries[][4] = {")
    w.append(fmt_rows(entries, lambda e: "{%d, %d, %d, %d}" % e, 4))
    w.append("};")
    c1_entries, c1_off = [], [0]
    for t in (0, 1):
        for bits, quad in sorted(COUNT1_TABLES[t].items(),
                                 key=lambda kv: (len(kv[0]), kv[0])):
            v = quad[0] | (quad[1] << 1) | (quad[2] << 2) | (quad[3] << 3)
            c1_entries.append((len(bits), int(bits, 2), v))
        c1_off.append(len(c1_entries))
    w.append("static const int kC1Off[3] = {"
             + ", ".join(map(str, c1_off)) + "};")
    w.append("// {len, code, v-bitmask (bit j = |v_j|)}")
    w.append("static const int kC1Entries[][3] = {")
    w.append(fmt_rows(c1_entries, lambda e: "{%d, %d, %d}" % e, 6))
    w.append("};")
    w.append("")

    with open(OUT, "w") as f:
        f.write("\n".join(w) + "\n")
    print(f"wrote {os.path.abspath(OUT)}: "
          f"{len(entries)} bigvalue entries, {len(c1_entries)} count1, "
          f"{len(classes_flat)} L2 class slots")


if __name__ == "__main__":
    main()
