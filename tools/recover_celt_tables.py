"""Recover the CELT (Opus) static mode tables from the system libopus binary.

The reference mount is empty (SURVEY.md §0), so — as with the MPEG synthesis
window, the MP3 Huffman tables and the AAC codebooks — constants the offline
spec text cannot provide are recovered from the system reference
implementation and then certified against it.  For Opus the reference is
`libopus.so.0` (1.3.1 on this image).  Unlike the MP3/AAC recoveries, which
probed decoder *behavior*, the CELT mode tables are plain `.rodata` constants
in the reference binary, laid out contiguously per compilation unit; we
locate them by content anchors + structural invariants and fail loudly if any
invariant does not hold.  Decode behavior is then certified end-to-end
against `opus_decode_float` (tests/test_opus.py), which transitively
certifies every extracted byte that matters.

Anchors and invariants per table (48 kHz / 960-sample mode — the only mode
libopus builds by default and the only one Ogg Opus uses):

  eband5ms[22]        literal known band-boundary sequence (RFC 6716 §4.3).
  window120[120]      float32; matches sin(pi/2 sin^2(pi/2 (i+.5)/120))
                      within 1 ulp elementwise (the overlap window formula,
                      RFC 6716 §4.3.7).
  logN400[21]         int16; equals round-to-table of 8*log2(band width) —
                      checked against eband5ms widths.
  band_allocation     11x21 uchar; row 0 all zeros, rows monotone
                      nondecreasing in quality for every band.
  cache_index50[105]  int16, 5 rows (LM=-1..3) x 21 bands; -1 only where
                      the effective band size is 0; row entries reference
                      valid offsets; equal band sizes share an offset.
  cache_bits50[392]   uchar; ends exactly where cache_index50's largest
                      offset + its row length lands; per-row entries are
                      nondecreasing (bits are cumulative in K).
  cache_caps50[168]   uchar, 8 rows (LM 0..3 x mono/stereo) x 21 bands;
                      rows monotone nondecreasing in LM per band/channel.
  e_prob_model[4][2][42]  uchar; located as the UNIQUE >=336-byte run of
                      bytes in [1,210] in the CELT rodata region.
  eMeans[25]          float32; the unique run of >=25 consecutive floats
                      that are multiples of 1/16 in [3,7]; beta_intra
                      (4915/32768) must immediately follow it.
  pred_coef[4], beta_coef[4]  float32; exact IEEE equality with
                      {29440,26112,21248,16384}/32768 and
                      {30147,22282,12124,6554}/32768.
  trim_icdf/spread_icdf/tapset_icdf, tf_select_table, ordery_table,
  bit_(de)interleave_table, exp2_table8
                      literal content searches; each must occur in the
                      binary (tf_select/ordery/interleave uniquely).

Usage:  python tools/recover_celt_tables.py [libopus_path] [out_path]
Writes hpfw_jax/io/_celt_tables.py (generated file — do not hand-edit).
"""

from __future__ import annotations

import math
import struct
import sys

import numpy as np

LIB_CANDIDATES = (
    "/lib/x86_64-linux-gnu/libopus.so.0",
    "/usr/lib/x86_64-linux-gnu/libopus.so.0",
    "libopus.so.0",
)

EBAND5MS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40,
            48, 60, 78, 100]


def _find_all(data: bytes, pat: bytes) -> list[int]:
    out, i = [], data.find(pat)
    while i >= 0:
        out.append(i)
        i = data.find(pat, i + 1)
    return out


def _find_one(data: bytes, pat: bytes, name: str) -> int:
    hits = _find_all(data, pat)
    if len(hits) == 0:
        raise AssertionError(f"{name}: pattern not found in reference binary")
    # A duplicated table (encoder+decoder compilation units) is fine as long
    # as every copy is byte-identical, which _find_all guarantees by
    # construction (same pattern).  Return the first.
    return hits[0]


def recover(lib_path: str) -> dict:
    data = open(lib_path, "rb").read()
    t: dict[str, object] = {}

    # --- anchor: eband5ms -------------------------------------------------
    eb_pat = b"".join(struct.pack("<h", v) for v in EBAND5MS)
    eb = _find_one(data, eb_pat, "eband5ms")
    t["EBAND5MS"] = EBAND5MS
    widths = np.diff(np.asarray(EBAND5MS))

    # --- window120: formula match within 1 ulp ---------------------------
    wf = np.array([math.sin(0.5 * math.pi
                            * math.sin(0.5 * math.pi * (i + 0.5) / 120) ** 2)
                   for i in range(120)], dtype=np.float32)
    wi = _find_one(data, wf[:4].tobytes(), "window120")
    win = np.frombuffer(data[wi:wi + 480], dtype="<f4").copy()
    ulp = np.abs(win - wf) / np.spacing(np.abs(wf) + 1e-30)
    assert np.all(ulp <= 1.0 + 1e-6), "window120 deviates >1 ulp from formula"
    t["WINDOW120"] = win

    # --- logN400: ends right before window120 (same CU), verify vs widths -
    logn = np.frombuffer(data[wi - 64:wi], dtype="<i2")
    # strip alignment padding: the table is the last 21 nonpad entries ending
    # with round(8*log2(22)) = 36.
    endv = int(round(8 * math.log2(float(widths[-1]))))
    tail = np.where(logn == endv)[0]
    assert tail.size, "logN400 terminator not found before window120"
    logn = logn[tail[-1] - 20:tail[-1] + 1].astype(int).tolist()
    for lv, w in zip(logn, widths):
        assert abs(lv - 8 * math.log2(float(w))) < 1.0, \
            f"logN400 {lv} inconsistent with band width {w}"
    t["LOGN400"] = logn

    # --- band_allocation: 231 bytes between window end and eband5ms -------
    ba = np.frombuffer(data[wi + 480:wi + 480 + 231], dtype=np.uint8)
    ba = ba.reshape(11, 21).astype(int)
    assert not ba[0].any(), "band_allocation row 0 must be all zeros"
    assert np.all(np.diff(ba, axis=0) >= 0), \
        "band_allocation rows must be monotone in quality"
    assert eb - (wi + 480) >= 231, "band_allocation overruns eband5ms"
    t["BAND_ALLOCATION"] = ba.tolist()

    # --- cache_index50: 5x21 int16, starts with the LM=-1 row ------------
    ci_start = _find_one(data, b"\xff\xff" * 8, "cache_index50")
    ci = np.frombuffer(data[ci_start:ci_start + 210],
                       dtype="<i2").reshape(5, 21).astype(int)
    for lm in range(-1, 4):
        for band in range(21):
            n = (int(widths[band]) << (lm + 1)) >> 1
            if n == 0:
                assert ci[lm + 1, band] == -1, "index must be -1 for N=0"
            else:
                assert 0 <= ci[lm + 1, band] < 1024, "index offset range"
    # equal effective band size => same cache row
    sizes: dict[int, int] = {}
    for lm in range(-1, 4):
        for band in range(21):
            n = (int(widths[band]) << (lm + 1)) >> 1
            if n <= 0:
                continue
            off = int(ci[lm + 1, band])
            assert sizes.setdefault(n, off) == off, \
                f"cache_index rows differ for equal N={n}"
    t["CACHE_INDEX50"] = ci.tolist()

    # --- cache_bits50: precedes cache_index50 with zero alignment pad -----
    max_off = int(ci.max())
    # Scan back over the zero pad; the table's true size is self-describing:
    # it ends at its largest row's end, max_off + 1 + cache[max_off].
    cb_end = ci_start
    while data[cb_end - 1] == 0:
        cb_end -= 1
    cb_start = None
    for size in range(max_off + 2, 4096):
        s = cb_end - size
        if (data[s] == 40
                and size == max_off + 1 + data[s + max_off]):
            cb_start = s
            break
    assert cb_start is not None, "cache_bits50 boundary not found"
    cb = np.frombuffer(data[cb_start:cb_end], dtype=np.uint8)
    offs = sorted({int(v) for v in ci.ravel() if v >= 0})
    for o in offs:
        lv = int(cb[o])
        row = cb[o + 1:o + 1 + lv].astype(int)
        assert np.all(np.diff(row) >= 0), f"cache_bits row @{o} not monotone"
    t["CACHE_BITS50"] = cb.astype(int).tolist()

    # --- cache_caps50: 168 bytes ending before cache_bits50's zero pad ----
    zpad_end = cb_start
    while data[zpad_end - 1] == 0:
        zpad_end -= 1
    caps = np.frombuffer(data[zpad_end - 168:zpad_end],
                         dtype=np.uint8).reshape(8, 21).astype(int)
    # caps are per-MDCT-normalized (not monotone in LM); the structural
    # invariants are: all positive, and the stereo row >= the mono row at
    # every (LM, band).
    assert np.all(caps > 0), "cache_caps50 must be positive"
    assert np.all(caps[1::2] >= caps[0::2]), \
        "cache_caps50 stereo rows must dominate mono rows"
    t["CACHE_CAPS50"] = caps.tolist()

    # --- e_prob_model: unique structural run ------------------------------
    d = np.frombuffer(data, dtype=np.uint8)
    lo = (d >= 1) & (d <= 210)
    cands = []
    i = max(0, eb - 0x10000)
    hi = min(len(d), eb + 0x10000)
    while i < hi:
        if lo[i]:
            j = i
            while j < hi and lo[j]:
                j += 1
            if j - i >= 336:
                cands.append((i, j - i))
            i = j
        else:
            i += 1
    assert len(cands) == 1 and cands[0][1] == 336, \
        f"e_prob_model not uniquely located: {cands}"
    epm = d[cands[0][0]:cands[0][0] + 336].reshape(4, 2, 42).astype(int)
    t["E_PROB_MODEL"] = epm.tolist()

    # --- eMeans + beta_intra ----------------------------------------------
    farr = np.frombuffer(data[:len(data) // 4 * 4], dtype="<f4")
    with np.errstate(over="ignore", invalid="ignore"):
        okf = ((farr >= 3.0) & (farr <= 7.0)
               & (np.abs(farr * 16 - np.round(farr * 16)) < 1e-6))
    runs = []
    i = 0
    while i < len(okf):
        if okf[i]:
            j = i
            while j < len(okf) and okf[j]:
                j += 1
            if j - i >= 25:
                runs.append(i)
            i = j
        else:
            i += 1
    assert len(runs) == 1, f"eMeans not uniquely located: {runs}"
    emeans = farr[runs[0]:runs[0] + 25].copy()
    beta_intra = float(farr[runs[0] + 25])
    assert struct.pack("<f", beta_intra) == struct.pack(
        "<f", np.float32(4915 / 32768)), "beta_intra must follow eMeans"
    t["EMEANS"] = emeans
    t["BETA_INTRA"] = beta_intra

    # --- pred/beta coefficients: exact float equality ----------------------
    pred = [29440 / 32768, 26112 / 32768, 21248 / 32768, 16384 / 32768]
    beta = [30147 / 32768, 22282 / 32768, 12124 / 32768, 6554 / 32768]
    _find_one(data, b"".join(struct.pack("<f", v) for v in pred), "pred_coef")
    _find_one(data, b"".join(struct.pack("<f", v) for v in beta), "beta_coef")
    t["PRED_COEF"] = [np.float32(v) for v in pred]
    t["BETA_COEF"] = [np.float32(v) for v in beta]

    # --- small literal tables (presence-verified in the binary) -----------
    lits = {
        "TRIM_ICDF": bytes([126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0]),
        "SPREAD_ICDF": bytes([25, 23, 2, 0]),
        "TAPSET_ICDF": bytes([2, 1, 0]),
        "BIT_INTERLEAVE": bytes([0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3,
                                 2, 3, 3, 3]),
        "BIT_DEINTERLEAVE": bytes([0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33,
                                   0x3C, 0x3F, 0xC0, 0xC3, 0xCC, 0xCF,
                                   0xF0, 0xF3, 0xFC, 0xFF]),
    }
    for name, pat in lits.items():
        _find_one(data, pat, name)
        t[name] = list(pat)
    tf_sel = [[0, -1, 0, -1, 0, -1, 0, -1],
              [0, -1, 0, -2, 1, 0, 1, -1],
              [0, -2, 0, -3, 2, 0, 1, -1],
              [0, -2, 0, -3, 3, 0, 1, -1]]
    _find_one(data, bytes((v & 0xFF) for r in tf_sel for v in r),
              "tf_select_table")
    t["TF_SELECT_TABLE"] = tf_sel
    ordery = [1, 0, 3, 0, 2, 1, 7, 0, 4, 3, 6, 1, 5, 2,
              15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5]
    _find_one(data, b"".join(struct.pack("<i", v) for v in ordery),
              "ordery_table")
    t["ORDERY_TABLE"] = ordery
    e8 = [16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048]
    _find_one(data, b"".join(struct.pack("<h", v) for v in e8), "exp2_table8")
    t["EXP2_TABLE8"] = e8
    return t


def emit(tables: dict, out_path: str, lib_path: str) -> None:
    lines = [
        '"""CELT (Opus) static mode tables — GENERATED by',
        "tools/recover_celt_tables.py from the system reference binary",
        f"({lib_path}); every table is verified against structural",
        "invariants at recovery time and against opus_decode_float decode",
        'behavior by tests/test_opus.py.  Do not hand-edit."""',
        "",
        "import numpy as np",
        "",
    ]

    def fmt(name, val):
        if isinstance(val, np.ndarray) and val.dtype == np.float32:
            body = ", ".join(f"np.float32({float(v)!r})" for v in val)
            return f"{name} = np.array([{body}], dtype=np.float32)\n"
        if isinstance(val, list) and val and isinstance(val[0], np.float32):
            body = ", ".join(f"np.float32({float(v)!r})" for v in val)
            return f"{name} = [{body}]\n"
        if isinstance(val, float):
            return f"{name} = np.float32({val!r})\n"
        return f"{name} = {val!r}\n"

    for name, val in tables.items():
        lines.append(fmt(name, val))
    open(out_path, "w").write("\n".join(lines))


def main():
    lib = sys.argv[1] if len(sys.argv) > 1 else None
    if lib is None:
        for c in LIB_CANDIDATES:
            try:
                open(c, "rb").close()
                lib = c
                break
            except OSError:
                continue
    out = sys.argv[2] if len(sys.argv) > 2 else "hpfw_jax/io/_celt_tables.py"
    tables = recover(lib)
    emit(tables, out, lib)
    n = sum(np.asarray(v).size for v in tables.values())
    print(f"recovered {len(tables)} tables ({n} values) from {lib} -> {out}")


if __name__ == "__main__":
    main()
