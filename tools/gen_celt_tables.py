"""Generate native/celt_tables.inc from hpfw_jax/io/_celt_tables.py.

Same house rule as tools/gen_mpeg_tables.py / gen_aac_tables.py: the
probe-recovered Python tables (themselves generated by
tools/recover_celt_tables.py from the system reference binary and
certified by tests/test_opus.py) are the source of truth; the C++ twin's
include is GENERATED and never edited by hand.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpfw_jax.io import _celt_tables as T


def _int_array(f, name, vals):
    f.write(f"static const int {name}[{len(vals)}] = {{%s}};\n\n"
            % ", ".join(str(int(v)) for v in vals))


def _float_array(f, name, vals):
    f.write(f"static const float {name}[{len(vals)}] = {{\n")
    for i in range(0, len(vals), 4):
        row = ", ".join("%.9ef" % float(v) for v in vals[i:i + 4])
        f.write(f"  {row},\n")
    f.write("};\n\n")


def main():
    out = os.path.join(os.path.dirname(__file__), "..", "native",
                       "celt_tables.inc")
    with open(out, "w") as f:
        f.write("// GENERATED by tools/gen_celt_tables.py from\n"
                "// hpfw_jax/io/_celt_tables.py (probe-recovered from the"
                " system reference\n// binary, certified by"
                " tests/test_opus.py). Do not edit.\n\n")
        _int_array(f, "kEBand5ms", T.EBAND5MS)
        _float_array(f, "kWindow120", T.WINDOW120)
        _int_array(f, "kLogN400", T.LOGN400)
        nrows = len(T.BAND_ALLOCATION)
        f.write(f"static const int kBandAllocRows = {nrows};\n")
        f.write(f"static const unsigned char kBandAlloc[{nrows}][21] = {{\n")
        for row in T.BAND_ALLOCATION:
            f.write("  {%s},\n" % ", ".join(str(v) for v in row))
        f.write("};\n\n")
        f.write("static const short kCacheIndex50[5][21] = {\n")
        for row in T.CACHE_INDEX50:
            f.write("  {%s},\n" % ", ".join(str(v) for v in row))
        f.write("};\n\n")
        _int_array(f, "kCacheBits50", T.CACHE_BITS50)
        f.write("static const unsigned char kCacheCaps50[8][21] = {\n")
        for row in T.CACHE_CAPS50:
            f.write("  {%s},\n" % ", ".join(str(v) for v in row))
        f.write("};\n\n")
        f.write("static const unsigned char kEProbModel[4][2][42] = {\n")
        for lm in T.E_PROB_MODEL:
            f.write("  {\n")
            for intra in lm:
                f.write("    {%s},\n" % ", ".join(str(v) for v in intra))
            f.write("  },\n")
        f.write("};\n\n")
        _float_array(f, "kEMeans", T.EMEANS)
        f.write("static const float kBetaIntra = %.9ef;\n\n"
                % float(T.BETA_INTRA))
        _float_array(f, "kPredCoef", T.PRED_COEF)
        _float_array(f, "kBetaCoef", T.BETA_COEF)
        _int_array(f, "kTrimIcdf", T.TRIM_ICDF)
        _int_array(f, "kSpreadIcdf", T.SPREAD_ICDF)
        _int_array(f, "kTapsetIcdf", T.TAPSET_ICDF)
        _int_array(f, "kBitInterleave", T.BIT_INTERLEAVE)
        _int_array(f, "kBitDeinterleave", T.BIT_DEINTERLEAVE)
        f.write("static const signed char kTfSelect[4][8] = {\n")
        for row in T.TF_SELECT_TABLE:
            f.write("  {%s},\n" % ", ".join(str(v) for v in row))
        f.write("};\n\n")
        _int_array(f, "kOrdery", T.ORDERY_TABLE)
        _int_array(f, "kExp2Table8", T.EXP2_TABLE8)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
