"""Recover the MPEG-1 polyphase synthesis-window constants from libmpg123.

ISO/IEC 11172-3 Annex B Table B.3 tabulates the 512 synthesis-window
coefficients D[i]; the spec text is not available in this offline
environment, but the system's libmpg123 implements them. The synthesis
filterbank output is LINEAR in D for known subband input, and a composed
Layer I stream (io/mp3enc.py) gives exact control of the subband samples —
so D is recoverable by least squares from probe decodes:

  out_t[j] = sum_q D[64q+j]    * Vnew[t-2q  ][j]
           + sum_q D[64q+32+j] * Vnew[t-2q-1][32+j]      (q = 0..7)

with Vnew[t] = N @ S_t, N[i,k] = cos((16+i)(2k+1)pi/64) — the classic
matrixing + 1024-FIFO structure. Probes are baseline-subtracted impulse
streams (one subband sample changed), so the unknown requantization offset
cancels and only the slope convention enters (folded into D's scale, then
sanity-checked against the window's known peak magnitude ~1.1449).

Output: writes hpfw_jax/io/_mpeg_window.py with the recovered D (and the
integer structure check — mpg123's table is integer-valued at scale 2^16,
which both confirms provenance and makes the recovery exact, not
approximate).

Run:  python tools/recover_mpeg_window.py
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

from hpfw_jax.io import mp3enc, mpeg_ref  # noqa: E402

NB = 15  # alloc code 14 -> 15-bit samples: finest Layer I quantization
MID = 1 << (NB - 1)
FULL = (1 << NB) - 1
N_FRAMES = 8
SF0 = 2.0  # ISO Table B.1 index 0
# Layer I requant slope for nb-bit codes: ds''/dcode = 2^(1-nb) * 2^nb/(2^nb-1)
SLOPE = 2.0 ** (1 - NB) * (1 << NB) / ((1 << NB) - 1)


def matrixing(S):
    """Vnew[t] = N @ S[t] for S of shape (T, 32)."""
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    N = np.cos((16 + i) * (2 * k + 1) * np.pi / 64)
    return S @ N.T  # (T, 64)


def probe_delta(sb: int, frame_idx: int, sample_idx: int):
    """Decode baseline and impulse streams; return (delta_pcm, delta_S)."""
    alloc = np.zeros(32, int)
    alloc[sb] = NB - 1
    scf = np.zeros(32, int)
    base_codes = np.zeros((12, 32), int)
    base_codes[:, sb] = MID
    base = mp3enc.layer1_frame_mono(base_codes, alloc, scf)
    frames = [base] * N_FRAMES
    pcm0, rate = mpeg_ref.mpg123_decode(b"".join(frames))
    assert rate == 48000, rate
    codes = base_codes.copy()
    codes[sample_idx, sb] = FULL
    frames[frame_idx] = mp3enc.layer1_frame_mono(codes, alloc, scf)
    pcm1, _ = mpeg_ref.mpg123_decode(b"".join(frames))
    d = (pcm1[:, 0].astype(np.float64) - pcm0[:, 0].astype(np.float64))
    T = 12 * N_FRAMES
    S = np.zeros((T, 32))
    S[frame_idx * 12 + sample_idx, sb] = (FULL - MID) * SLOPE * SF0
    return d, S


def main():
    if not mpeg_ref.available():
        print("system libmpg123/libmp3lame not available; nothing to do")
        return 1
    rows = {j: [] for j in range(32)}  # per-residue LS: A rows, y values
    ys = {j: [] for j in range(32)}
    for sb in range(32):
        d, S = probe_delta(sb, 3, 5)
        V = matrixing(S)  # (T, 64)
        T = S.shape[0]
        for t in range(T):
            for j in range(32):
                # coefficient vector over the 16 D taps of residue j:
                # taps [64q+j] pair with Vnew[t-2q][j];
                # taps [64q+32+j] pair with Vnew[t-2q-1][32+j]
                row = np.zeros(16)
                for q in range(8):
                    if t - 2 * q >= 0:
                        row[2 * q] = V[t - 2 * q, j]
                    if t - 2 * q - 1 >= 0:
                        row[2 * q + 1] = V[t - 2 * q - 1, 32 + j]
                if np.any(row):
                    rows[j].append(row)
                    ys[j].append(d[32 * t + j])
    D = np.zeros(512)
    worst = 0.0
    for j in range(32):
        A = np.asarray(rows[j])
        y = np.asarray(ys[j])
        sol, res, rank, _ = np.linalg.lstsq(A, y, rcond=None)
        # Residue 16 is rank-8: N[16,k] = cos((2k+1)pi/2) = 0, so the even
        # taps D[64q+16] are multiplied by an identically-zero lane — they
        # are unobservable AND contribute nothing; min-norm zeros are exact.
        assert rank == (8 if j == 16 else 16), (j, rank)
        pred = A @ sol
        rel = np.linalg.norm(pred - y) / max(np.linalg.norm(y), 1e-30)
        worst = max(worst, rel)
        # tap order within residue j: index 2q -> D[64q+j], 2q+1 -> D[64q+32+j]
        for q in range(8):
            D[64 * q + j] = sol[2 * q]
            D[64 * q + 32 + j] = sol[2 * q + 1]
    print(f"worst per-residue relative residual: {worst:.3e}")
    print(f"D peak {np.abs(D).max():.6f} (expect ~1.1449); D[0]={D[0]:.2e}")
    scaled = D * 65536.0
    frac = np.abs(scaled - np.round(scaled))
    print(f"integer structure at 2^16: max |frac| = {frac.max():.4f}")
    if frac.max() < 0.2:
        Di = np.round(scaled).astype(np.int64)
        print("-> snapping to exact integer/65536 values")
        body = np.array2string(Di, threshold=2000, max_line_width=76,
                               separator=", ")
        src = (
            '"""MPEG-1 polyphase synthesis-window coefficients '
            '(ISO 11172-3 Table B.3).\n\n'
            "Recovered exactly from the system reference decoder by linear\n"
            "probing (tools/recover_mpeg_window.py): the table is "
            "integer-valued\nat scale 2^16, max LS fractional part "
            f"{frac.max():.4f}, residual {worst:.1e}.\n"
            '"""\n\nimport numpy as np\n\n'
            f"SYNTH_WINDOW_X65536 = np.array({body}, dtype=np.int64)\n\n"
            "SYNTH_WINDOW = SYNTH_WINDOW_X65536 / 65536.0\n"
        )
        with open("hpfw_jax/io/_mpeg_window.py", "w") as f:
            f.write(src)
        print("wrote hpfw_jax/io/_mpeg_window.py")
    else:
        np.save("/tmp/mpeg_window_raw.npy", D)
        print("no integer structure; raw float table at "
              "/tmp/mpeg_window_raw.npy — investigate before baking in")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
