"""Audio decode + resample (host-side audio I/O).

The reference wraps a native audio library for decode (SURVEY.md §2.1 row 1).
Here decode is host-side by definition (the device doesn't decode audio); a C++
implementation lives in native/hpfw_native.cc (loaded via ctypes in
io/native.py) with this pure-NumPy path as the always-available fallback and
correctness oracle for it.

Supports WAV (PCM 8/16/24/32, float32/64, mu-law, A-law, and the
WAVE_FORMAT_EXTENSIBLE wrapper), AIFF/AIFF-C (big-endian PCM, sowt,
G.711 ulaw/alaw), Sun/NeXT .au (G.711 + big-endian PCM/float), FLAC
(full bitstream decode, io/flac.py + the C++ twin), Ogg Vorbis
(io/vorbis.py + the C++ twin — floors, residues, coupling, IMDCT), and
MPEG audio Layers I/II/III, i.e. MP3 — MPEG-1, MPEG-2 LSF, and MPEG-2.5,
all nine sample rates (from-spec decode, io/mp3.py, validated against
libmpg123 at the float32 floor), any
channel count (downmixed to mono), resampled to the config rate with a
polyphase windowed-sinc resampler (Kaiser, scipy.resample_poly-equivalent;
linear is the opt-in fast path via cfg.resample="linear").
"""

from __future__ import annotations

import struct
import wave

import numpy as np

from ..config import HpfwConfig


def load_wav(path: str, cfg: HpfwConfig | None = None) -> tuple[np.ndarray, int]:
    """Decode a WAV file -> (mono float32 PCM in [-1,1], sample_rate).

    Prefers the C++ decoder (native/hpfw_native.cc, bit-identical and
    threaded-runtime grade); falls back to the pure-NumPy path when the
    native library is unavailable. If cfg is given, the PCM is resampled to
    cfg.sample_rate.
    """
    with open(path, "rb") as f:
        data = f.read()
    from . import native

    if data[:4] == b"fLaC":
        if native.available():
            pcm, sr = native.decode_flac(data)
        else:
            from .flac import decode_flac

            pcm, sr = decode_flac(data)
    elif data[:4] == b"OggS":
        # The first Ogg page is tiny (one ident packet), so the codec magic
        # sits within the first few dozen bytes: OpusHead (RFC 7845 §5.1)
        # vs \x01vorbis.
        if b"OpusHead" in data[:128]:
            if native.available():
                pcm, sr = native.decode_opus(data)
            else:
                from .opus import decode_opus

                pcm, sr = decode_opus(data)
        elif native.available():
            pcm, sr = native.decode_vorbis(data)
        else:
            from .vorbis import decode_vorbis

            pcm, sr = decode_vorbis(data)
    elif data[:4] == b".snd":
        pcm, sr = _decode_au_bytes(data)
    elif (data[:4] == b"RIFF" and data[8:12] == b"WAVE") or (
            data[:4] == b"FORM" and data[8:12] in (b"AIFF", b"AIFC")):
        # Decisive container magic beats the heuristic MPEG sniff: loud
        # 16-bit PCM payloads are full of spurious 0xFFEx sync patterns.
        if native.available():
            try:
                pcm, sr = native.decode_wav(data)
            except ValueError:
                pcm, sr = _decode_wav_bytes(data)
        else:
            pcm, sr = _decode_wav_bytes(data)
    elif _looks_like_adts(data):
        pcm, sr = _decode_adts_bytes(data)
    elif _looks_like_mpeg(data):
        pcm, sr = _decode_mpeg_bytes(data)
    elif native.available():
        try:
            pcm, sr = native.decode_wav(data)
        except ValueError:
            pcm, sr = _decode_wav_bytes(data)
    else:
        pcm, sr = _decode_wav_bytes(data)
    if cfg is not None and sr != cfg.sample_rate:
        pcm = resample(pcm, sr, cfg.sample_rate,
                       kind=getattr(cfg, "resample", "sinc"))
        sr = cfg.sample_rate
    return pcm, sr


def _looks_like_mpeg(data: bytes) -> bool:
    """MPEG audio has no container magic; detect by an ID3 tag or a valid
    frame header near the start whose length lands on a second valid
    header (the classic two-frame heuristic, immune to random sync bytes
    in other binary formats)."""
    from .mp3 import FrameHeader, _find_sync, _skip_id3

    from .mp3 import _free_format_size

    pos = _skip_id3(data)
    if pos > 0 and pos < len(data):
        return True  # an ID3v2 tag is decisive
    # Sync beyond 4 KiB is rejected anyway, so only scan that prefix
    # (keeps the sniff O(1) on large sync-free WAV/AIFF files); a sync
    # that fails verification is skipped, not fatal — junk bytes can
    # contain spurious sync patterns ahead of the real first frame.
    prefix = data[:4096 + 4]
    while True:
        pos = _find_sync(prefix, pos)
        if pos < 0 or pos > 4096:
            return False
        h = FrameHeader(int.from_bytes(data[pos:pos + 4], "big"))
        if h.frame_bytes == 0:  # free format: needs a measurable next sync
            if _free_format_size(data, pos, h) > 0:
                return True
        else:
            nxt = pos + h.frame_bytes
            if nxt + 4 <= len(data):
                try:
                    FrameHeader(int.from_bytes(data[nxt:nxt + 4], "big"))
                    return True
                except ValueError:
                    pass
            elif nxt >= len(data) - 4 and pos == _skip_id3(data):
                # A lone (possibly truncated) frame is only decisive when it
                # sits at the very start of the stream — a mid-file sync with
                # no verifiable second header is most likely payload junk.
                return True
        pos += 1


def _looks_like_adts(data: bytes) -> bool:
    """ADTS AAC detection: a verified header near the start whose length
    lands on a second verified header (same two-frame discipline as the
    MPEG sniff; the syncs are disjoint — ADTS has MPEG layer bits 00,
    which the MPEG header parser rejects as reserved)."""
    from .aac import _find_adts

    pos = _find_adts(data[:8192], 0)
    return 0 <= pos <= 4096


def _decode_adts_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """ADTS AAC bytes -> (mono float32 PCM, sample_rate)."""
    from .aac import decode_aac

    pcm, sr = decode_aac(data)
    if pcm.ndim == 2:
        pcm = pcm.mean(axis=1)
    return pcm.astype(np.float32), sr


def _decode_mpeg_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """MPEG-1 audio bytes -> (mono float32 PCM, sample_rate).

    Prefers the C++ twin (native/hpfw_mp3.cc, bit-identical at float32
    output — tests/test_mp3.py); NumPy fallback otherwise, including when
    the native decode rejects the stream (e.g. a sniff false positive the
    NumPy twin tolerates), mirroring the WAV path's fallback."""
    from . import native

    if native.available():
        try:
            return native.decode_mp3(data)
        except ValueError:
            pass
    from .mp3 import decode_mp3

    pcm, sr = decode_mp3(data)
    if pcm.shape[0] == 0 or not sr:
        raise ValueError("no decodable MPEG audio frames")
    x = pcm.mean(axis=1) if pcm.shape[1] > 1 else pcm[:, 0]
    return np.ascontiguousarray(x, dtype=np.float32), sr


def _mulaw_table() -> np.ndarray:
    """G.711 mu-law byte -> float32 in [-1, 1] (exact int16 expansion)."""
    u = ~np.arange(256, dtype=np.uint8)
    sign = (u & 0x80) != 0
    exp = (u >> 4) & 7
    mant = (u & 0xF).astype(np.int32)
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(sign, -mag, mag).astype(np.float32) / 32768.0


def _alaw_table() -> np.ndarray:
    """G.711 A-law byte -> float32 in [-1, 1] (exact int16 expansion)."""
    a = np.arange(256, dtype=np.uint8) ^ 0x55
    sign = (a & 0x80) != 0
    exp = (a >> 4) & 7
    mant = (a & 0xF).astype(np.int32)
    mag = np.where(exp == 0, (mant << 4) + 8,
                   ((mant << 4) + 0x108) << np.maximum(exp - 1, 0))
    return np.where(sign, -mag, mag).astype(np.float32) / 32768.0


def _decode_f80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (AIFF sample rate field)."""
    e = int.from_bytes(b[:2], "big")
    mant = int.from_bytes(b[2:10], "big")
    sign = -1.0 if e & 0x8000 else 1.0
    e &= 0x7FFF
    if e == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (e - 16383 - 63)


def _decode_aiff_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """AIFF / AIFF-C big-endian PCM (compression NONE or sowt)."""
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not an AIFF file")
    pos = 12
    n_ch = bits = 0
    sr = 0
    comp = b"NONE"
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            n_ch, _, bits = struct.unpack(">hIh", body[:8])
            sr = int(round(_decode_f80(body[8:18])))
            if len(body) >= 22:
                comp = body[18:22]
        elif cid == b"SSND":
            off = struct.unpack(">I", body[:4])[0]
            raw = body[8 + off:]
        pos += 8 + size + (size & 1)
    if raw is None or n_ch <= 0 or sr <= 0:
        raise ValueError("missing COMM/SSND chunk")
    if comp in (b"ulaw", b"ULAW"):
        x = _mulaw_table()[np.frombuffer(raw, dtype=np.uint8)]
        if n_ch > 1:
            x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
        return np.ascontiguousarray(x, dtype=np.float32), sr
    if comp in (b"alaw", b"ALAW"):
        x = _alaw_table()[np.frombuffer(raw, dtype=np.uint8)]
        if n_ch > 1:
            x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
        return np.ascontiguousarray(x, dtype=np.float32), sr
    if comp not in (b"NONE", b"sowt"):
        raise ValueError(f"unsupported AIFF-C compression {comp!r}")
    endian = "<" if comp == b"sowt" else ">"
    if bits == 16:
        x = np.frombuffer(raw, dtype=f"{endian}i2").astype(np.float32) / 32768.0
    elif bits == 8:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif bits == 24:
        b3 = np.frombuffer(raw, dtype=np.uint8)[: (len(raw) // 3) * 3].reshape(-1, 3)
        if endian == ">":
            b3 = b3[:, ::-1]
        x = (
            b3[:, 0].astype(np.int32)
            | (b3[:, 1].astype(np.int32) << 8)
            | (b3[:, 2].astype(np.int8).astype(np.int32) << 16)
        ).astype(np.float32) / 8388608.0
    elif bits == 32:
        x = np.frombuffer(raw, dtype=f"{endian}i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported AIFF bit depth {bits}")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def _decode_au_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Sun/NeXT .au (magic '.snd'): big-endian header, mu-law/A-law/PCM."""
    if data[:4] != b".snd":
        raise ValueError("not a Sun .au file")
    off, size, enc, sr, n_ch = struct.unpack(">IIIII", data[4:24])
    raw = data[off: off + size if size != 0xFFFFFFFF else len(data)]
    if enc == 1:  # G.711 mu-law
        x = _mulaw_table()[np.frombuffer(raw, dtype=np.uint8)]
    elif enc == 27:  # G.711 A-law
        x = _alaw_table()[np.frombuffer(raw, dtype=np.uint8)]
    elif enc == 2:  # 8-bit linear PCM (signed)
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif enc == 3:  # 16-bit linear PCM, big-endian
        x = np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0
    elif enc == 4:  # 24-bit linear PCM, big-endian
        b3 = np.frombuffer(raw, dtype=np.uint8)[: (len(raw) // 3) * 3]
        b3 = b3.reshape(-1, 3)[:, ::-1]
        x = (b3[:, 0].astype(np.int32)
             | (b3[:, 1].astype(np.int32) << 8)
             | (b3[:, 2].astype(np.int8).astype(np.int32) << 16)
             ).astype(np.float32) / 8388608.0
    elif enc == 5:  # 32-bit linear PCM, big-endian
        x = np.frombuffer(raw, dtype=">i4").astype(np.float32) / 2147483648.0
    elif enc == 6:  # 32-bit IEEE float, big-endian
        x = np.frombuffer(raw, dtype=">f4").astype(np.float32)
    elif enc == 7:  # 64-bit IEEE float, big-endian
        x = np.frombuffer(raw, dtype=">f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported .au encoding {enc}")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def _decode_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    if data[:4] == b"fLaC":
        from .flac import decode_flac

        return decode_flac(data)
    if data[:4] == b"FORM":
        return _decode_aiff_bytes(data)
    if data[:4] == b".snd":
        return _decode_au_bytes(data)
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, n_ch, sr, _, _, bits = fmt
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format code is the first uint16 of
        # the SubFormat GUID at fmt-body offset 24 (16 base + cbSize(2) +
        # validBits(2) + channelMask(4)).
        if len(fmt_body) < 26:
            raise ValueError("extensible WAV with truncated fmt chunk")
        audio_format = struct.unpack("<H", fmt_body[24:26])[0]
    if audio_format == 1:  # integer PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b3 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b3[:, 0].astype(np.int32)
                | (b3[:, 1].astype(np.int32) << 8)
                | (b3[:, 2].astype(np.int8).astype(np.int32) << 16)
            ).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    elif audio_format == 6:  # G.711 A-law
        x = _alaw_table()[np.frombuffer(raw, dtype=np.uint8)]
    elif audio_format == 7:  # G.711 mu-law
        x = _mulaw_table()[np.frombuffer(raw, dtype=np.uint8)]
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


# The decode entry handles every supported container (WAV/AIFF/FLAC) by
# magic — "load_audio" is the honest name; "load_wav" stays for history.
load_audio = load_wav


def save_wav(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    """Write mono float PCM as 16-bit WAV (fixture generation / debugging)."""
    x = np.clip(np.asarray(pcm, dtype=np.float64), -1.0, 1.0)
    ints = (x * 32767.0).round().astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(ints.tobytes())


def resample_linear(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (matches the native C++ one exactly).

    Fast but aliasing above ~sr/4 — the opt-in path (cfg.resample="linear");
    the default pipeline path is resample_sinc.
    """
    if sr_in == sr_out:
        return np.asarray(pcm, dtype=np.float32)
    n_in = pcm.shape[0]
    n_out = int(n_in * sr_out / sr_in)
    src = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = (src - i0).astype(np.float32)
    x = np.asarray(pcm, dtype=np.float32)
    return ((1.0 - frac) * x[i0] + frac * x[i1]).astype(np.float32)


_KAISER_BETA = 5.0      # scipy.signal.resample_poly's default window
_HALF_LEN_FACTOR = 10   # taps = 2*10*max(L,M) + 1, scipy's default length


def _design_kaiser_sinc(l: int, m: int) -> np.ndarray:
    """Polyphase anti-aliasing lowpass: Kaiser(5.0)-windowed sinc at the
    L-upsampled rate, cutoff at the tighter of the two Nyquists
    (1/max(L,M)), DC-normalized, scaled by L. Identical (to float64
    rounding) to scipy.signal.resample_poly's default design — the
    validation anchor (tests/test_resample.py)."""
    mx = max(l, m)
    half_len = _HALF_LEN_FACTOR * mx
    t = np.arange(2 * half_len + 1, dtype=np.float64) - half_len
    h = (1.0 / mx) * np.sinc(t / mx) * np.kaiser(2 * half_len + 1,
                                                 _KAISER_BETA)
    h /= h.sum()
    return h * l


def resample_sinc(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase windowed-sinc rational resampler (the reference-grade
    default; SURVEY.md §2.1 row 1).

    Output equals scipy.signal.resample_poly(x, L, M, window=("kaiser",
    5.0)) to ~1e-15 (measured across up/down ratios), with float64
    accumulation and float32 output. The C++ twin (hpfw_resample_sinc)
    computes the same polyphase sums; its sequential accumulation order can
    differ from this vectorized path by float64 rounding, i.e. at most ~1
    float32 ulp — margin-tested rather than bit-asserted, unlike the
    integer decoders.
    """
    import math

    g = math.gcd(int(sr_in), int(sr_out))
    l, m = sr_out // g, sr_in // g
    if l == m:
        return np.asarray(pcm, dtype=np.float32)
    x = np.asarray(pcm, dtype=np.float64)
    n_in = x.shape[0]
    h = _design_kaiser_sinc(l, m)
    taps = h.shape[0]
    d = (taps - 1) // 2                       # center-tap group delay
    n_out = -(-n_in * l // m)
    k = -(-taps // l)                         # taps per output sample
    w = np.zeros((l, k))
    for p in range(l):
        hp = h[p::l]
        w[p, : hp.shape[0]] = hp
    out = np.empty(n_out, dtype=np.float64)
    block = 1 << 16
    for s in range(0, n_out, block):
        mm = np.arange(s, min(s + block, n_out))
        u = d + mm * m                        # position on the upsampled grid
        phase = u % l
        ih = u // l
        idx = ih[:, None] - np.arange(k)[None, :]
        valid = (idx >= 0) & (idx < n_in)
        xs = np.where(valid, x[np.clip(idx, 0, n_in - 1)], 0.0)
        out[s: s + mm.shape[0]] = np.einsum("mk,mk->m", w[phase], xs)
    return out.astype(np.float32)


def resample(pcm: np.ndarray, sr_in: int, sr_out: int,
             kind: str = "sinc") -> np.ndarray:
    """Resample dispatch: "sinc" (polyphase Kaiser, default) or "linear"
    (fast opt-in). Prefers the native C++ sinc when available."""
    if sr_in == sr_out:
        return np.asarray(pcm, dtype=np.float32)
    if kind == "linear":
        return resample_linear(pcm, sr_in, sr_out)
    if kind != "sinc":
        raise ValueError(f"unknown resample kind {kind!r}")
    from . import native

    if native.available():
        return native.resample_sinc(pcm, sr_in, sr_out)
    return resample_sinc(pcm, sr_in, sr_out)
