"""Validation-only ctypes wrapper for the system libopus reference codec.

NOT part of any decode path — `hpfw_jax.io.opus` is the standalone from-spec
decoder. This module exists so tests can (a) produce REAL reference-encoder
streams (every deployed .opus in the wild comes from libopus) and (b)
reference-decode them, certifying the from-spec decoder at the float32 floor
— the same house method as libmpg123 for MPEG, libavcodec for AAC and
libvorbisfile for Vorbis. Degrades to available() == False when the library
is absent.

The Opus API is handle-based (create functions allocate), so no opaque
struct blobs are needed. Encoding uses OPUS_APPLICATION_RESTRICTED_LOWDELAY
or the private OPUS_SET_FORCE_MODE(MODE_CELT_ONLY) ctl to pin the encoder to
the CELT mode that hpfw_jax's decoder implements (music streams; the
SILK/hybrid speech modes are a documented non-goal — io/opus.py rejects them
with a clear error).
"""

from __future__ import annotations

import ctypes as C

import numpy as np

OPUS_APPLICATION_VOIP = 2048
OPUS_APPLICATION_AUDIO = 2049
OPUS_APPLICATION_RESTRICTED_LOWDELAY = 2051
OPUS_SET_BITRATE_REQUEST = 4002
OPUS_SET_VBR_REQUEST = 4006
OPUS_SET_COMPLEXITY_REQUEST = 4010
OPUS_SET_INBAND_FEC_REQUEST = 4012
OPUS_GET_LOOKAHEAD_REQUEST = 4027
OPUS_SET_FORCE_MODE_REQUEST = 11002  # private ctl, compiled into libopus
MODE_SILK_ONLY = 1000
MODE_HYBRID = 1001
MODE_CELT_ONLY = 1002


def _load():
    for name in ("libopus.so.0", "libopus.so"):
        try:
            return C.CDLL(name)
        except OSError:
            continue
    return None


_opus = _load()
if _opus is not None:
    _opus.opus_encoder_create.restype = C.c_void_p
    _opus.opus_decoder_create.restype = C.c_void_p
    _opus.opus_encode_float.restype = C.c_int
    _opus.opus_encode_float.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                                        C.c_int, C.c_char_p, C.c_int32]
    _opus.opus_decode_float.restype = C.c_int
    _opus.opus_decode_float.argtypes = [C.c_void_p, C.c_char_p, C.c_int32,
                                        C.POINTER(C.c_float), C.c_int,
                                        C.c_int]
    _opus.opus_encoder_ctl.restype = C.c_int
    _opus.opus_decoder_destroy.restype = None
    _opus.opus_encoder_destroy.restype = None


def opus_ref_available() -> bool:
    return _opus is not None


def opus_ref_encode_packets(
    pcm: np.ndarray, *, channels: int | None = None,
    bitrate: int = 96_000, frame_ms: float = 20.0,
    application: int = OPUS_APPLICATION_AUDIO,
    force_celt: bool = True, complexity: int = 10, vbr: bool = True,
    return_lookahead: bool = False,
):
    """Encode 48 kHz float PCM ((n,) or (n, ch)) to raw Opus packets.

    Returns one packet per frame (packet-level fixtures: the from-spec
    decoder certifies packet by packet before any container enters the
    picture). The tail is zero-padded to a whole frame, as opusenc does.
    With return_lookahead=True returns (packets, lookahead_samples) — the
    encoder's real delay (OPUS_GET_LOOKAHEAD), which RFC 7845 maps to the
    container pre-skip.
    """
    if _opus is None:
        raise RuntimeError("system libopus not available")
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    if channels is None:
        channels = pcm.shape[1]
    frame = int(round(48_000 * frame_ms / 1000.0))
    err = C.c_int(0)
    enc = _opus.opus_encoder_create(48_000, channels, application,
                                    C.byref(err))
    if not enc or err.value != 0:
        raise ValueError(f"opus_encoder_create failed ({err.value})")
    try:
        _opus.opus_encoder_ctl(C.c_void_p(enc), OPUS_SET_BITRATE_REQUEST,
                               C.c_int32(bitrate))
        _opus.opus_encoder_ctl(C.c_void_p(enc), OPUS_SET_COMPLEXITY_REQUEST,
                               C.c_int32(complexity))
        _opus.opus_encoder_ctl(C.c_void_p(enc), OPUS_SET_VBR_REQUEST,
                               C.c_int32(1 if vbr else 0))
        if force_celt:
            rc = _opus.opus_encoder_ctl(C.c_void_p(enc),
                                        OPUS_SET_FORCE_MODE_REQUEST,
                                        C.c_int32(MODE_CELT_ONLY))
            if rc != 0:
                raise ValueError(f"OPUS_SET_FORCE_MODE failed ({rc})")
        lookahead = C.c_int32(0)
        _opus.opus_encoder_ctl(C.c_void_p(enc), OPUS_GET_LOOKAHEAD_REQUEST,
                               C.byref(lookahead))
        n = pcm.shape[0]
        if return_lookahead:
            # Cover the encoder delay: the last `lookahead` input samples
            # only appear in the output if an extra tail frame is encoded.
            n += lookahead.value
        npad = (-n) % frame + (n - pcm.shape[0])
        if npad:
            pcm = np.concatenate(
                [pcm, np.zeros((npad, pcm.shape[1]), np.float32)])
        buf = C.create_string_buffer(4000)
        packets = []
        for pos in range(0, pcm.shape[0], frame):
            chunk = np.ascontiguousarray(pcm[pos:pos + frame, :channels])
            got = _opus.opus_encode_float(
                C.c_void_p(enc),
                chunk.ctypes.data_as(C.POINTER(C.c_float)),
                frame, buf, 4000)
            if got < 0:
                raise ValueError(f"opus_encode_float failed ({got})")
            packets.append(buf.raw[:got])
        if return_lookahead:
            return packets, lookahead.value
        return packets
    finally:
        _opus.opus_encoder_destroy(C.c_void_p(enc))


def opus_ref_decode_packets(
    packets: list[bytes], *, channels: int,
) -> np.ndarray:
    """Reference-decode raw Opus packets with one stateful decoder.

    Returns (n, channels) float32 at 48 kHz — the certification target for
    the from-spec decoder on the SAME packet list."""
    if _opus is None:
        raise RuntimeError("system libopus not available")
    err = C.c_int(0)
    dec = _opus.opus_decoder_create(48_000, channels, C.byref(err))
    if not dec or err.value != 0:
        raise ValueError(f"opus_decoder_create failed ({err.value})")
    try:
        out = []
        maxf = 5760  # 120 ms at 48 kHz, the API maximum
        buf = np.empty((maxf, channels), np.float32)
        for pkt in packets:
            got = _opus.opus_decode_float(
                C.c_void_p(dec), pkt, len(pkt),
                buf.ctypes.data_as(C.POINTER(C.c_float)), maxf, 0)
            if got < 0:
                raise ValueError(f"opus_decode_float failed ({got})")
            out.append(buf[:got].copy())
        return (np.concatenate(out, axis=0) if out
                else np.zeros((0, channels), np.float32))
    finally:
        _opus.opus_decoder_destroy(C.c_void_p(dec))


def opus_ref_encode_ogg(pcm: np.ndarray, *, channels: int | None = None,
                        bitrate: int = 96_000, frame_ms: float = 20.0,
                        force_celt: bool = True) -> bytes:
    """Encode 48 kHz float PCM to an Ogg Opus file (RFC 7845 layout) using
    libopus packets + the in-repo Ogg page writer — real-encoder streams in
    the container load() reads."""
    from .opus import opus_head, opus_tags
    from .ogg import write_pages

    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    if channels is None:
        channels = pcm.shape[1]
    packets, pre_skip = opus_ref_encode_packets(
        pcm, channels=channels, bitrate=bitrate, frame_ms=frame_ms,
        force_celt=force_celt, return_lookahead=True)
    frame = int(round(48_000 * frame_ms / 1000.0))
    # Granule = pre_skip + PCM samples at 48 kHz; final page truncates to
    # the true length (RFC 7845 §4.2/§5.1).
    pkts = [(opus_head(channels, pre_skip), 0), (opus_tags(), 0)]
    gran = 0
    total = pcm.shape[0] + pre_skip
    for i, p in enumerate(packets):
        gran = min(gran + frame, total)
        pkts.append((p, gran))
    return write_pages(pkts)
