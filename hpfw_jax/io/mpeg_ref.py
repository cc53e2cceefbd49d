"""Validation-only ctypes wrappers for system libmpg123 / libmp3lame.

These are NOT part of any decode path — `hpfw_jax.io.mp3` is a standalone
from-spec decoder. This module exists so tests and the table-recovery tool
(`tools/recover_mpeg_window.py`) can compare the in-repo decoder against a
real reference decoder (mpg123) and generate real-world fixtures (lame)
when the system libraries happen to be present. Everything degrades to
``available() == False`` when they are not.

Reference parity note: the C++ reference wraps a native audio library for
lossy-codec decode (SURVEY.md §2.1 row 1 — mount empty, recollection);
here the codec itself is reimplemented from spec and the system library is
used only as a test oracle.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_MONO = 1
_MPG123_STEREO = 2
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10

_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)


def _load(name):
    try:
        return C.CDLL(name)
    except OSError:
        return None


_mpg123 = _load("libmpg123.so.0")
_lame = _load("libmp3lame.so.0")
_twolame = _load("libtwolame.so.0")


def available() -> bool:
    """True when both reference libraries can be loaded."""
    return _mpg123 is not None and _lame is not None


def mpg123_available() -> bool:
    return _mpg123 is not None


def mpg123_decode(data: bytes):
    """Decode an MPEG audio stream with system libmpg123.

    Returns (pcm float32 array of shape (n_samples, channels), sample_rate).
    Uses the feed API with float32 output forced and gapless handling off,
    so the raw decoder output (including filterbank delay) is returned —
    exactly what a from-spec decoder produces.
    """
    m = _mpg123
    if m is None:
        raise RuntimeError("libmpg123 not available")
    m.mpg123_new.restype = C.c_void_p
    m.mpg123_new.argtypes = [C.c_char_p, C.POINTER(C.c_int)]
    m.mpg123_init()
    err = C.c_int(0)
    h = m.mpg123_new(None, C.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    h = C.c_void_p(h)
    try:
        # Force float32 output at every rate/channel combination.
        m.mpg123_format_none(h)
        for r in _RATES:
            m.mpg123_format(h, C.c_long(r), _MPG123_MONO | _MPG123_STEREO,
                            _MPG123_ENC_FLOAT_32)
        if m.mpg123_open_feed(h) != _MPG123_OK:
            raise RuntimeError("mpg123_open_feed failed")
        out = bytearray()
        rate = C.c_long(0)
        channels = C.c_int(0)
        enc = C.c_int(0)
        buf = C.create_string_buffer(1 << 16)
        done = C.c_size_t(0)
        m.mpg123_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t,
                                    C.c_char_p, C.c_size_t,
                                    C.POINTER(C.c_size_t)]
        fed = False
        while True:
            if not fed:
                ret = m.mpg123_decode(h, data, len(data), buf, len(buf),
                                      C.byref(done))
                fed = True
            else:
                ret = m.mpg123_decode(h, None, 0, buf, len(buf),
                                      C.byref(done))
            out += buf.raw[:done.value]
            if ret == _MPG123_NEW_FORMAT:
                m.mpg123_getformat(h, C.byref(rate), C.byref(channels),
                                   C.byref(enc))
                continue
            if ret in (_MPG123_NEED_MORE, _MPG123_DONE):
                break
            if ret < 0:
                raise RuntimeError(f"mpg123_decode error {ret}")
        if channels.value == 0:
            return np.zeros((0, 1), np.float32), 0
        pcm = np.frombuffer(bytes(out), np.float32)
        pcm = pcm.reshape(-1, channels.value)
        return pcm, int(rate.value)
    finally:
        m.mpg123_delete(h)


def lame_available() -> bool:
    return _lame is not None


def twolame_available() -> bool:
    return _twolame is not None


def twolame_encode(pcm: np.ndarray, sr: int, bitrate_kbps: int = 64,
                   mode: int | None = None,
                   error_protection: bool = False) -> bytes:
    """Encode float PCM (n,) or (n, 2) to MPEG Layer II with system
    libtwolame (MPEG-1 at 32/44.1/48 kHz, MPEG-2 LSF at 16/22.05/24 kHz).
    mode: twolame constant (0 stereo, 1 joint, 2 dual, 3 mono);
    error_protection adds the 16-bit CRC after each header."""
    l = _twolame
    if l is None:
        raise RuntimeError("libtwolame not available")
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, ch = pcm.shape
    if mode is None:
        mode = 3 if ch == 1 else 1
    l.twolame_init.restype = C.c_void_p
    g = C.c_void_p(l.twolame_init())
    try:
        l.twolame_set_in_samplerate(g, sr)
        l.twolame_set_out_samplerate(g, sr)
        l.twolame_set_num_channels(g, ch)
        l.twolame_set_bitrate(g, bitrate_kbps)
        l.twolame_set_mode(g, mode)
        if error_protection:
            l.twolame_set_error_protection(g, 1)
        if l.twolame_init_params(g) != 0:
            raise RuntimeError("twolame_init_params failed")
        inter = np.ascontiguousarray(pcm.reshape(-1))
        out = C.create_string_buffer(int(1.25 * n + 7200) + (1 << 14))
        l.twolame_encode_buffer_float32_interleaved.argtypes = [
            C.c_void_p, C.c_void_p, C.c_int, C.c_char_p, C.c_int]
        nb = l.twolame_encode_buffer_float32_interleaved(
            g, inter.ctypes.data_as(C.c_void_p), n, out, len(out))
        if nb < 0:
            raise RuntimeError(f"twolame_encode_buffer failed: {nb}")
        data = out.raw[:nb]
        nb = l.twolame_encode_flush(g, out, len(out))
        if nb < 0:
            raise RuntimeError(f"twolame_encode_flush failed: {nb}")
        return data + out.raw[:nb]
    finally:
        l.twolame_close(C.byref(g))


def lame_encode(pcm: np.ndarray, sr: int, bitrate_kbps: int = 128,
                stereo: bool | None = None, reservoir: bool = True,
                quality: int = 2) -> bytes:
    """Encode float PCM (n,) or (n, 2) to MP3 with system libmp3lame."""
    l = _lame
    if l is None:
        raise RuntimeError("libmp3lame not available")
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, ch = pcm.shape
    if stereo is None:
        stereo = ch == 2
    l.lame_init.restype = C.c_void_p
    g = C.c_void_p(l.lame_init())
    try:
        l.lame_set_in_samplerate(g, sr)
        l.lame_set_out_samplerate(g, sr)
        l.lame_set_num_channels(g, ch)
        l.lame_set_brate(g, bitrate_kbps)
        l.lame_set_mode(g, 1 if stereo else 3)  # JOINT_STEREO / MONO
        l.lame_set_bWriteVbrTag(g, 0)
        l.lame_set_quality(g, quality)
        if not reservoir:
            l.lame_set_disable_reservoir(g, 1)
        if l.lame_init_params(g) < 0:
            raise RuntimeError("lame_init_params failed")
        left = np.ascontiguousarray(pcm[:, 0])
        right = np.ascontiguousarray(pcm[:, 1] if ch == 2 else pcm[:, 0])
        out = C.create_string_buffer(int(1.25 * n + 7200) + (1 << 14))
        l.lame_encode_buffer_ieee_float.argtypes = [
            C.c_void_p, C.c_void_p, C.c_void_p, C.c_int, C.c_char_p, C.c_int]
        nb = l.lame_encode_buffer_ieee_float(
            g, left.ctypes.data_as(C.c_void_p),
            right.ctypes.data_as(C.c_void_p), n, out, len(out))
        if nb < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {nb}")
        data = out.raw[:nb]
        nb = l.lame_encode_flush(g, out, len(out))
        if nb < 0:
            raise RuntimeError(f"lame_encode_flush failed: {nb}")
        return data + out.raw[:nb]
    finally:
        l.lame_close(g)
