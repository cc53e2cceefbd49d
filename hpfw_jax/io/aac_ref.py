"""Validation-only wrapper for the system libavcodec AAC implementation.

NOT part of any decode path — `hpfw_jax.io.aac` is a standalone from-spec
decoder. This module exists so tests and the table-recovery tooling can
certify that decoder against a real reference implementation (ffmpeg's
AAC decoder) and generate real-encoder fixtures (ffmpeg's native AAC-LC
encoder), the same role io/mpeg_ref.py (libmpg123/lame) and
io/vorbis_ref.py (libvorbis) play for MPEG audio and Vorbis.

The actual libavcodec calls live in a small C shim
(native/hpfw_aac_ref.c, built on demand by `make -C native aacref`)
because libavcodec's structs are not a stable ctypes target; only flat
buffers cross this boundary. Degrades to available() == False when the
shim cannot be built (no ffmpeg dev libraries on the machine).

Reference parity: SURVEY.md §2.1 row 1 — the C++ reference wraps an
Essentia-class loader whose codec coverage includes AAC (mount empty,
recollection); here the codec is reimplemented from spec and the system
library is used only as a test oracle.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhpfw_aacref.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-s", "aacref"],
                           cwd=os.path.abspath(_NATIVE_DIR), check=True,
                           capture_output=True)
        lib = C.CDLL(_LIB_PATH)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.hpfw_aacref_decode2.restype = C.c_int
    lib.hpfw_aacref_decode2.argtypes = [
        C.POINTER(C.c_uint8), C.c_long, C.POINTER(C.c_float), C.c_long,
        C.POINTER(C.c_int), C.POINTER(C.c_int), C.c_int]
    lib.hpfw_aacref_encode.restype = C.c_int
    lib.hpfw_aacref_encode.argtypes = [
        C.POINTER(C.c_float), C.c_long, C.c_int, C.c_int, C.c_int,
        C.POINTER(C.c_uint8), C.c_long]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


ADTS_RATES = (96000, 88200, 64000, 48000, 44100, 32000,
              24000, 22050, 16000, 12000, 11025, 8000)


def count_adts_frames(data: bytes) -> tuple[int, int]:
    """(n_frames, channels) by walking ADTS headers — used only to bound
    the decode output allocation."""
    n, ch, pos = 0, 0, 0
    while pos + 7 <= len(data):
        if data[pos] != 0xFF or (data[pos + 1] & 0xF6) != 0xF0:
            pos += 1
            continue
        if not ch:
            ch = ((data[pos + 2] & 1) << 2) | (data[pos + 3] >> 6)
        flen = ((data[pos + 3] & 3) << 11) | (data[pos + 4] << 3) \
            | (data[pos + 5] >> 5)
        if flen < 7:
            pos += 1
            continue
        n += 1
        pos += flen
    return n, max(ch, 1)


def aac_decode_ref(data: bytes, strict: bool = False):
    """Reference-decode an ADTS AAC stream with system libavcodec.

    Returns (pcm float32 (n_samples, channels), sample_rate). With
    strict=True the decoder runs under AV_EF_EXPLODE-class error
    recognition, so malformed streams raise instead of being concealed —
    the probe tooling's parse-failure signal."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libavcodec AAC reference shim unavailable")
    nf, ch = count_adts_frames(data)
    # +2 frames of slack for encoder delay conventions; 2048 covers the
    # (not emitted by any known encoder) 960-frame and SBR upsampled cases.
    cap = (nf + 2) * 2048 * ch
    out = np.empty(cap, np.float32)
    sr = C.c_int(0)
    nch = C.c_int(0)
    buf = (C.c_uint8 * len(data)).from_buffer_copy(data)
    r = lib.hpfw_aacref_decode2(
        buf, len(data), out.ctypes.data_as(C.POINTER(C.c_float)), cap,
        C.byref(sr), C.byref(nch), 1 if strict else 0)
    if r < 0:
        raise ValueError(f"libavcodec AAC decode failed ({r})")
    pcm = out[: r * nch.value].reshape(r, nch.value).copy()
    return pcm, sr.value


def aac_encode(pcm: np.ndarray, sample_rate: int,
               bitrate_kbps: int = 128) -> bytes:
    """Encode PCM (mono (n,) or (n, ch) float32) to an ADTS AAC-LC stream
    with ffmpeg's native AAC encoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libavcodec AAC reference shim unavailable")
    x = np.asarray(pcm, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    x = np.ascontiguousarray(x)
    cap = max(1 << 16, int(n * ch * 4 + (n // 1024 + 8) * 64))
    out = np.empty(cap, np.uint8)
    r = lib.hpfw_aacref_encode(
        x.ctypes.data_as(C.POINTER(C.c_float)), n, int(sample_rate), ch,
        int(bitrate_kbps) * 1000,
        out.ctypes.data_as(C.POINTER(C.c_uint8)), cap)
    if r < 0:
        raise ValueError(f"libavcodec AAC encode failed ({r})")
    return bytes(out[:r])
