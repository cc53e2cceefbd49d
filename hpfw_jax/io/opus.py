"""Opus decode: packet layer (RFC 6716 §3) + Ogg Opus container (RFC 7845).

From-spec standalone decoder for CELT-mode Opus — the music coding mode
every .opus file of music content uses. SILK and hybrid (speech) packets
are rejected with a clear error; they are a documented non-goal for a song
fingerprinting frontend (SURVEY.md §2.1 row 1 scopes the loader to music
formats).

Layering mirrors the reference (libopus) split: this module owns the TOC /
frame-packing / container logic; hpfw_jax/io/_celt_frame.py owns the CELT
frame decode. Certification: tests/test_opus.py decodes real libopus-encoder
streams and compares against opus_decode_float via io/opus_ref.py at the
float32 floor (the same house method as libmpg123 for MPEG, libavcodec for
AAC, libvorbisfile for Vorbis; reference mount empty per SURVEY.md §0).
"""

from __future__ import annotations

import struct

import numpy as np

from ._celt_frame import CELTDecoder
from .ogg import pages_to_packets, parse_pages

# Default pre-skip our Ogg writer advertises (KB: libopus CELT-only
# lookahead is 120 samples + 192 resampler, opusenc convention is 312;
# opus_ref queries the encoder's real lookahead and falls back to this).
PRE_SKIP_DEFAULT = 312

# TOC config -> (mode, bandwidth, frame_ms). Modes: 0 SILK, 1 hybrid, 2 CELT.
_CELT_END_BAND = {"NB": 13, "WB": 17, "SWB": 19, "FB": 21}


def _toc_parse(toc: int) -> tuple[str, str, int]:
    """TOC byte -> (mode, bandwidth, frame_samples at 48 kHz)."""
    config = toc >> 3
    if config < 12:
        mode = "silk"
        bw = ("NB", "MB", "WB")[config >> 2]
        frame = (480, 960, 1920, 2880)[config & 3]
    elif config < 16:
        mode = "hybrid"
        bw = ("SWB", "FB")[(config >> 1) & 1]
        frame = (480, 960)[config & 1]
    else:
        mode = "celt"
        bw = ("NB", "WB", "SWB", "FB")[(config - 16) >> 2]
        frame = (120, 240, 480, 960)[config & 3]
    return mode, bw, frame


def _read_frame_len(data: bytes, pos: int) -> tuple[int, int]:
    """One RFC 6716 §3.2.1 frame length; returns (length, new_pos)."""
    if pos >= len(data):
        raise ValueError("truncated Opus packet (frame length)")
    x = data[pos]
    pos += 1
    if x >= 252:
        if pos >= len(data):
            raise ValueError("truncated Opus packet (frame length ext)")
        x += 4 * data[pos]
        pos += 1
    return x, pos


def parse_packet(pkt: bytes) -> tuple[str, str, int, bool, list[bytes]]:
    """Split an Opus packet -> (mode, bandwidth, frame_samples, stereo,
    frames). Implements codes 0-3 incl. CBR/VBR and padding (§3.2)."""
    if len(pkt) < 1:
        raise ValueError("empty Opus packet")
    toc = pkt[0]
    mode, bw, frame_samples = _toc_parse(toc)
    stereo = bool(toc & 0x4)
    code = toc & 0x3
    body = pkt[1:]
    if code == 0:
        frames = [body]
    elif code == 1:
        if len(body) % 2:
            raise ValueError("code-1 Opus packet with odd payload")
        half = len(body) // 2
        frames = [body[:half], body[half:]]
    elif code == 2:
        n1, pos = _read_frame_len(body, 0)
        if pos + n1 > len(body):
            raise ValueError("code-2 Opus packet frame overruns payload")
        frames = [body[pos:pos + n1], body[pos + n1:]]
    else:
        if len(body) < 1:
            raise ValueError("code-3 Opus packet missing frame count")
        fc = body[0]
        vbr = bool(fc & 0x80)
        has_pad = bool(fc & 0x40)
        m = fc & 0x3F
        if m == 0:
            raise ValueError("code-3 Opus packet with zero frames")
        pos = 1
        pad_len = 0
        if has_pad:
            while True:
                if pos >= len(body):
                    raise ValueError("truncated Opus padding length")
                p = body[pos]
                pos += 1
                pad_len += p if p < 255 else 254
                if p < 255:
                    break
        end = len(body) - pad_len
        if end < pos:
            raise ValueError("Opus padding longer than packet")
        if vbr:
            lens = []
            for _ in range(m - 1):
                ln, pos = _read_frame_len(body, pos)
                lens.append(ln)
            rest = end - pos - sum(lens)
            if rest < 0:
                raise ValueError("VBR Opus frames overrun payload")
            lens.append(rest)
        else:
            if (end - pos) % m:
                raise ValueError("CBR Opus payload not divisible by count")
            lens = [(end - pos) // m] * m
        frames = []
        for ln in lens:
            frames.append(body[pos:pos + ln])
            pos += ln
    if frame_samples * len(frames) > 5760:
        raise ValueError("Opus packet exceeds 120 ms")
    return mode, bw, frame_samples, stereo, frames


class OpusDecoder:
    """Stateful raw-packet Opus decoder (CELT mode), 48 kHz output."""

    def __init__(self, channels: int):
        self.channels = channels
        self._celt = CELTDecoder(channels)

    def decode_packet(self, pkt: bytes) -> np.ndarray:
        """One packet -> (n, channels) float32 PCM at 48 kHz."""
        mode, bw, frame_samples, stereo, frames = parse_packet(pkt)
        if mode != "celt":
            raise ValueError(
                f"unsupported Opus mode '{mode}' (SILK/hybrid speech modes "
                "are out of scope; CELT music streams only)")
        end_band = _CELT_END_BAND[bw]
        c = 2 if stereo else 1
        out = [self._celt.decode_frame(f, frame_samples, c, end_band)
               for f in frames]
        return np.concatenate(out, axis=0)


# -- Ogg Opus (RFC 7845) ---------------------------------------------------------

def opus_head(channels: int, pre_skip: int, *, input_rate: int = 48_000,
              output_gain_q8: int = 0) -> bytes:
    """Build an OpusHead packet (channel mapping family 0)."""
    return (b"OpusHead" + bytes([1, channels])
            + struct.pack("<HIhB", pre_skip, input_rate,
                          output_gain_q8, 0))


def opus_tags(vendor: bytes = b"hpfw_jax") -> bytes:
    return (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
            + struct.pack("<I", 0))


def _parse_head(pkt: bytes) -> tuple[int, int, float]:
    """OpusHead -> (channels, pre_skip, linear output gain)."""
    if pkt[:8] != b"OpusHead" or len(pkt) < 19:
        raise ValueError("missing OpusHead")
    version = pkt[8]
    if version >> 4 != 0:
        raise ValueError(f"unsupported OpusHead version {version}")
    channels = pkt[9]
    pre_skip, _rate, gain_q8, family = struct.unpack("<HIhB", pkt[10:19])
    if family != 0:
        raise ValueError(
            f"unsupported Opus channel mapping family {family} "
            "(mono/stereo only)")
    if channels not in (1, 2):
        raise ValueError(f"bad channel count {channels} for family 0")
    gain = float(10.0 ** (gain_q8 / (20.0 * 256.0)))
    return channels, pre_skip, gain


def decode_opus_packets(packets: list[bytes], channels: int) -> np.ndarray:
    """Decode raw Opus packets with one stateful decoder -> (n, channels)
    float32 at 48 kHz (the packet-level certification entry point)."""
    dec = OpusDecoder(channels)
    out = [dec.decode_packet(p) for p in packets if len(p) > 0]
    return (np.concatenate(out, axis=0) if out
            else np.zeros((0, channels), np.float32))


def decode_opus(data: bytes) -> tuple[np.ndarray, int]:
    """Ogg Opus bytes -> (mono float32 PCM in [-1, 1], 48000).

    Honors pre-skip, output gain, and end trimming via the final granule
    position (RFC 7845 §4.2/§5.1)."""
    packets = pages_to_packets(parse_pages(data))
    if len(packets) < 2:
        raise ValueError("Ogg Opus stream has no audio packets")
    channels, pre_skip, gain = _parse_head(packets[0][0])
    if packets[1][0][:8] != b"OpusTags":
        raise ValueError("missing OpusTags")
    dec = OpusDecoder(channels)
    chunks = []
    total = 0
    last_granule = -1
    for pkt, granule in packets[2:]:
        if not pkt:
            continue
        pcm = dec.decode_packet(pkt)
        chunks.append(pcm)
        total += pcm.shape[0]
        if granule >= 0:
            last_granule = granule
    if not chunks:
        raise ValueError("Ogg Opus stream has no audio packets")
    pcm = np.concatenate(chunks, axis=0)
    if last_granule >= 0:
        pcm = pcm[:max(0, min(total, last_granule))]
    pcm = pcm[min(pre_skip, pcm.shape[0]):]
    mono = pcm.mean(axis=1) if pcm.shape[1] > 1 else pcm[:, 0]
    if gain != 1.0:
        mono = mono * np.float32(gain)
    return mono.astype(np.float32), 48_000
