"""Vorbis I decode (pure NumPy/Python) + a minimal encoder for fixtures.

The reference wraps a native audio library whose most common real-world
inputs are lossy codecs (SURVEY.md §2.1 row 1; VERDICT r2 missing #1).
This module implements the Vorbis I setup and audio bitstream from the
specification: LSB-first bit unpacking, codebook parse (ordered and sparse
length lists, lookup types 0/1/2 with float32_unpack VQ tables), canonical
first-fit Huffman assignment, floor type 1 (posts, low/high-neighbor
prediction, Bresenham render in the dB-multiplier domain), residue types
0/1/2 with cascade passes and classword decode, channel mapping with
magnitude/angle coupling inversion, window-slope handling for long/short
block transitions, the unnormalized Vorbis IMDCT, overlap-add with granule
trimming, and Ogg transport with page CRCs (io/ogg.py).

Floor type 0 (legacy LSP floors, rare in practice since ~2002) is detected
and rejected with a clear error rather than silently misdecoded.

No Vorbis tooling exists in this offline environment, so fixtures come from
`encode_vorbis` below — a real (if simple) encoder: windowed MDCT, a flat
two-post floor-1 per block, one residue pass with self-designed fixed-length
codebooks carried in-band (Vorbis decoders are codebook-generic, so simple
books are fully spec-valid). Its output round-trips through this decoder
and the C++ twin (native/hpfw_native.cc, hpfw_vorbis_decode); the
floor1_inverse_dB table is generated from the spec's endpoint constants
(1.0649863e-07 .. 1.0), identical in both twins.
"""

from __future__ import annotations

import struct

import numpy as np

from .ogg import pages_to_packets, parse_pages, write_pages


def ilog(x: int) -> int:
    n = 0
    while x > 0:
        n += 1
        x >>= 1
    return n


def float32_unpack(x: int) -> float:
    mant = x & 0x1FFFFF
    exp = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mant = -mant
    return float(mant) * 2.0 ** (exp - 788)


def float32_pack(v: float) -> int:
    """Inverse of float32_unpack (encoder side; nearest representation)."""
    if v == 0.0:
        return 0
    sign = 0x80000000 if v < 0 else 0
    v = abs(v)
    exp = 788
    while v >= (1 << 21) - 0.5:
        v /= 2.0
        exp += 1
    while v < (1 << 20) and exp > 0:
        v *= 2.0
        exp -= 1
    return sign | (exp << 21) | int(round(v))


def lookup1_values(entries: int, dim: int) -> int:
    v = 1
    while (v + 1) ** dim <= entries:
        v += 1
    return v


_INV_DB_LO = 1.0649863e-07     # spec table endpoints; exponential in between
_INV_DB_TABLE = (_INV_DB_LO *
                 np.exp(np.arange(256) / 255.0 * np.log(1.0 / _INV_DB_LO))
                 ).astype(np.float64)


class BitReader:
    """Vorbis bit packing: LSB-first within each byte."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                                  bitorder="little")
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        b = self.bits[self.pos:self.pos + n]
        if b.shape[0] < n:
            raise ValueError("Vorbis packet truncated")
        self.pos += n
        v = 0
        for i, bit in enumerate(b.tolist()):
            v |= bit << i
        return v

    def read_bit(self) -> int:
        if self.pos >= self.bits.shape[0]:
            raise ValueError("Vorbis packet truncated")
        v = int(self.bits[self.pos])
        self.pos += 1
        return v

    def eof(self) -> bool:
        return self.pos >= self.bits.shape[0]


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def write(self, v: int, n: int) -> None:
        for i in range(n):
            self.bits.append((v >> i) & 1)

    def bytes(self) -> bytes:
        arr = np.array(self.bits, dtype=np.uint8)
        return np.packbits(arr, bitorder="little").tobytes()


def assign_codewords(lengths: list[int]):
    """First-fit canonical Huffman assignment in entry order (the spec's
    tree-filling): each used entry takes the lexicographically smallest
    available codeword of its length. Returns (codes, decode_tree) where
    codes[i] = (codeword_msb_first, length) or None for unused entries and
    decode_tree is nested {bit: subtree-or-entry}."""
    root: list = [None, None]   # binary tree; int leaf = entry
    codes: list = [None] * len(lengths)
    used = [i for i, l in enumerate(lengths) if l > 0]
    for i in used:
        l = lengths[i]
        # DFS preferring the 0 branch for the smallest codeword.
        path = _alloc(root, l)
        if path is None:
            raise ValueError("overspecified Vorbis codebook")
        node = root
        for b in path[:-1]:
            if node[b] is None:
                node[b] = [None, None]
            node = node[b]
        node[path[-1]] = i
        code = 0
        for b in path:
            code = (code << 1) | b
        codes[i] = (code, l)
    return codes, root


def _alloc(node, length):
    """Smallest free codeword of `length` bits under `node` (0-branch
    first => lexicographically smallest), or None if the subtree is full."""
    for b in (0, 1):
        child = node[b]
        if length == 1:
            if child is None:
                return [b]
            continue                       # occupied leaf or internal node
        if isinstance(child, int):
            continue                       # assigned leaf shadows this prefix
        if child is None:
            return [b] + [0] * (length - 1)
        sub = _alloc(child, length - 1)
        if sub is not None:
            return [b] + sub
    return None


class Codebook:
    def __init__(self, br: BitReader):
        if br.read(24) != 0x564342:
            raise ValueError("bad Vorbis codebook sync")
        self.dim = br.read(16)
        self.entries = br.read(24)
        lengths = [0] * self.entries
        if br.read_bit():                          # ordered
            cur_len = br.read(5) + 1
            cur = 0
            while cur < self.entries:
                num = br.read(ilog(self.entries - cur))
                if cur + num > self.entries:
                    raise ValueError("Vorbis codebook length overflow")
                for i in range(cur, cur + num):
                    lengths[i] = cur_len
                cur += num
                cur_len += 1
        else:
            sparse = br.read_bit()
            for i in range(self.entries):
                if sparse:
                    if br.read_bit():
                        lengths[i] = br.read(5) + 1
                else:
                    lengths[i] = br.read(5) + 1
        self.lengths = lengths
        n_used = sum(1 for l in lengths if l)
        if n_used == 1:
            # Single-used-entry book: codeword is `length` zero bits.
            self.single = next(i for i, l in enumerate(lengths) if l)
            self.codes, self.tree = None, None
        else:
            self.single = None
            self.codes, self.tree = assign_codewords(lengths)

        self.lookup = br.read(4)
        self.vectors = None
        if self.lookup in (1, 2):
            minv = float32_unpack(br.read(32))
            delta = float32_unpack(br.read(32))
            value_bits = br.read(4) + 1
            sequence_p = br.read_bit()
            count = (lookup1_values(self.entries, self.dim)
                     if self.lookup == 1 else self.entries * self.dim)
            mult = [br.read(value_bits) for _ in range(count)]
            vec = np.zeros((self.entries, self.dim))
            if self.lookup == 1:
                lv = lookup1_values(self.entries, self.dim)
                for e in range(self.entries):
                    last = 0.0
                    idx_div = 1
                    for d in range(self.dim):
                        off = (e // idx_div) % lv
                        v = mult[off] * delta + minv + last
                        if sequence_p:
                            last = v
                        vec[e, d] = v
                        idx_div *= lv
            else:
                for e in range(self.entries):
                    last = 0.0
                    for d in range(self.dim):
                        v = mult[e * self.dim + d] * delta + minv + last
                        if sequence_p:
                            last = v
                        vec[e, d] = v
            self.vectors = vec
        elif self.lookup != 0:
            raise ValueError(f"reserved Vorbis lookup type {self.lookup}")

    def decode_scalar(self, br: BitReader) -> int:
        if self.single is not None:
            br.read(self.lengths[self.single])
            return self.single
        node = self.tree
        while not isinstance(node, int):
            node = node[br.read_bit()]
            if node is None:
                raise ValueError("invalid Vorbis codeword")
        return node

    def decode_vector(self, br: BitReader) -> np.ndarray:
        e = self.decode_scalar(br)
        if self.vectors is None:
            raise ValueError("scalar codebook used in VQ context")
        return self.vectors[e]


class Floor1:
    def __init__(self, br: BitReader):
        self.partitions = br.read(5)
        self.class_list = [br.read(4) for _ in range(self.partitions)]
        n_classes = max(self.class_list) + 1 if self.partitions else 0
        self.class_dims = []
        self.class_subs = []
        self.masterbooks = []
        self.subclass_books = []
        for c in range(n_classes):
            self.class_dims.append(br.read(3) + 1)
            subs = br.read(2)
            self.class_subs.append(subs)
            self.masterbooks.append(br.read(8) if subs else -1)
            self.subclass_books.append(
                [br.read(8) - 1 for _ in range(1 << subs)])
        self.multiplier = br.read(2) + 1
        rangebits = br.read(4)
        self.rangebits = rangebits
        xs = [0, 1 << rangebits]
        for p in range(self.partitions):
            for _ in range(self.class_dims[self.class_list[p]]):
                xs.append(br.read(rangebits))
        self.x_list = xs
        if len(set(xs)) != len(xs):
            raise ValueError("non-unique Vorbis floor1 X values")

    def decode(self, br: BitReader, books: list, n2: int):
        """Returns the floor curve (n2 float64) or None (unused channel)."""
        if not br.read_bit():
            return None
        rng = [256, 128, 86, 64][self.multiplier - 1]
        ybits = ilog(rng - 1)
        y = [br.read(ybits), br.read(ybits)]
        for p in range(self.partitions):
            cls = self.class_list[p]
            cdim = self.class_dims[cls]
            cbits = self.class_subs[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[self.masterbooks[cls]].decode_scalar(br)
            for _ in range(cdim):
                book = self.subclass_books[cls][cval & csub]
                cval >>= cbits
                y.append(books[book].decode_scalar(br) if book >= 0 else 0)
        return self._synthesize(y, rng, n2)

    def _synthesize(self, y, rng, n2):
        count = len(self.x_list)
        final = [0] * count
        step2 = [False] * count
        final[0], final[1] = y[0], y[1]
        step2[0] = step2[1] = True
        for i in range(2, count):
            lo = _low_neighbor(self.x_list, i)
            hi = _high_neighbor(self.x_list, i)
            if lo < 0 or hi < 0:
                raise ValueError("Vorbis floor1 post without neighbors")
            pred = _render_point(self.x_list[lo], final[lo],
                                 self.x_list[hi], final[hi], self.x_list[i])
            val = y[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    final[i] = (val - lowroom + pred if highroom > lowroom
                                else pred - (val - highroom) - 1)
                elif val & 1:
                    final[i] = pred - ((val + 1) >> 1)
                else:
                    final[i] = pred + (val >> 1)
            else:
                step2[i] = False
                final[i] = pred
        order = sorted(range(count), key=lambda i: self.x_list[i])
        out = np.zeros(n2, dtype=np.int64)
        hx = 0
        hy = final[order[0]] * self.multiplier
        lx, ly = 0, hy
        for i in order:
            if not step2[i]:
                continue
            hx = min(self.x_list[i], n2)
            hy = final[i] * self.multiplier
            if hx > lx:
                _render_line(lx, ly, self.x_list[i], hy, out, n2)
            lx, ly = self.x_list[i], hy
            if lx >= n2:
                break
        if hx < n2:
            out[hx:] = hy
        np.clip(out, 0, 255, out=out)
        return _INV_DB_TABLE[out]


def _low_neighbor(v, i):
    best = -1
    for n in range(i):
        if v[n] < v[i] and (best < 0 or v[n] > v[best]):
            best = n
    return best


def _high_neighbor(v, i):
    best = -1
    for n in range(i):
        if v[n] > v[i] and (best < 0 or v[n] < v[best]):
            best = n
    return best


def _render_point(x0, y0, x1, y1, x):
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, v, n2):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    base = int(dy / adx) if adx else 0            # C truncation division
    sy = base - 1 if dy < 0 else base + 1
    ady -= abs(base) * adx
    x, y, err = x0, y0, 0
    if 0 <= x < n2:
        v[x] = y
    for x in range(x0 + 1, min(x1, n2)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = y


class Residue:
    def __init__(self, rtype: int, br: BitReader):
        self.rtype = rtype
        self.begin = br.read(24)
        self.end = br.read(24)
        self.partition_size = br.read(24) + 1
        self.classifications = br.read(6) + 1
        self.classbook = br.read(8)
        cascades = []
        for _ in range(self.classifications):
            low = br.read(3)
            high = br.read(5) if br.read_bit() else 0
            cascades.append((high << 3) | low)
        self.cascades = cascades
        self.books = []
        for c in range(self.classifications):
            row = []
            for p in range(8):
                row.append(br.read(8) if cascades[c] & (1 << p) else -1)
            self.books.append(row)

    def decode(self, br: BitReader, books: list, vectors, do_not_decode):
        """In-place residue decode into vectors (list of float64 arrays)."""
        ch = len(vectors)
        n2 = vectors[0].shape[0]
        if self.rtype == 2:
            if all(do_not_decode):
                return
            inter = np.zeros(ch * n2)
            self._decode_core(br, books, [inter], [False], ch * n2)
            for c in range(ch):
                vectors[c] += inter[c::ch]
            return
        self._decode_core(br, books, vectors, do_not_decode, n2)

    def _decode_core(self, br, books, vectors, do_not_decode, n):
        ch = len(vectors)
        begin = min(self.begin, n)
        end = min(self.end, n)
        n_read = end - begin
        if n_read <= 0:
            return
        psize = self.partition_size
        parts = n_read // psize
        classbook = books[self.classbook]
        cw = classbook.dim
        classifs = [[0] * (parts + cw) for _ in range(ch)]
        for pass_i in range(8):
            p = 0
            while p < parts:
                if pass_i == 0:
                    for c in range(ch):
                        if do_not_decode[c]:
                            continue
                        temp = classbook.decode_scalar(br)
                        for i in range(cw - 1, -1, -1):
                            classifs[c][p + i] = temp % self.classifications
                            temp //= self.classifications
                for _ in range(cw):
                    if p >= parts:
                        break
                    for c in range(ch):
                        if do_not_decode[c]:
                            continue
                        vq = self.books[classifs[c][p]][pass_i]
                        if vq < 0:
                            continue
                        self._decode_partition(
                            br, books[vq], vectors[c], begin + p * psize)
                    p += 1

    def _decode_partition(self, br, book, v, offset):
        psize = self.partition_size
        dim = book.dim
        if offset + psize > v.shape[0]:
            raise ValueError("Vorbis residue partition out of range")
        if self.rtype == 0:
            step = psize // dim
            for i in range(step):
                vec = book.decode_vector(br)
                for d in range(dim):
                    v[offset + i + d * step] += vec[d]
        else:                               # types 1 and 2 (post-interleave)
            i = 0
            while i < psize:
                vec = book.decode_vector(br)
                end = min(offset + i + dim, v.shape[0])
                v[offset + i: end] += vec[: end - offset - i]
                i += dim


class Mapping:
    def __init__(self, br: BitReader, channels: int):
        self.submaps = br.read(4) + 1 if br.read_bit() else 1
        self.coupling = []
        if br.read_bit():
            steps = br.read(8) + 1
            bits = ilog(channels - 1)
            for _ in range(steps):
                self.coupling.append((br.read(bits), br.read(bits)))
        if br.read(2) != 0:
            raise ValueError("nonzero reserved bits in Vorbis mapping")
        if self.submaps > 1:
            self.mux = [br.read(4) for _ in range(channels)]
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            br.read(8)                      # unused time configuration
            self.submap_floor.append(br.read(8))
            self.submap_residue.append(br.read(8))


class Mode:
    def __init__(self, br: BitReader, n_mappings: int):
        self.blockflag = br.read_bit()
        if br.read(16) != 0 or br.read(16) != 0:
            raise ValueError("nonzero Vorbis window/transform type")
        self.mapping = br.read(8)
        if self.mapping >= n_mappings:
            raise ValueError("Vorbis mode references unknown mapping")


def _vorbis_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.sin(0.5 * np.pi *
                  np.sin(np.pi / n * (i + 0.5)) ** 2)


def _block_window(n: int, left_n: int, right_n: int) -> np.ndarray:
    """Block window with possibly-narrowed slopes (long/short lapping):
    left slope of width left_n/2 centered at n/4, right slope of width
    right_n/2 centered at 3n/4, flat 1 between, 0 outside. Shared by the
    decoder and the mixed-block encoder so lapping always matches."""
    win = np.zeros(n)
    ls = n // 4 - left_n // 4
    rs = 3 * n // 4 - right_n // 4
    win[ls: ls + left_n // 2] = _vorbis_window(left_n)[: left_n // 2]
    win[ls + left_n // 2: rs] = 1.0
    win[rs: rs + right_n // 2] = _vorbis_window(right_n)[right_n // 2:]
    return win


_IMDCT_CACHE: dict[int, np.ndarray] = {}


def _imdct_matrix(n: int) -> np.ndarray:
    m = _IMDCT_CACHE.get(n)
    if m is None:
        n2 = n // 2
        j = np.arange(n, dtype=np.float64)[:, None]
        k = np.arange(n2, dtype=np.float64)[None, :]
        m = np.cos(2.0 * np.pi / n * (j + 0.5 + n2 / 2.0) * (k + 0.5))
        _IMDCT_CACHE[n] = m
    return m


def imdct(spec: np.ndarray) -> np.ndarray:
    """Unnormalized Vorbis IMDCT: (n/2,) spectrum -> (n,) time block."""
    return _imdct_matrix(spec.shape[0] * 2) @ spec


class _Setup:
    pass


def _parse_headers(packets):
    ident, comment, setup = packets[0][0], packets[1][0], packets[2][0]
    if ident[:7] != b"\x01vorbis":
        raise ValueError("missing Vorbis identification header")
    version, channels, rate = struct.unpack("<IBI", ident[7:16])
    if version != 0:
        raise ValueError(f"unsupported Vorbis version {version}")
    bs = ident[28]
    bs0, bs1 = 1 << (bs & 0xF), 1 << (bs >> 4)
    if not (64 <= bs0 <= 8192 and bs0 <= bs1 <= 8192):
        raise ValueError("invalid Vorbis block sizes")
    if not ident[29] & 1:
        raise ValueError("missing Vorbis framing bit")
    if comment[:7] != b"\x03vorbis":
        raise ValueError("missing Vorbis comment header")
    if setup[:7] != b"\x05vorbis":
        raise ValueError("missing Vorbis setup header")
    br = BitReader(setup[7:])
    s = _Setup()
    s.channels, s.rate, s.bs = channels, rate, (bs0, bs1)
    s.codebooks = [Codebook(br) for _ in range(br.read(8) + 1)]
    for _ in range(br.read(6) + 1):             # time transforms (placeholder)
        if br.read(16) != 0:
            raise ValueError("nonzero Vorbis time transform")
    s.floors = []
    for _ in range(br.read(6) + 1):
        ftype = br.read(16)
        if ftype == 1:
            s.floors.append(Floor1(br))
        elif ftype == 0:
            raise ValueError(
                "Vorbis floor type 0 (legacy LSP) is not supported")
        else:
            raise ValueError(f"reserved Vorbis floor type {ftype}")
    s.residues = []
    for _ in range(br.read(6) + 1):
        rtype = br.read(16)
        if rtype > 2:
            raise ValueError(f"reserved Vorbis residue type {rtype}")
        s.residues.append(Residue(rtype, br))
    s.mappings = []
    for _ in range(br.read(6) + 1):
        if br.read(16) != 0:
            raise ValueError("reserved Vorbis mapping type")
        s.mappings.append(Mapping(br, channels))
    s.modes = [Mode(br, len(s.mappings)) for _ in range(br.read(6) + 1)]
    if not br.read_bit():
        raise ValueError("missing Vorbis setup framing bit")
    return s


def decode_vorbis(data: bytes) -> tuple[np.ndarray, int]:
    """Ogg Vorbis bytes -> (mono float32 PCM in [-1, 1], sample_rate)."""
    packets = pages_to_packets(parse_pages(data))
    if len(packets) < 4:
        raise ValueError("Vorbis stream has no audio packets")
    s = _parse_headers(packets)
    ch = s.channels
    mode_bits = ilog(len(s.modes) - 1)
    prev_right = None                 # per-channel right halves awaiting OLA
    prev_n = 0
    out = [[] for _ in range(ch)]
    granule = -1
    for pkt, gr in packets[3:]:
        br = BitReader(pkt)
        if br.read_bit() != 0:
            raise ValueError("audio packet with header packet type")
        mode = s.modes[br.read(mode_bits)]
        mapping = s.mappings[mode.mapping]
        n = s.bs[mode.blockflag]
        long_block = mode.blockflag
        wflag_prev = wflag_next = 1
        if long_block:
            wflag_prev = br.read_bit()
            wflag_next = br.read_bit()
        n2 = n // 2
        floors = []
        no_residue = []
        for c in range(ch):
            fl = s.floors[mapping.submap_floor[mapping.mux[c]]]
            curve = fl.decode(br, s.codebooks, n2)
            floors.append(curve)
            no_residue.append(curve is None)
        for (mag, ang) in mapping.coupling:
            if not (no_residue[mag] and no_residue[ang]):
                no_residue[mag] = no_residue[ang] = False
        residues = [np.zeros(n2) for _ in range(ch)]
        for sm in range(mapping.submaps):
            chans = [c for c in range(ch) if mapping.mux[c] == sm]
            res = s.residues[mapping.submap_residue[sm]]
            res.decode(br, s.codebooks,
                       [residues[c] for c in chans],
                       [no_residue[c] for c in chans])
        for (mag, ang) in reversed(mapping.coupling):
            m, a = residues[mag], residues[ang]
            new_m = np.where(m > 0, np.where(a > 0, m, m + a),
                             np.where(a > 0, m, m - a))
            new_a = np.where(m > 0, np.where(a > 0, m - a, m),
                             np.where(a > 0, m + a, m))
            residues[mag], residues[ang] = new_m, new_a
        pcm_blocks = []
        for c in range(ch):
            if floors[c] is None:
                pcm_blocks.append(np.zeros(n))
                continue
            spec = floors[c] * residues[c]
            pcm_blocks.append(imdct(spec))
        # Window slopes: a long block abutting a short one uses the short
        # slope centered in its half (spec 1.3.2); equal sizes use full
        # halves.
        bs0 = s.bs[0]
        left_n = bs0 if (long_block and not wflag_prev) else n
        right_n = bs0 if (long_block and not wflag_next) else n
        win = _block_window(n, left_n, right_n)
        new_right = [None] * ch
        for c in range(ch):
            blk = pcm_blocks[c]
            blk = blk * win
            left = blk[:n2]
            if prev_right is not None:
                # Returned samples span [center(prev), center(cur)) =
                # prev_n/4 + n/4 samples. The previous right half is zero
                # past that span (its slope ends at the current center) and
                # the current left half is zero before it — both clipped.
                pr = prev_right[c]
                span = prev_n // 4 + n // 4
                buf = np.zeros(span)
                m = min(pr.shape[0], span)
                buf[:m] += pr[:m]
                shift = span - n2           # current-left offset into span
                j0 = max(0, -shift)
                buf[shift + j0: shift + n2] += left[j0:]
                out[c].append(buf)
            new_right[c] = blk[n2:]
        prev_right = new_right
        prev_n = n
        if gr >= 0:
            granule = gr
    if not out[0]:
        raise ValueError("Vorbis stream decoded no audio")
    chans = [np.concatenate(o) for o in out]
    total = chans[0].shape[0]
    if granule >= 0:
        total = min(total, granule)
    mono = np.mean(np.stack([c[:total] for c in chans], axis=1), axis=1)
    return mono.astype(np.float32), s.rate


# ---------------------------------------------------------------------------
# Minimal encoder (fixture generation; real, spec-conforming output).
#
# One mode (short blocks only), a flat two-post floor 1 per block (the
# partitions=0 degenerate form needs no floor codebooks), one residue pass
# with two self-designed fixed-length codebooks: a lookup-0 classbook and a
# lookup-2 VQ book whose multiplicand table enumerates base-q digit pairs.
# Vorbis decoders are fully codebook-generic, so this is spec-valid output
# any conformant decoder accepts. No psychoacoustics — fixtures, not music
# compression (same stance as io/flac.py's encoder).
# ---------------------------------------------------------------------------

_Q = 31                    # VQ levels per dimension (odd: symmetric zero)
_VDIM = 2                  # VQ vector dimension
_PSIZE = 32                # residue partition size
_CLASSWORDS = 4            # classbook dimension


def _inv_db_index(v: float) -> int:
    """Nearest floor1 table index for amplitude v."""
    if v <= _INV_DB_LO:
        return 0
    i = int(round(255.0 * np.log(v / _INV_DB_LO) / np.log(1.0 / _INV_DB_LO)))
    return max(0, min(255, i))


def _write_codebook_header(bw: BitWriter, dim: int, entries: int,
                           length: int, lookup: int,
                           minv: float = 0.0, delta: float = 0.0,
                           mult: list | None = None) -> None:
    bw.write(0x564342, 24)
    bw.write(dim, 16)
    bw.write(entries, 24)
    bw.write(0, 1)                  # not ordered
    bw.write(0, 1)                  # not sparse
    for _ in range(entries):
        bw.write(length - 1, 5)
    bw.write(lookup, 4)
    if lookup == 2:
        bw.write(float32_pack(minv), 32)
        bw.write(float32_pack(delta), 32)
        value_bits = ilog(max(mult)) if mult else 1
        bw.write(value_bits - 1, 4)
        bw.write(0, 1)              # sequence_p
        for m in mult:
            bw.write(m, value_bits)


def _setup_packet(channels: int, n2s: list, residue_type: int) -> bytes:
    """Setup header: one floor, one residue+mapping per distinct block size
    (floor rangebits must cover each size's n/2), one mode per block size
    (mode 0 short, mode 1 long when two sizes)."""
    bw = BitWriter()
    # --- codebooks ---
    bw.write(1, 8)                  # count - 1 = 1 -> 2 books
    class_entries = 2 ** _CLASSWORDS         # classifications=2
    _write_codebook_header(bw, _CLASSWORDS, class_entries,
                           ilog(class_entries - 1), 0)
    q = _Q
    delta = 2.0 / (q - 1)
    minv = -(q - 1) / 2 * delta
    mult = []
    for e in range(q * q):
        mult += [e // q, e % q]
    vq_len = ilog(q * q - 1)
    _write_codebook_header(bw, _VDIM, q * q, vq_len, 2,
                           minv=minv, delta=delta, mult=mult)
    # --- time transforms ---
    bw.write(0, 6)
    bw.write(0, 16)
    # --- floors: one floor 1 per block size, partitions=0 (two posts) ---
    bw.write(len(n2s) - 1, 6)
    for n2 in n2s:
        bw.write(1, 16)
        bw.write(0, 5)              # partitions
        bw.write(0, 2)              # multiplier - 1
        bw.write(ilog(n2 - 1), 4)   # rangebits: 2^rb == n2 for pow2 n2
    # --- residues: one per block size (begin/end are size-specific) ---
    bw.write(len(n2s) - 1, 6)
    for n2 in n2s:
        bw.write(residue_type, 16)
        end = n2 * (channels if residue_type == 2 else 1)
        bw.write(0, 24)             # begin
        bw.write(end, 24)
        bw.write(_PSIZE - 1, 24)
        bw.write(1, 6)              # classifications - 1 = 1 -> 2 classes
        bw.write(0, 8)              # classbook = book 0
        bw.write(1, 3)              # class 0 cascade low bits: pass 0
        bw.write(0, 1)
        bw.write(0, 3)              # class 1 cascade: unused
        bw.write(0, 1)
        bw.write(1, 8)              # class 0 pass 0 -> book 1
    # --- mappings: one per block size ---
    bw.write(len(n2s) - 1, 6)
    for i in range(len(n2s)):
        bw.write(0, 16)             # mapping type 0
        bw.write(0, 1)              # one submap
        bw.write(0, 1)              # no coupling
        bw.write(0, 2)              # reserved
        bw.write(0, 8)              # time config (unused)
        bw.write(i, 8)              # floor i
        bw.write(i, 8)              # residue i
    # --- modes: mode i uses block size i (blockflag = i for two sizes) ---
    bw.write(len(n2s) - 1, 6)
    for i in range(len(n2s)):
        bw.write(i, 1)              # blockflag
        bw.write(0, 16)
        bw.write(0, 16)
        bw.write(i, 8)              # mapping i
    bw.write(1, 1)                  # framing
    return b"\x05vorbis" + bw.bytes()


def _forward_mdct(xw: np.ndarray) -> np.ndarray:
    """Windowed block (n,) -> (n/2,) spectrum; inverse of imdct() under
    power-complementary-window overlap-add (scale 4/n)."""
    n = xw.shape[0]
    return (4.0 / n) * (_imdct_matrix(n).T @ xw)


def encode_vorbis(pcm: np.ndarray, sample_rate: int, *, blocksize: int = 512,
                  residue_type: int = 2,
                  long_blocksize: int | None = None) -> bytes:
    """Encode float PCM (mono (N,) or stereo (N, 2)) as Ogg Vorbis.

    With long_blocksize set, the stream mixes short (blocksize) and long
    blocks on a fixed pattern, exercising the long/short window-transition
    lapping in decoders (slope narrowing + unequal-span overlap-add).
    """
    if residue_type not in (0, 1, 2):
        raise ValueError("residue_type must be 0, 1 or 2")
    x = np.asarray(pcm, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n_samples, ch = x.shape
    sizes = [blocksize] if long_blocksize is None else [blocksize,
                                                        long_blocksize]
    for n in sizes:
        assert n & (n - 1) == 0 and 64 <= n <= 8192
    assert sizes == sorted(sizes)
    bs_byte = (ilog(sizes[0]) - 1) | ((ilog(sizes[-1]) - 1) << 4)
    ident = (b"\x01vorbis" + struct.pack("<IBI", 0, ch, sample_rate)
             + struct.pack("<iii", 0, 0, 0) + bytes([bs_byte, 1]))
    comment = (b"\x03vorbis" + struct.pack("<I", 11) + b"hpfw_jax r3"
               + struct.pack("<I", 0) + b"\x01")
    setup = _setup_packet(ch, [n // 2 for n in sizes], residue_type)

    q = _Q
    delta = 2.0 / (q - 1)
    half_q = (q - 1) // 2
    vq_len = ilog(q * q - 1)
    class_len = ilog(2 ** _CLASSWORDS - 1)
    mode_bits = ilog(len(sizes) - 1)

    # Block-size sequence: short unless mixed, where every 3rd block is
    # short and the rest long (covers long|long, long|short, short|long,
    # short|short junctions).
    def flag_of(b):
        if len(sizes) == 1:
            return 0
        return 0 if b % 3 == 2 else 1

    # Block b spans [c_b - n_b/2, c_b + n_b/2) on an absolute axis where
    # x[0] sits at c_0 (the decoder's first output sample). Emitted span
    # per block b>=1 is n_{b-1}/4 + n_b/4.
    flags = [flag_of(0)]
    centers = [sizes[flags[0]] // 2]
    emitted = 0
    while emitted < n_samples:
        b = len(flags)
        flags.append(flag_of(b))
        n_prev, n_cur = sizes[flags[b - 1]], sizes[flags[b]]
        centers.append(centers[-1] + n_prev // 4 + n_cur // 4)
        emitted += n_prev // 4 + n_cur // 4
    front = centers[0]
    max_n = sizes[-1]
    padded = np.concatenate([np.zeros((front, ch)), x,
                             np.zeros((2 * max_n, ch))])

    packets = [(ident, 0), (comment, 0), (setup, 0)]
    emitted = 0
    for b, (flag, center) in enumerate(zip(flags, centers)):
        n = sizes[flag]
        n2 = n // 2
        left_n = sizes[flags[b - 1]] if b else n
        right_n = sizes[flags[b + 1]] if b + 1 < len(flags) else n
        left_n = min(left_n, n)
        right_n = min(right_n, n)
        win = _block_window(n, left_n, right_n)
        blk = padded[center - n2: center + n2]
        bw = BitWriter()
        bw.write(0, 1)              # audio packet type
        bw.write(flag, mode_bits)   # mode number == blockflag index
        if flag == 1:
            # Edge blocks claim long neighbors (full slopes): their outer
            # halves are never emitted, and this matches the window used
            # for the forward MDCT above.
            bw.write(1 if (b == 0 or flags[b - 1]) else 0, 1)
            bw.write(1 if (b + 1 >= len(flags) or flags[b + 1]) else 0, 1)
        specs = []
        levels = []
        for c in range(ch):
            spec = _forward_mdct(blk[:, c] * win)
            level = _inv_db_index(float(np.abs(spec).max()) + 1e-12)
            bw.write(1, 1)          # floor nonzero
            bw.write(level, 8)      # y0   (range 256 -> 8 bits)
            bw.write(level, 8)      # y1
            specs.append(spec)
            levels.append(level)
        # quantized residue indices per channel
        res_idx = []
        for c in range(ch):
            fl = _INV_DB_TABLE[levels[c]]
            r = specs[c] / fl
            idx = np.clip(np.round(r / delta), -half_q, half_q
                          ).astype(np.int64) + half_q
            res_idx.append(idx)
        if residue_type == 2:
            inter = np.empty(ch * n2, dtype=np.int64)
            for c in range(ch):
                inter[c::ch] = res_idx[c]
            streams = [inter]
        else:
            streams = res_idx
        total = streams[0].shape[0]
        parts = total // _PSIZE
        p = 0
        while p < parts:
            for _ in streams:
                bw.write(0, class_len)          # classword: all class 0
            for _ in range(_CLASSWORDS):
                if p >= parts:
                    break
                for v in streams:
                    off = p * _PSIZE
                    if residue_type == 0:
                        step = _PSIZE // _VDIM
                        for i in range(step):
                            e = (int(v[off + i]) * q
                                 + int(v[off + i + step]))
                            bw.write(_codeword(e, vq_len), vq_len)
                    else:
                        for i in range(0, _PSIZE, _VDIM):
                            e = (int(v[off + i]) * q
                                 + int(v[off + i + 1]))
                            bw.write(_codeword(e, vq_len), vq_len)
                p += 1
        if b:
            emitted += sizes[flags[b - 1]] // 4 + n // 4
        gran = min(emitted, n_samples)
        if b == len(flags) - 1:
            gran = n_samples
        packets.append((bw.bytes(), gran))
    return write_pages(packets)


def _codeword(entry: int, length: int) -> int:
    """Fixed-length first-fit codewords are the entry index MSB-first; the
    bitpacker writes LSB-first, so reverse the bits."""
    v = 0
    for i in range(length):
        v = (v << 1) | ((entry >> i) & 1)
    return v
