"""Recover the MPEG-1 Layer III Huffman tables from the reference decoder.

ISO/IEC 11172-3 Table B.7 defines 32 big-value pair tables plus two
count1 quadruple tables; the spec text is unavailable offline, but the
system's libmpg123 implements them. Each table is a prefix code, so it is
recoverable by walking the code tree with one probe per node:

  A probe granule uses big_values=1, table_select=T and the Huffman area
  set to (candidate bits p) + QUAD_SIG, where QUAD_SIG is a count1
  table-B unit (the fixed 4-bit NOT code, already probe-validated
  against mpg123) that plants +1 at spectral line 5. If p is a complete
  pair unit (codeword + linbits + signs), the decoder consumes exactly
  |p| bits, the count1 stage then decodes QUAD_SIG, and the PCM readout
  shows [pair at lines 0-1, +1 at line 5, nothing else]. Any prefix,
  overrun, or misalignment destroys the line-5 signature.

  The PCM readout inverts the requantize->IMDCT->synthesis chain by
  least squares against basis responses measured from mpg123 itself
  (table-1 impulse streams), so the recovery does not assume the in-repo
  transform code.

BFS visits extensions in lexicographic order, so the first complete unit
under a codeword is its all-zero extension (positive signs, zero
linbits); the codeword is registered and its sign/linbits subtree is
pruned. Escape codewords (a 15 component) trigger a per-table linbits
measurement: candidate field widths L are verified by probing the unit
whose x-linbits pattern is 1000... - only the true L yields the expected
value 15 + 2^(L-1).

Output: rewrites hpfw_jax/io/_mp3_huffman.py with the complete tables.
Run:  python tools/recover_mp3_huffman.py
"""

from __future__ import annotations

import sys
from collections import deque

import numpy as np

sys.path.insert(0, ".")

from hpfw_jax.io import mp3enc, mpeg_ref  # noqa: E402

SR_IDX = 1          # 48 kHz
BITRATE_IDX = 1     # 32 kbps -> 96-byte frames, cheap batches
WINDOW = 2 * 1152   # readout window per probe (probe frame + empty frame)
NLINES = 16         # readout basis covers spectral lines 0..15
QUAD_SIG = "11100"  # count1 table B: quad (0,0,0,1) + positive sign
SIG_LINE = 5
MAX_UNIT_BITS = 24
BATCH = 512
# linbits candidates, recalled field widths first for probe economy
LINBITS_CANDS = (0, 1, 2, 3, 4, 6, 8, 10, 13, 5, 7, 9, 11, 12)

_EMPTY = mp3enc.layer3_frame([[{}], [{}]], bitrate_idx=BITRATE_IDX,
                             sr_idx=SR_IDX)


class Batcher:
    """Accumulate probe granules; decode them in one mpg123 stream."""

    def __init__(self):
        self.granules: list[dict] = []

    def add(self, granule: dict) -> int:
        self.granules.append(granule)
        return len(self.granules) - 1

    def run(self) -> np.ndarray:
        """-> (n_probes, WINDOW) float64 PCM readout windows."""
        parts = []
        for g in self.granules:
            parts.append(mp3enc.layer3_frame(
                [[g], [{}]], bitrate_idx=BITRATE_IDX, sr_idx=SR_IDX))
            parts.append(_EMPTY)
        parts.append(_EMPTY)  # flush tail
        pcm, sr = mpeg_ref.mpg123_decode(b"".join(parts))
        assert sr == 48000
        n = len(self.granules)
        need = n * WINDOW
        assert len(pcm) >= need, (len(pcm), need)
        out = pcm[:need, 0].astype(np.float64).reshape(n, WINDOW)
        self.granules = []
        return out


def big_probe(table: int, bits: str) -> dict:
    return dict(big_values=1, table_select=(table, table, table),
                region0_count=15, region1_count=7, count1table_select=1,
                huff_bits=bits + QUAD_SIG)


def measure_basis() -> np.ndarray:
    b = Batcher()
    for line in range(NLINES):
        pairs = line // 2
        bits = "1" * pairs + ("010" if line % 2 == 0 else "0010")
        b.add(dict(big_values=pairs + 1, table_select=(1, 1, 1),
                   region0_count=15, region1_count=7, huff_bits=bits))
    return b.run()


class Readout:
    def __init__(self, basis: np.ndarray):
        self.C = basis
        self.pinv = np.linalg.pinv(basis.T)

    def lines(self, window: np.ndarray):
        a = self.pinv @ window
        resid = np.linalg.norm(window - a @ self.C)
        return a, resid


def snap_value(a: float, scale: float):
    """PCM coefficient -> signed integer spectral value, or None.

    Tolerance is tight on purpose: mpg123's float32 output carries ~1e-6
    relative noise, far below the 4/3·v^(1/3) spacing between adjacent
    v^(4/3) magnitudes even at linbits-13 escape values (~2e4).
    """
    mag = abs(a)
    tol = 2e-3 + 1e-5 * scale + 1e-5 * mag
    if mag < tol:
        return 0
    v = int(round(mag ** 0.75))
    best = min((c for c in (v - 1, v, v + 1) if c >= 1),
               key=lambda c: abs(c ** (4.0 / 3.0) - mag))
    if abs(best ** (4.0 / 3.0) - mag) <= tol:
        return best if a > 0 else -best
    return None


def interpret_pair(a: np.ndarray, resid: float, wnorm: float):
    """Accept iff readout = pair at lines 0-1 + sig at line 5."""
    scale = max(abs(a[0]), abs(a[1]))
    if resid > 2e-3 * (1.0 + wnorm):
        return None
    if abs(a[SIG_LINE] - 1.0) > 5e-3 + 1e-4 * scale:
        return None
    for j in range(2, NLINES):
        if j != SIG_LINE and abs(a[j]) > 5e-3 + 1e-4 * scale:
            return None
    x = snap_value(a[0], scale)
    y = snap_value(a[1], scale)
    if x is None or y is None:
        return None
    return x, y


def build_unit(c: str, x: int, y: int, L: int, *, xlin=0, xsign=0,
               ylin=0, ysign=0) -> str:
    u = c
    if x >= 15 and L:
        u += format(xlin, f"0{L}b")
    if x:
        u += str(xsign)
    if y >= 15 and L:
        u += format(ylin, f"0{L}b")
    if y:
        u += str(ysign)
    return u


# Recalled linbits field widths per table, used only as zero-fill HINTS
# to find escape units without walking their subtrees blindly; the true
# width is then verified independently (largest-first decomposition).
LINBITS_PRIOR = {16: 1, 17: 2, 18: 3, 19: 4, 20: 6, 21: 8, 22: 10, 23: 13,
                 24: 4, 25: 5, 26: 6, 27: 7, 28: 8, 29: 9, 30: 11, 31: 13}


class TableRecovery:
    def __init__(self, table: int, readout: Readout):
        self.table = table
        self.readout = readout
        self.codewords: dict[str, tuple[int, int]] = {}
        self.linbits: int | None = None
        self.n_probes = 0

    def _probe_many(self, bit_strings):
        out = []
        for lo in range(0, len(bit_strings), BATCH):
            chunk = bit_strings[lo:lo + BATCH]
            b = Batcher()
            for s in chunk:
                b.add(big_probe(self.table, s))
            self.n_probes += len(chunk)
            windows = b.run()
            for w in windows:
                a, resid = self.readout.lines(w)
                out.append(interpret_pair(a, resid, np.linalg.norm(w)))
        return out

    def _prefix_known(self, p: str) -> bool:
        return any(p.startswith(c) for c in self.codewords)

    def _resolve_unit(self, p: str, got):
        """Complete unit p with decoded pair `got` -> (codeword, linbits).

        Decompositions p = c + [xlin] + [sx] + [ylin] + [sy] are tried
        LARGEST linbits first: for candidate L greater than the true
        width, the candidate codeword is a strict prefix of the true one,
        so the verification unit decodes through a different codeword and
        cannot reproduce the expected pair (pair values are unique per
        codeword); for L smaller than the true width the probe string is
        itself a valid true-structure unit, which is exactly why
        smaller-first ordering is unsound. The first (largest) verified
        candidate is therefore the true structure.
        """
        gx, gy = got
        xa, ya = abs(gx), abs(gy)
        esc_x, esc_y = xa >= 15, ya >= 15
        cands = list(range(13, -1, -1)) if (esc_x or esc_y) else [0]
        for L in cands:
            bits_x = (L if esc_x else 0) + (1 if xa else 0)
            bits_y = (L if esc_y else 0) + (1 if ya else 0)
            ext = bits_x + bits_y
            if ext >= len(p):
                continue
            c = p[:len(p) - ext]
            # parse p's extension under this hypothesis; must match got
            q = p[len(p) - ext:]
            pos = 0
            ok = True
            if esc_x:
                if 15 + int(q[pos:pos + L] or "0", 2) != xa:
                    ok = False
                pos += L
            if ok and xa:
                if (q[pos] == "1") != (gx < 0):
                    ok = False
                pos += 1
            if ok and esc_y:
                if 15 + int(q[pos:pos + L] or "0", 2) != ya:
                    ok = False
                pos += L
            if ok and ya:
                if (q[pos] == "1") != (gy < 0):
                    ok = False
            if not ok:
                continue
            bx = min(xa, 15)
            by = min(ya, 15)
            if not (esc_x or esc_y):
                # no linbits ambiguity: sign count is fixed by the
                # values, so the decomposition is unique — no probe
                return c, 0
            if L == 0:
                # signs only: verify by flipping one sign bit
                if bx:
                    unit = build_unit(c, bx, by, 0, xsign=1,
                                      ysign=1 if (ya and gy < 0) else 0)
                    expect = (-bx, gy)
                else:
                    unit = build_unit(c, bx, by, 0, ysign=1)
                    expect = (bx, -by)
            elif esc_x:
                unit = build_unit(c, bx, by, L, xlin=1 << (L - 1), xsign=1)
                expect = (-(15 + (1 << (L - 1))), 15 if esc_y else by)
            else:
                unit = build_unit(c, bx, by, L, ylin=1 << (L - 1), ysign=1,
                                  xsign=1 if bx else 0)
                expect = (-bx if bx else bx, -(15 + (1 << (L - 1))))
            if self._probe_many([unit])[0] == expect:
                return c, L
        raise RuntimeError(
            f"table {self.table}: unit {p} ({got}) unresolved")

    def _register(self, p: str, got):
        c, L = self._resolve_unit(p, got)
        if self.linbits is None and L:
            self.linbits = L
        assert not L or self.linbits == L, (self.table, c, L, self.linbits)
        assert c not in self.codewords or \
            self.codewords[c] == (min(abs(got[0]), 15), min(abs(got[1]), 15))
        self.codewords[c] = (min(abs(got[0]), 15), min(abs(got[1]), 15))

    def run(self, log=print):
        Lp = LINBITS_PRIOR.get(self.table, 0)
        frontier = deque(["0", "1"])
        while frontier:
            batch = []
            fills = []  # (probe string, owner index in batch)
            while frontier and len(batch) < BATCH:
                p = frontier.popleft()
                if self._prefix_known(p):
                    continue
                if len(p) > MAX_UNIT_BITS:
                    raise RuntimeError(
                        f"table {self.table}: runaway at {p}")
                batch.append(p)
            if not batch:
                break
            results = self._probe_many(batch)
            rejected = []
            for p, got in zip(batch, results):
                if self._prefix_known(p):
                    continue  # registered earlier in this same batch
                if got is not None:
                    self._register(p, got)
                else:
                    rejected.append(p)
            if Lp and rejected:
                # zero-fill hints: if p is an escape codeword, one of
                # these completes its all-zero unit, so the subtree is
                # registered and pruned instead of blindly expanded
                # (a blind walk through a linbits field is exponential).
                fills = []
                for p in rejected:
                    for k in (Lp + 1, Lp + 2, 2 * Lp + 2):
                        fills.append((p, p + "0" * k))
                fres = self._probe_many([f for _p, f in fills])
                for (_p, f), got in zip(fills, fres):
                    if got is None or self._prefix_known(f):
                        continue
                    self._register(f, got)
            for p in rejected:
                if not self._prefix_known(p):
                    frontier.append(p + "0")
                    frontier.append(p + "1")
        kraft = sum(2.0 ** -len(c) for c in self.codewords)
        mx = max((v[0] for v in self.codewords.values()), default=0)
        my = max((v[1] for v in self.codewords.values()), default=0)
        log(f"  table {self.table:2d}: {len(self.codewords):3d} codewords "
            f"({mx + 1}x{my + 1}), kraft {kraft:.6f}, "
            f"linbits {self.linbits or 0}, probes {self.n_probes}")
        assert abs(kraft - 1.0) < 1e-9, "incomplete prefix code"
        return (self.linbits or 0), self.codewords


def recover_count1_a(readout: Readout, log=print):
    """count1 table A via the same tree walk.

    Probe: big_values=0, count1 table A, area = p + anchor, where anchor
    is a known complete table-A unit; accept iff readout shows a quad at
    lines 0-3 and the anchor's quad at lines 4-7. Bootstrap (no anchor
    yet): area = p + p and accept only non-zero quads whose pattern
    repeats at lines 4-7.
    """
    def probe(bits):
        return dict(big_values=0, count1table_select=0, huff_bits=bits)

    def run_batch(strings, anchor):
        b = Batcher()
        for p in strings:
            b.add(probe(p + (anchor[0] if anchor else p)))
        windows = b.run()
        out = []
        for w in windows:
            a, resid = readout.lines(w)
            out.append(read_quads(a, resid, np.linalg.norm(w), anchor))
        return out

    def read_quads(a, resid, wnorm, anchor):
        if resid > 2e-3 * (1.0 + wnorm):
            return None
        vals = []
        for j in range(8):
            v = snap_value(a[j], 1.0)
            if v is None or abs(v) > 1:
                return None
            vals.append(v)
        for j in range(8, NLINES):
            if abs(a[j]) > 5e-3:
                return None
        q0, q1 = tuple(vals[:4]), tuple(vals[4:])
        if anchor is None:
            if q0 != q1 or not any(q0):
                return None
        else:
            if tuple(abs(v) for v in q1) != anchor[1]:
                return None
        return tuple(abs(v) for v in q0), sum(1 for v in q0 if v)

    # phase 1: find one nonzero unit to anchor on
    anchor = None
    frontier = deque(["0", "1"])
    while frontier and anchor is None:
        batch = [frontier.popleft() for _ in range(min(64, len(frontier)))]
        for p, got in zip(batch, run_batch(batch, None)):
            if got is not None and anchor is None:
                anchor = (p, got[0])
            elif got is None:
                frontier.append(p + "0")
                frontier.append(p + "1")
    assert anchor is not None, "count1A: no anchor found"
    # phase 2: full walk with the anchor suffix
    codewords: dict[str, tuple] = {}
    frontier = deque(["0", "1"])
    nprobes = 0
    while frontier:
        batch = []
        while frontier and len(batch) < BATCH:
            p = frontier.popleft()
            if any(p.startswith(c) for c in codewords):
                continue
            if len(p) > 12:
                raise RuntimeError(f"count1A runaway at {p}")
            batch.append(p)
        if not batch:
            break
        nprobes += len(batch)
        for p, got in zip(batch, run_batch(batch, anchor)):
            if any(p.startswith(c) for c in codewords):
                continue
            if got is None:
                frontier.append(p + "0")
                frontier.append(p + "1")
                continue
            quad, nsign = got
            c = p[:len(p) - nsign] if nsign else p
            assert set(p[len(p) - nsign:]) <= {"0"}, (p, quad)
            codewords[c] = quad
    kraft = sum(2.0 ** -len(c) for c in codewords)
    log(f"  count1 A: {len(codewords)} codewords, kraft {kraft:.6f}, "
        f"probes {nprobes}")
    assert abs(kraft - 1.0) < 1e-9
    return codewords


def sanity_check_readout(readout: Readout):
    """The machinery must reproduce known table-1 units before trusting it."""
    b = Batcher()
    b.add(big_probe(1, "010"))   # (1,0) +
    b.add(big_probe(1, "0011"))  # (0,1) -
    b.add(big_probe(1, "00010"))  # (1,1) +-? '000'+'1'+'0' -> (-1, +1)
    b.add(big_probe(1, "0"))     # incomplete: must be rejected
    b.add(big_probe(1, "010"))   # after an overrun probe: batch integrity
    w = b.run()
    expects = [(1, 0), (0, -1), (-1, 1), None, (1, 0)]
    for i, exp in enumerate(expects):
        a, resid = readout.lines(w[i])
        got = interpret_pair(a, resid, np.linalg.norm(w[i]))
        assert got == exp, (i, got, exp)


def main():
    if not mpeg_ref.available():
        print("reference libraries unavailable; nothing to do")
        return 1
    print("measuring readout basis from mpg123 ...")
    basis = measure_basis()
    readout = Readout(basis)
    sanity_check_readout(readout)
    print("basis ok (known table-1 units reproduce; prefixes reject)")
    tables: dict[int, tuple[int, dict] | None] = {0: (0, {})}
    for t in range(1, 32):
        if t in (4, 14):
            tables[t] = (0, {})  # not used by the spec
            continue
        try:
            tables[t] = TableRecovery(t, readout).run()
        except Exception as e:
            print(f"  table {t}: FAILED ({e})")
            tables[t] = None
    count1a = recover_count1_a(readout)
    _write_module(tables, count1a)
    print("wrote hpfw_jax/io/_mp3_huffman.py")
    return 0


def _write_module(tables, count1a):
    lines = [
        '"""MPEG-1 Layer III Huffman tables (ISO/IEC 11172-3 Table B.7).',
        "",
        "Recovered from the system reference decoder by prefix-tree",
        "probing (tools/recover_mp3_huffman.py): each codeword was",
        "certified by composing a stream that decodes it and reading the",
        "spectral values back out of the reference decoder's PCM.",
        '"""',
        "",
        "from __future__ import annotations",
        "",
        "# id -> (linbits, {codeword bits: (x, y)})",
        "BIG_VALUE_TABLES = {",
    ]
    for t in sorted(tables):
        entry = tables[t]
        if entry is None:
            lines.append(f"    {t}: (0, {{}}),  # RECOVERY FAILED")
            continue
        linbits, cws = entry
        if not cws:
            lines.append(f"    {t}: ({linbits}, {{}}),")
            continue
        lines.append(f"    {t}: ({linbits}, {{")
        for c in sorted(cws, key=lambda s: (len(s), s)):
            lines.append(f'        "{c}": {cws[c]},')
        lines.append("    }),")
    lines.append("}")
    lines.append("")
    lines.append("COUNT1_TABLES = {")
    lines.append("    0: {")
    for c in sorted(count1a, key=lambda s: (len(s), s)):
        lines.append(f'        "{c}": {count1a[c]},')
    lines.append("    },")
    lines.append("    # Table B: fixed 4-bit code, codeword = NOT(v w x y)")
    lines.append('    1: {format(15 ^ q, "04b"): ((q >> 3) & 1, (q >> 2) & 1,'
                 " (q >> 1) & 1, q & 1)")
    lines.append("        for q in range(16)},")
    lines.append("}")
    lines.append("""

def tree(table):
    \"\"\"Prefix-code dict -> binary tree of nested dicts (leaves=value).\"\"\"
    root = {}
    for code, val in table.items():
        node = root
        for b in code[:-1]:
            node = node.setdefault(int(b), {})
            assert isinstance(node, dict), f"prefix clash at {code}"
        last = int(code[-1])
        assert last not in node, f"duplicate code {code}"
        node[last] = val
    return root
""")
    with open("hpfw_jax/io/_mp3_huffman.py", "w") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    raise SystemExit(main())
