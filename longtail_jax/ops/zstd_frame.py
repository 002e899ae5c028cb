"""zstd frame codec implemented from RFC 8878 (no upstream zstd code).

The reference wraps vendored upstream zstd 1.5.6 with block tags 'ztd'+{1..5}
(lib/zstd/longtail_zstd.c:17-22) and zstd is the reference CLI's default
compression (cmd/main.c:2988).  This module is an independent from-spec
implementation:

- **Decoder**: full RFC 8878 frame decoding — raw/RLE/compressed blocks,
  Huffman literals (1- and 4-stream, direct and FSE-compressed weights,
  treeless repeat), FSE sequences (predefined / RLE / compressed / repeat
  table modes), repeat offsets, skippable frames.  Able to read frames
  produced by upstream zstd (conformance-tested against libzstd in
  tests/test_zstd.py).
- **Encoder**: greedy hash-chain LZ77 match finder -> sequences encoded with
  the predefined FSE distributions + Huffman-compressed literals (direct or
  FSE-compressed weight serialization), raw/RLE block fallbacks.  Output is
  decodable by upstream zstd.

Pure Python: this is the spec oracle and host fallback; the fast path is
system libzstd bound in ops/zstd.py (the reference vendors upstream zstd
the same way, lib/zstd/).
"""

from __future__ import annotations

import struct

MAGIC = 0xFD2FB528
SKIPPABLE_LO = 0x184D2A50
BLOCK_MAX = 128 * 1024

# --- predefined FSE distributions (RFC 8878 sec 3.1.1.3.2.2) ---------------

LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
              2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
              -1, -1, -1, -1)
LL_DEFAULT_LOG = 6
ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
              -1, -1, -1, -1, -1)
ML_DEFAULT_LOG = 6
OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1)
OF_DEFAULT_LOG = 5

# literal-length / match-length code tables (RFC 8878 sec 3.1.1.3.2.1.1)
LL_BITS = (0,) * 16 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8,
                       9, 10, 11, 12, 13, 14, 15, 16)
LL_BASE = tuple(range(16)) + (16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                              128, 256, 512, 1024, 2048, 4096, 8192,
                              16384, 32768, 65536)
ML_BITS = (0,) * 32 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8,
                       9, 10, 11, 12, 13, 14, 15, 16)
ML_BASE = tuple(range(3, 35)) + (35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                 99, 131, 259, 515, 1027, 2051, 4099,
                                 8195, 16387, 32771, 65539)

MAX_HUF_BITS = 11


class ZstdError(ValueError):
    pass


# ---------------------------------------------------------------------------
# bit streams
# ---------------------------------------------------------------------------

class BackBitReader:
    """Backward bitstream (FSE/Huffman): written forward LSB-first, read
    from the final byte's sentinel bit downward (RFC 8878 sec 4.1)."""

    __slots__ = ("val", "pos", "total")

    def __init__(self, data: bytes):
        if not data:
            raise ZstdError("empty bitstream")
        last = data[-1]
        if last == 0:
            raise ZstdError("bitstream corrupted (no sentinel)")
        self.val = int.from_bytes(data, "little")
        self.total = 8 * len(data) - (8 - (last.bit_length() - 1))
        self.pos = self.total  # bits remaining below the cursor

    def read(self, n: int) -> int:
        """Consume n bits (zero-filled past the start)."""
        self.pos -= n
        if self.pos >= 0:
            return (self.val >> self.pos) & ((1 << n) - 1)
        if n == 0:
            return 0
        # past-start: zero-fill low bits (only dead transitions do this)
        p = self.pos + n
        return (self.val & ((1 << max(p, 0)) - 1)) << (-self.pos) \
            if p > 0 else 0

    def peek(self, n: int) -> int:
        p = self.pos - n
        if p >= 0:
            return (self.val >> p) & ((1 << n) - 1)
        return (self.val & ((1 << max(self.pos, 0)) - 1)) << (-p) \
            if self.pos > 0 else 0

    @property
    def overflowed(self) -> bool:
        return self.pos < 0

    @property
    def finished(self) -> bool:
        return self.pos == 0


class BackBitWriter:
    """Forward writer producing a backward-readable stream: bits stacked
    LSB-up, closed with a sentinel 1 bit, serialized little-endian."""

    __slots__ = ("val", "n")

    def __init__(self):
        self.val = 0
        self.n = 0

    def add(self, value: int, nbits: int) -> None:
        self.val |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits

    def close(self) -> bytes:
        self.add(1, 1)
        nbytes = (self.n + 7) // 8
        return self.val.to_bytes(nbytes, "little")


class FwdBitReader:
    """Forward little-endian bitstream (FSE table descriptions)."""

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def read(self, n: int) -> int:
        end = self.bitpos + n
        lo_byte = self.bitpos >> 3
        hi_byte = (end + 7) >> 3
        if hi_byte > len(self.data):
            raise ZstdError("table description overruns input")
        chunk = int.from_bytes(self.data[lo_byte:hi_byte], "little")
        out = (chunk >> (self.bitpos & 7)) & ((1 << n) - 1)
        self.bitpos = end
        return out

    def bytes_consumed(self) -> int:
        return (self.bitpos + 7) // 8


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------

def _fse_spread(norm, table_log: int):
    """Symbol spread over the state table (RFC 8878 sec 4.1.1)."""
    size = 1 << table_log
    spread = [0] * size
    high = size - 1
    for s, p in enumerate(norm):
        if p == -1:
            spread[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, p in enumerate(norm):
        for _ in range(max(p, 0)):
            spread[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("corrupted FSE distribution")
    return spread, high


class FseDecodeTable:
    __slots__ = ("log", "symbol", "nbits", "base")

    def __init__(self, norm, table_log: int):
        size = 1 << table_log
        spread, _ = _fse_spread(norm, table_log)
        nxt = [p if p > 0 else 1 for p in norm]
        self.log = table_log
        self.symbol = spread
        self.nbits = [0] * size
        self.base = [0] * size
        for i in range(size):
            s = spread[i]
            x = nxt[s]
            nxt[s] += 1
            nb = table_log - (x.bit_length() - 1)
            self.nbits[i] = nb
            self.base[i] = (x << nb) - size


class FseState:
    __slots__ = ("table", "state")

    def __init__(self, table: FseDecodeTable, br: BackBitReader):
        self.table = table
        self.state = br.read(table.log)

    @property
    def symbol(self) -> int:
        return self.table.symbol[self.state]

    def update(self, br: BackBitReader) -> None:
        t = self.table
        self.state = t.base[self.state] + br.read(t.nbits[self.state])

    def decode(self, br: BackBitReader) -> int:
        s = self.table.symbol[self.state]
        self.update(br)
        return s


class FseEncodeTable:
    __slots__ = ("log", "state_table", "delta_nbits", "delta_find")

    def __init__(self, norm, table_log: int):
        size = 1 << table_log
        spread, _ = _fse_spread(norm, table_log)
        cumul = [0] * (len(norm) + 1)
        for s, p in enumerate(norm):
            cumul[s + 1] = cumul[s] + (p if p > 0 else (1 if p == -1 else 0))
        self.log = table_log
        self.state_table = [0] * size
        occ = cumul[:]
        for u in range(size):
            s = spread[u]
            self.state_table[occ[s]] = size + u
            occ[s] += 1
        self.delta_nbits = [0] * len(norm)
        self.delta_find = [0] * len(norm)
        total = 0
        for s, p in enumerate(norm):
            if p == 0:
                self.delta_nbits[s] = ((table_log + 1) << 16) - size
            elif p in (-1, 1):
                self.delta_nbits[s] = (table_log << 16) - size
                self.delta_find[s] = total - 1
                total += 1
            else:
                max_out = table_log - ((p - 1).bit_length() - 1)
                self.delta_nbits[s] = (max_out << 16) - (p << max_out)
                self.delta_find[s] = total - p
                total += p


class FseEncState:
    __slots__ = ("t", "value")

    def __init__(self, table: FseEncodeTable, first_symbol: int):
        self.t = table
        nb = (table.delta_nbits[first_symbol] + (1 << 15)) >> 16
        v = (nb << 16) - table.delta_nbits[first_symbol]
        self.value = table.state_table[
            (v >> nb) + table.delta_find[first_symbol]]

    def encode(self, bw: BackBitWriter, symbol: int) -> None:
        t = self.t
        nb = (self.value + t.delta_nbits[symbol]) >> 16
        bw.add(self.value, nb)
        self.value = t.state_table[
            (self.value >> nb) + t.delta_find[symbol]]

    def flush(self, bw: BackBitWriter) -> None:
        bw.add(self.value, self.t.log)


def fse_read_ncount(data: bytes, max_symbol: int):
    """Parse an FSE table description (RFC 8878 sec 4.1.1).

    Returns (norm list, table_log, bytes consumed)."""
    br = FwdBitReader(data)
    table_log = br.read(4) + 5
    if table_log > 15:
        raise ZstdError(f"FSE accuracy log {table_log} too large")
    remaining = (1 << table_log) + 1
    threshold = 1 << table_log
    nbits = table_log + 1
    norm = []
    prev0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if prev0:
            while True:
                rep = br.read(2)
                norm.extend([0, 0, 0][:rep] if rep < 3 else [0, 0, 0])
                if rep < 3:
                    break
        maxv = (2 * threshold - 1) - remaining
        low = br.read(nbits - 1)
        if low < maxv:
            count = low
        else:
            count = low + (br.read(1) << (nbits - 1))
            if count >= threshold:
                count -= maxv
        count -= 1  # stored value is count+1; -1 encodes "less than 1"
        remaining -= -count if count < 0 else count
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdError("corrupted FSE normalized counts")
    return norm, table_log, br.bytes_consumed()


def fse_write_ncount(norm, table_log: int) -> bytes:
    """Serialize an FSE table description (mirror of fse_read_ncount)."""
    out = bytearray()
    acc = 0
    nacc = 0

    def add(v, n):
        nonlocal acc, nacc
        acc |= v << nacc
        nacc += n
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    add(table_log - 5, 4)
    remaining = (1 << table_log) + 1
    threshold = 1 << table_log
    nbits = table_log + 1
    i = 0
    while remaining > 1:
        count = norm[i]
        i += 1
        maxv = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        stored = count + 1
        if stored >= threshold:
            stored += maxv
        if stored < maxv:
            add(stored, nbits - 1)
        else:
            add(stored, nbits)
        if count == 0:  # repeat-zeros flags
            while True:
                run = 0
                while i + run < len(norm) and norm[i + run] == 0 \
                        and run < 3:
                    run += 1
                add(run, 2)
                i += run
                if run < 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------

class HufDecodeTable:
    __slots__ = ("max_bits", "symbol", "nbits")

    def __init__(self, weights):
        total = sum((1 << (w - 1)) for w in weights if w > 0)
        if total == 0:
            raise ZstdError("empty Huffman table")
        # the implied last weight completes the smallest power of two > total
        tbl = 1
        mb = 0
        while tbl < total + 1:
            tbl <<= 1
            mb += 1
        rest = tbl - total
        if rest & (rest - 1):
            raise ZstdError("corrupted Huffman weights")
        weights = list(weights) + [rest.bit_length()]
        self.max_bits = mb
        size = 1 << mb
        self.symbol = [0] * size
        self.nbits = [0] * size
        rank_val = [0] * (mb + 2)
        rank_count = [0] * (mb + 2)
        for w in weights:
            rank_count[w] += 1
        nxt = 0
        for w in range(1, mb + 1):
            cur = nxt
            nxt += rank_count[w] << (w - 1)
            rank_val[w] = cur
        for s, w in enumerate(weights):
            if w == 0:
                continue
            length = 1 << (w - 1)
            start = rank_val[w]
            for u in range(start, start + length):
                self.symbol[u] = s
                self.nbits[u] = mb + 1 - w
            rank_val[w] += length

    def decode_stream(self, br: BackBitReader, n_out: int) -> bytearray:
        out = bytearray(n_out)
        sym = self.symbol
        nbits = self.nbits
        mb = self.max_bits
        for i in range(n_out):
            idx = br.peek(mb)
            out[i] = sym[idx]
            br.read(nbits[idx])
        if br.pos < 0:
            raise ZstdError("Huffman stream overrun")
        return out


def read_huffman_weights(data: bytes):
    """Parse a Huffman tree description (RFC 8878 sec 4.2.1).

    Returns (weights list [without the implied last one], bytes consumed)."""
    if not data:
        raise ZstdError("empty Huffman description")
    h = data[0]
    if h >= 128:  # direct 4-bit weights
        n = h - 127
        nbytes = (n + 1) // 2
        if len(data) < 1 + nbytes:
            raise ZstdError("truncated Huffman weights")
        weights = []
        for i in range(n):
            b = data[1 + i // 2]
            weights.append((b >> 4) if i % 2 == 0 else (b & 0xF))
        return weights, 1 + nbytes
    # FSE-compressed weights: two interleaved states
    comp = data[1:1 + h]
    if len(comp) < h:
        raise ZstdError("truncated Huffman weight stream")
    norm, log, used = fse_read_ncount(comp, 255)
    if log > 6:
        raise ZstdError("Huffman weight accuracy log > 6")
    table = FseDecodeTable(norm, log)
    br = BackBitReader(comp[used:])
    s1 = FseState(table, br)
    s2 = FseState(table, br)
    weights = []
    while True:
        if len(weights) > 254:
            raise ZstdError("too many Huffman weights")
        weights.append(s1.decode(br))
        if br.overflowed:
            weights.append(s2.symbol)
            break
        weights.append(s2.decode(br))
        if br.overflowed:
            weights.append(s1.symbol)
            break
    return weights, 1 + h


def _package_merge(freqs, max_len: int):
    """Optimal length-limited Huffman code lengths (package-merge)."""
    syms = [s for s, f in enumerate(freqs) if f > 0]
    n = len(syms)
    if n == 0:
        return {}
    if n == 1:
        return {syms[0]: 1}
    if n > (1 << max_len):
        raise ZstdError("alphabet too large for code length limit")
    # items: (weight, {sym: count}); packages merged level by level
    lengths = {s: 0 for s in syms}
    level = []  # coins at current denomination
    for _ in range(max_len):
        coins = sorted(
            [(freqs[s], (s,)) for s in syms] + level,
            key=lambda x: x[0])
        level = []
        for i in range(0, len(coins) - 1, 2):
            a, b = coins[i], coins[i + 1]
            level.append((a[0] + b[0], a[1] + b[1]))
    # take the 2n-2 cheapest packages at the top level
    level.sort(key=lambda x: x[0])
    for _, group in level[: 2 * n - 2]:
        for s in group:
            lengths[s] += 1
    return lengths


def build_huffman(freqs):
    """Build canonical Huffman code for literal frequencies.

    Returns (weights list for symbols 0..last, code_val, code_len arrays)
    or None if not compressible (fewer than 2 distinct symbols)."""
    present = [s for s, f in enumerate(freqs) if f > 0]
    if len(present) < 2:
        return None
    lengths = _package_merge(freqs, MAX_HUF_BITS)
    max_len = max(lengths.values())
    # canonical weights: w = max_len + 1 - code_length
    last = present[-1]
    weights = [0] * (last + 1)
    for s, ln in lengths.items():
        weights[s] = max_len + 1 - ln
    # canonical code values: shorter codes get higher values
    nb_per_rank = [0] * (max_len + 2)
    for ln in lengths.values():
        nb_per_rank[ln] += 1
    val_per_rank = [0] * (max_len + 2)
    mn = 0
    for ln in range(max_len, 0, -1):
        val_per_rank[ln] = mn
        mn += nb_per_rank[ln]
        mn >>= 1
    code_val = [0] * (last + 1)
    code_len = [0] * (last + 1)
    for s in present:
        ln = lengths[s]
        code_len[s] = ln
        code_val[s] = val_per_rank[ln]
        val_per_rank[ln] += 1
    return weights, code_val, code_len


def _normalize_counts(freqs, table_log: int, total: int):
    """Scale frequencies to sum to 1<<table_log (simple largest-remainder)."""
    size = 1 << table_log
    norm = [0] * len(freqs)
    assigned = 0
    rests = []
    for s, f in enumerate(freqs):
        if f == 0:
            continue
        exact = f * size / total
        if exact < 1.0:
            norm[s] = -1
            assigned += 1
        else:
            norm[s] = int(exact)
            assigned += norm[s]
            rests.append((exact - norm[s], s))
    rests.sort(reverse=True)
    i = 0
    while assigned < size and rests:
        _, s = rests[i % len(rests)]
        norm[s] += 1
        assigned += 1
        i += 1
    while assigned > size:
        # shrink the largest count
        s = max((x for x in range(len(norm)) if norm[x] > 1),
                key=lambda x: norm[x])
        norm[s] -= 1
        assigned -= 1
    if assigned != size:
        raise ZstdError("normalization failed")
    return norm


def write_huffman_weights(weights) -> bytes:
    """Serialize Huffman weights: FSE-compressed if it wins, else direct
    4-bit pairs (only possible for <=128 weights)."""
    n = len(weights)
    direct = None
    if n <= 128:
        body = bytearray([127 + n])
        for i in range(0, n, 2):
            hi = weights[i] << 4
            lo = weights[i + 1] if i + 1 < n else 0
            body.append(hi | lo)
        direct = bytes(body)
    # FSE compression of the weight sequence
    freqs = [0] * (max(weights) + 1)
    for w in weights:
        freqs[w] += 1
    fse_ser = None
    if sum(1 for f in freqs if f > 0) >= 2:
        log = min(6, max(1, (n - 1).bit_length()))
        try:
            norm = _normalize_counts(freqs, log, n)
            enc = FseEncodeTable(norm, log)
            bw = BackBitWriter()
            # two interleaved states over the weights in reverse
            if n & 1:
                s1 = FseEncState(enc, weights[n - 1])
                s2 = FseEncState(enc, weights[n - 2])
                s1.encode(bw, weights[n - 3])
                nxt = n - 4
            else:
                s2 = FseEncState(enc, weights[n - 1])
                s1 = FseEncState(enc, weights[n - 2])
                nxt = n - 3
            while nxt >= 0:
                s2.encode(bw, weights[nxt])
                nxt -= 1
                if nxt >= 0:
                    s1.encode(bw, weights[nxt])
                    nxt -= 1
            s2.flush(bw)
            s1.flush(bw)
            payload = fse_write_ncount(norm, log) + bw.close()
            if len(payload) < 128:
                fse_ser = bytes([len(payload)]) + payload
        except ZstdError:
            fse_ser = None
    if fse_ser is not None and (direct is None or len(fse_ser) < len(direct)):
        return fse_ser
    if direct is None:
        raise ZstdError("cannot serialize Huffman weights")
    return direct


# ---------------------------------------------------------------------------
# literals section
# ---------------------------------------------------------------------------

def _decode_literals(block: bytes, ctx: dict):
    """Decode the literals section of a compressed block.

    Returns (literals bytes, bytes consumed from block)."""
    if not block:
        raise ZstdError("empty literals section")
    b0 = block[0]
    lit_type = b0 & 3
    size_fmt = (b0 >> 2) & 3
    if lit_type in (0, 1):  # Raw / RLE
        if size_fmt & 1 == 0:
            regen = b0 >> 3
            hdr = 1
        elif size_fmt == 1:
            regen = int.from_bytes(block[:2], "little") >> 4
            hdr = 2
        else:
            regen = int.from_bytes(block[:3], "little") >> 4
            hdr = 3
        if lit_type == 0:
            lits = block[hdr:hdr + regen]
            if len(lits) < regen:
                raise ZstdError("truncated raw literals")
            return bytes(lits), hdr + regen
        return block[hdr:hdr + 1] * regen, hdr + 1
    # Compressed (2) / Treeless (3)
    if size_fmt == 0:
        v = int.from_bytes(block[:3], "little")
        regen = (v >> 4) & 0x3FF
        comp = v >> 14
        hdr, streams = 3, 1
    elif size_fmt == 1:
        v = int.from_bytes(block[:3], "little")
        regen = (v >> 4) & 0x3FF
        comp = v >> 14
        hdr, streams = 3, 4
    elif size_fmt == 2:
        v = int.from_bytes(block[:4], "little")
        regen = (v >> 4) & 0x3FFF
        comp = v >> 18
        hdr, streams = 4, 4
    else:
        v = int.from_bytes(block[:5], "little")
        regen = (v >> 4) & 0x3FFFF
        comp = v >> 22
        hdr, streams = 5, 4
    payload = block[hdr:hdr + comp]
    if len(payload) < comp:
        raise ZstdError("truncated compressed literals")
    if lit_type == 2:
        weights, used = read_huffman_weights(payload)
        ctx["huf_table"] = HufDecodeTable(weights)
        payload = payload[used:]
    table = ctx.get("huf_table")
    if table is None:
        raise ZstdError("treeless literals with no previous table")
    if streams == 1:
        lits = table.decode_stream(BackBitReader(payload), regen)
    else:
        if len(payload) < 6:
            raise ZstdError("missing literals jump table")
        s1, s2, s3 = struct.unpack("<3H", payload[:6])
        body = payload[6:]
        if s1 + s2 + s3 > len(body):
            raise ZstdError("bad literals jump table")
        seg = (regen + 3) // 4
        parts = [body[:s1], body[s1:s1 + s2],
                 body[s1 + s2:s1 + s2 + s3], body[s1 + s2 + s3:]]
        sizes = [seg, seg, seg, regen - 3 * seg]
        if sizes[3] < 0:
            raise ZstdError("bad 4-stream literal sizes")
        lits = bytearray()
        for part, n in zip(parts, sizes):
            lits += table.decode_stream(BackBitReader(part), n)
    return bytes(lits), hdr + comp


# ---------------------------------------------------------------------------
# sequences section
# ---------------------------------------------------------------------------

_PREDEF = {
    "ll": (LL_DEFAULT, LL_DEFAULT_LOG, 35),
    "of": (OF_DEFAULT, OF_DEFAULT_LOG, 31),
    "ml": (ML_DEFAULT, ML_DEFAULT_LOG, 52),
}


def _read_seq_table(mode: int, data: bytes, kind: str, ctx: dict):
    """Resolve one sequence FSE table per its 2-bit compression mode.

    Returns (FseDecodeTable or ('rle', symbol), bytes consumed)."""
    dist, log, max_sym = _PREDEF[kind]
    key = f"seq_{kind}"
    if mode == 0:  # predefined
        t = FseDecodeTable(dist, log)
        ctx[key] = t
        return t, 0
    if mode == 1:  # RLE: single symbol, 1 byte
        if not data:
            raise ZstdError("missing RLE symbol byte")
        t = ("rle", data[0])
        ctx[key] = t
        return t, 1
    if mode == 2:  # FSE-compressed description
        norm, tlog, used = fse_read_ncount(data, max_sym)
        max_log = {"ll": 9, "of": 8, "ml": 9}[kind]
        if tlog > max_log:
            raise ZstdError(f"{kind} accuracy log {tlog} > {max_log}")
        t = FseDecodeTable(norm, tlog)
        ctx[key] = t
        return t, used
    t = ctx.get(key)  # repeat
    if t is None:
        raise ZstdError("repeat table mode with no previous table")
    return t, 0


class _SeqState:
    """FSE state or degenerate RLE state for one sequence field."""

    __slots__ = ("fse", "sym")

    def __init__(self, table, br: BackBitReader):
        if isinstance(table, tuple):
            self.fse = None
            self.sym = table[1]
        else:
            self.fse = FseState(table, br)
            self.sym = None

    @property
    def symbol(self) -> int:
        return self.sym if self.fse is None else self.fse.symbol

    def update(self, br: BackBitReader) -> None:
        if self.fse is not None:
            self.fse.update(br)


def _decode_sequences(data: bytes, ctx: dict):
    """Decode the sequences section: returns list of (ll, ml, offset_value)."""
    if not data:
        raise ZstdError("empty sequences section")
    b0 = data[0]
    if b0 == 0:
        return [], 1
    if b0 < 128:
        n_seq = b0
        pos = 1
    elif b0 < 255:
        n_seq = ((b0 - 128) << 8) + data[1]
        pos = 2
    else:
        n_seq = data[1] + (data[2] << 8) + 0x7F00
        pos = 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved sequence mode bits set")
    ll_t, used = _read_seq_table((modes >> 6) & 3, data[pos:], "ll", ctx)
    pos += used
    of_t, used = _read_seq_table((modes >> 4) & 3, data[pos:], "of", ctx)
    pos += used
    ml_t, used = _read_seq_table((modes >> 2) & 3, data[pos:], "ml", ctx)
    pos += used

    br = BackBitReader(data[pos:])
    ll_s = _SeqState(ll_t, br)
    of_s = _SeqState(of_t, br)
    ml_s = _SeqState(ml_t, br)
    seqs = []
    for i in range(n_seq):
        of_code = of_s.symbol
        if of_code > 31:
            raise ZstdError("offset code too large")
        offset_value = (1 << of_code) + br.read(of_code)
        ml_code = ml_s.symbol
        ml = ML_BASE[ml_code] + br.read(ML_BITS[ml_code])
        ll_code = ll_s.symbol
        ll = LL_BASE[ll_code] + br.read(LL_BITS[ll_code])
        seqs.append((ll, ml, offset_value))
        if i + 1 < n_seq:
            ll_s.update(br)
            ml_s.update(br)
            of_s.update(br)
    if br.pos != 0:
        raise ZstdError(f"sequence bitstream misconsumed ({br.pos} bits)")
    return seqs, len(data)


def _execute_sequences(lits: bytes, seqs, ctx: dict, win: bytearray):
    """Apply sequences to the literals against the frame window `win`
    (appended in place); returns the regenerated block size."""
    rep = ctx["rep"]
    lit_pos = 0
    start_len = len(win)
    for ll, ml, offset_value in seqs:
        win += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        # repeat-offset resolution (RFC 8878 sec 3.1.1.3.2.1.1)
        if offset_value > 3:
            offset = offset_value - 3
            rep[2] = rep[1]
            rep[1] = rep[0]
            rep[0] = offset
        else:
            idx = offset_value - 1
            if ll == 0:
                idx += 1
            if idx == 0:
                offset = rep[0]
            elif idx < 3:
                offset = rep[idx]
                if idx == 2:
                    rep[2] = rep[1]
                else:
                    rep[2] = rep[2]
                rep[1] = rep[0]
                rep[0] = offset
            else:  # idx == 3: rep[0] - 1 special case
                offset = rep[0] - 1
                if offset == 0:
                    raise ZstdError("invalid repeat offset 0")
                rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = offset
        if offset > len(win):
            raise ZstdError("match offset beyond window")
        if ml:
            if offset >= ml:
                src = len(win) - offset
                win += win[src:src + ml]
            else:  # overlapping copy, byte-by-byte semantics
                src = len(win) - offset
                for k in range(ml):
                    win.append(win[src + k])
    win += lits[lit_pos:]
    return len(win) - start_len


# ---------------------------------------------------------------------------
# frame decode
# ---------------------------------------------------------------------------

def _decode_block(block: bytes, ctx: dict, win: bytearray) -> int:
    lits, used = _decode_literals(block, ctx)
    seqs, _ = _decode_sequences(block[used:], ctx)
    return _execute_sequences(lits, seqs, ctx, win)


def decompress(data: bytes, expected_size: int | None = None) -> bytes:
    """Decode zstd frame(s); concatenated and skippable frames supported."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        if n - pos < 4:
            raise ZstdError("truncated frame header")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if (magic & 0xFFFFFFF0) == SKIPPABLE_LO:
            size = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4 + size
            continue
        if magic != MAGIC:
            raise ZstdError(f"bad magic {magic:#x}")
        fhd = data[pos]
        pos += 1
        fcs_flag = fhd >> 6
        single_segment = (fhd >> 5) & 1
        checksum = (fhd >> 2) & 1
        did_flag = fhd & 3
        if fhd & 0x08:
            raise ZstdError("reserved frame header bit set")
        if not single_segment:
            pos += 1  # window descriptor (we regenerate fully in memory)
        pos += (0, 1, 2, 4)[did_flag]
        fcs_len = (1 if single_segment else 0, 2, 4, 8)[fcs_flag]
        content_size = None
        if fcs_len:
            content_size = int.from_bytes(data[pos:pos + fcs_len], "little")
            if fcs_len == 2:
                content_size += 256
            pos += fcs_len
        ctx = {"rep": [1, 4, 8], "huf_table": None}
        frame_start = len(out)
        while True:
            if pos + 3 > n:
                raise ZstdError("truncated block header")
            bh = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last = bh & 1
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            if btype == 0:  # raw
                if pos + bsize > n:
                    raise ZstdError("truncated raw block")
                out += data[pos:pos + bsize]
                pos += bsize
            elif btype == 1:  # RLE
                if pos + 1 > n:
                    raise ZstdError("truncated RLE block")
                out += data[pos:pos + 1] * bsize
                pos += 1
            elif btype == 2:
                if pos + bsize > n:
                    raise ZstdError("truncated compressed block")
                _decode_block(data[pos:pos + bsize], ctx, out)
                pos += bsize
            else:
                raise ZstdError("reserved block type")
            if last:
                break
        if checksum:
            pos += 4
        if content_size is not None and \
                len(out) - frame_start != content_size:
            raise ZstdError("frame content size mismatch")
    if expected_size is not None and len(out) != expected_size:
        raise ZstdError(
            f"decompressed {len(out)} bytes, expected {expected_size}")
    return bytes(out)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _ll_code(v: int) -> int:
    if v < 16:
        return v
    for c in range(35, 15, -1):
        if v >= LL_BASE[c]:
            return c
    raise ZstdError("bad literal length")


def _ml_code(v: int) -> int:
    if v < 35:
        return v - 3
    for c in range(52, 31, -1):
        if v >= ML_BASE[c]:
            return c
    raise ZstdError("bad match length")


def _find_sequences(data: bytes, start: int, end: int, table: dict,
                    min_match: int = 4, rep_init: int = 1):
    """Match finder over data[start:end] with history back to offset 0
    (the whole frame is the window): hash-table candidates + a
    repeat-offset probe at the running rep1 (repeats are nearly free to
    encode, so they win ties) + 1-step lazy matching (defer when the
    next position holds a meaningfully longer match) — the zstd-level-
    3-style search the round-3 greedy encoder lacked.

    Returns (sequences [(lit_len, match_len, offset)], trailing_lit_start).
    """
    seqs = []
    anchor = start
    ip = start
    limit = end - 8  # keep a tail margin for match extension reads
    skip_acc = 0
    cur_rep = rep_init

    def probe(pos):
        """Best match starting at pos: (mlen, match_start)."""
        key = data[pos:pos + 4]
        cand = table.get(key)
        table[key] = pos
        best_len = 0
        best_m = 0
        if cand is not None and data[cand:cand + 4] == key:
            mlen = 4
            max_len = end - pos
            while mlen < max_len and data[cand + mlen] == data[pos + mlen]:
                mlen += 1
            best_len, best_m = mlen, cand
        r = pos - cur_rep
        if r >= 0 and data[pos:pos + 4] == data[r:r + 4]:
            mlen = 4
            max_len = end - pos
            while mlen < max_len and data[r + mlen] == data[pos + mlen]:
                mlen += 1
            # a rep-offset match costs ~0 offset bits: prefer unless the
            # table match is meaningfully longer
            if mlen + 1 >= best_len:
                best_len, best_m = mlen, r
        return best_len, best_m

    while ip < limit:
        mlen, m = probe(ip)
        if mlen < min_match:
            ip += 1 + (skip_acc >> 7)
            skip_acc += 1
            continue
        skip_acc = 0
        # 1-step lazy: a clearly longer match one byte later wins
        if ip + 1 < limit:
            ml2, m2 = probe(ip + 1)
            if ml2 > mlen + 2:
                ip += 1
                mlen, m = ml2, m2
        # extend backwards (match length grows with each step)
        while ip > anchor and m > 0 and data[ip - 1] == data[m - 1]:
            ip -= 1
            m -= 1
            mlen += 1
        seqs.append((ip - anchor, mlen, ip - m))
        cur_rep = ip - m
        ip += mlen
        anchor = ip
    return seqs, anchor


def _pack_literals_header(lit_type: int, regen: int, comp: int | None,
                          four_streams: bool) -> bytes:
    if lit_type in (0, 1):
        if regen <= 31:
            return bytes([lit_type | (regen << 3)])
        if regen <= 4095:
            return ((lit_type | (1 << 2) | (regen << 4))
                    .to_bytes(2, "little"))
        return (lit_type | (3 << 2) | (regen << 4)).to_bytes(3, "little")
    if not four_streams:
        assert regen <= 1023 and comp <= 1023
        return ((lit_type | (0 << 2) | (regen << 4) | (comp << 14))
                .to_bytes(3, "little"))
    if regen <= 1023 and comp <= 1023:
        return ((lit_type | (1 << 2) | (regen << 4) | (comp << 14))
                .to_bytes(3, "little"))
    if regen <= 16383 and comp <= 16383:
        return ((lit_type | (2 << 2) | (regen << 4) | (comp << 18))
                .to_bytes(4, "little"))
    return ((lit_type | (3 << 2) | (regen << 4) | (comp << 22))
            .to_bytes(5, "little"))


def _huf_encode_stream(lits: bytes, code_val, code_len) -> bytes:
    bw = BackBitWriter()
    for b in reversed(lits):
        bw.add(code_val[b], code_len[b])
    return bw.close()


def _encode_literals(lits: bytes) -> bytes:
    """Emit the literals section, choosing raw / RLE / Huffman-compressed."""
    n = len(lits)
    if n == 0:
        return _pack_literals_header(0, 0, None, False)
    if n >= 2 and lits.count(lits[0]) == n:
        return _pack_literals_header(1, n, None, False) + lits[:1]
    raw = _pack_literals_header(0, n, None, False) + lits
    if n < 64:
        return raw
    freqs = [0] * 256
    for b in lits:
        freqs[b] += 1
    built = build_huffman(freqs)
    if built is None:
        return raw
    weights, code_val, code_len = built
    try:
        tree_desc = write_huffman_weights(weights[:-1] if False else
                                          weights[: len(weights) - 1])
    except ZstdError:
        return raw
    four = n > 1023
    if four:
        seg = (n + 3) // 4
        parts = [lits[0:seg], lits[seg:2 * seg],
                 lits[2 * seg:3 * seg], lits[3 * seg:]]
        streams = [_huf_encode_stream(p, code_val, code_len) for p in parts]
        body = struct.pack("<3H", len(streams[0]), len(streams[1]),
                           len(streams[2])) + b"".join(streams)
    else:
        body = _huf_encode_stream(lits, code_val, code_len)
    comp = len(tree_desc) + len(body)
    hdr = _pack_literals_header(2, n, comp, four)
    if len(hdr) + comp >= len(raw):
        return raw
    return hdr + tree_desc + body


_LL_ENC = None
_OF_ENC = None
_ML_ENC = None


def _predef_encoders():
    global _LL_ENC, _OF_ENC, _ML_ENC
    if _LL_ENC is None:
        _LL_ENC = FseEncodeTable(LL_DEFAULT, LL_DEFAULT_LOG)
        _OF_ENC = FseEncodeTable(OF_DEFAULT, OF_DEFAULT_LOG)
        _ML_ENC = FseEncodeTable(ML_DEFAULT, ML_DEFAULT_LOG)
    return _LL_ENC, _OF_ENC, _ML_ENC


def _encode_sequences(seqs, rep: list | None = None) -> bytes:
    """Sequences section with all-predefined FSE tables.

    seqs: list of (lit_len, match_len, offset) with real offsets.
    ``rep`` is the running repeat-offset triple (mutated; pass the
    frame's encoder state): offsets matching a repeat slot emit the
    1-3 offset_value codes (RFC 8878 sec 3.1.1.3.2.1.1) — ~20 bits
    cheaper each than a literal offset."""
    n = len(seqs)
    if n == 0:
        return b"\x00"
    if rep is None:
        rep = [1, 4, 8]
    if n < 128:
        hdr = bytes([n])
    elif n < 0x7F00:
        hdr = bytes([128 + (n >> 8), n & 0xFF])
    else:
        hdr = bytes([255, (n - 0x7F00) & 0xFF, (n - 0x7F00) >> 8])
    hdr += b"\x00"  # modes byte: all predefined

    ll_c, ml_c, of_c = [], [], []
    ll_x, ml_x, of_x = [], [], []
    for ll, ml, off in seqs:
        # repeat-offset match, mirroring the decoder's resolution order
        if ll != 0:
            reps = (rep[0], rep[1], rep[2], None)
        else:
            reps = (rep[1], rep[2], rep[0] - 1, None)
        for i, r in enumerate(reps):
            if r == off:
                ov = i + 1
                break
        else:
            ov = off + 3
        # decoder-side rep update (must track exactly)
        if ov > 3:
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            idx = ov - 1 + (1 if ll == 0 else 0)
            if idx == 1:
                rep[1], rep[0] = rep[0], off
            elif idx >= 2:
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
        oc = ov.bit_length() - 1
        if oc > 28:
            raise ZstdError("offset too large for predefined table")
        lc = _ll_code(ll)
        mc = _ml_code(ml)
        ll_c.append(lc)
        ml_c.append(mc)
        of_c.append(oc)
        ll_x.append(ll - LL_BASE[lc])
        ml_x.append(ml - ML_BASE[mc])
        of_x.append(ov - (1 << oc))

    ll_t, of_t, ml_t = _predef_encoders()
    bw = BackBitWriter()
    s_ml = FseEncState(ml_t, ml_c[-1])
    s_of = FseEncState(of_t, of_c[-1])
    s_ll = FseEncState(ll_t, ll_c[-1])
    bw.add(ll_x[-1], LL_BITS[ll_c[-1]])
    bw.add(ml_x[-1], ML_BITS[ml_c[-1]])
    bw.add(of_x[-1], of_c[-1])
    for i in range(n - 2, -1, -1):
        s_of.encode(bw, of_c[i])
        s_ml.encode(bw, ml_c[i])
        s_ll.encode(bw, ll_c[i])
        bw.add(ll_x[i], LL_BITS[ll_c[i]])
        bw.add(ml_x[i], ML_BITS[ml_c[i]])
        bw.add(of_x[i], of_c[i])
    s_ml.flush(bw)
    s_of.flush(bw)
    s_ll.flush(bw)
    return hdr + bw.close()


def compress(data: bytes, level: int = 3,
             encode_literals=None) -> bytes:
    """Encode `data` as a single zstd frame (single-segment, known size).

    ``encode_literals``: optional replacement for the literals-section
    encoder (same contract as ``_encode_literals``) — the seam the device
    Huffman stage (ops/device_entropy.encode_literals_device) plugs
    into."""
    if encode_literals is None:
        encode_literals = _encode_literals
    n = len(data)
    out = bytearray(MAGIC.to_bytes(4, "little"))
    if n <= 255:
        out.append((0 << 6) | (1 << 5))
        out.append(n)
    elif n - 256 <= 0xFFFF:
        out.append((1 << 6) | (1 << 5))
        out += (n - 256).to_bytes(2, "little")
    elif n <= 0xFFFFFFFF:
        out.append((2 << 6) | (1 << 5))
        out += n.to_bytes(4, "little")
    else:
        out.append((3 << 6) | (1 << 5))
        out += n.to_bytes(8, "little")
    if n == 0:
        out += (1).to_bytes(3, "little")  # last, raw, size 0
        return bytes(out)

    table: dict = {}
    rep = [1, 4, 8]   # encoder-side repeat-offset state, frame-scoped
    pos = 0
    while pos < n:
        blen = min(BLOCK_MAX, n - pos)
        block = data[pos:pos + blen]
        last = 1 if pos + blen == n else 0
        payload = None
        if blen >= 32 and block.count(block[0]) == blen:
            out += ((last | (1 << 1) | (blen << 3))).to_bytes(3, "little")
            out.append(block[0])
            pos += blen
            continue
        seqs_raw, lit_tail = _find_sequences(data, pos, pos + blen, table,
                                             rep_init=rep[0])
        lits = bytearray()
        seqs = []
        cursor = pos
        for ll, ml, off in seqs_raw:
            lits += data[cursor:cursor + ll]
            seqs.append((ll, ml, off))
            cursor += ll + ml
        lits += data[lit_tail:pos + blen]
        rep_try = list(rep)
        try:
            payload = encode_literals(bytes(lits)) + \
                _encode_sequences(seqs, rep_try)
        except ZstdError:
            payload = None
        if payload is not None and len(payload) < blen:
            out += ((last | (2 << 1) | (len(payload) << 3))
                    ).to_bytes(3, "little")
            out += payload
            rep = rep_try   # commit: a raw fallback must not advance rep
        else:
            out += ((last | (0 << 1) | (blen << 3))).to_bytes(3, "little")
            out += block
        pos += blen
    return bytes(out)
