"""Device Huffman entropy stage for the zstd literals path (RFC 8878
§4.2.1) — the SURVEY §7.4c "hard part": nothing entropy-coded on the
device until now.

Division of labor (by measurement, not ideology):
- **Histogram on device** (``make_hist_fn``): byte frequencies of the
  literals via vectorized compare-reductions over a bounded sample
  (frequencies only steer code lengths; sampling is what upstream zstd
  does for large inputs, and any frequency scale yields a valid code).
- **Table build on host**: package-merge length-limited Huffman over
  <= 256 symbols is microseconds of O(n log n) host work
  (ops/zstd_frame.build_huffman — the SAME canonical-code builder the
  from-spec frame codec uses, so streams stay upstream-decodable).
- **Bit-pack on device** (``make_hufpack_fn``): the backward Huffman
  bitstream.  Bit offset of literal i is the suffix-sum of code
  lengths (one cumsum); each 32-bit output word then OR-combines a
  bounded, ``searchsorted``-located run of shifted codes — contributors
  per word are bounded by 32/min_code_len + spill, so the pack is a
  fixed-fan-in gather instead of a sequential bit cursor.

``encode_literals_device`` mirrors zstd_frame._encode_literals
byte-for-byte (raw/RLE fallbacks, 1-vs-4-stream split, jump table),
so its output drops into any zstd frame and decodes with upstream
libzstd.  Conformance: tests/test_device_entropy.py.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from longtail_jax.ops.zstd_frame import (
    BLOCK_MAX,
    MAGIC,
    MAX_HUF_BITS,
    ZstdError,
    build_huffman,
    write_huffman_weights,
    _encode_sequences,
    _pack_literals_header,
)

_HIST_SAMPLE = 1 << 16     # histogram sample cap (64 KiB)


@functools.lru_cache(maxsize=4)
def make_hist_fn(n: int):
    """jit: (n,) u8 -> (256,) i32 exact byte histogram."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fn(x):
        xi = x.astype(jnp.int32).reshape(1, -1)
        bins = jnp.arange(256, dtype=jnp.int32)[:, None]
        return jnp.sum((xi == bins).astype(jnp.int32), axis=1)

    return fn


def device_histogram(lits: np.ndarray) -> np.ndarray:
    """Byte frequencies for table construction: exact for small inputs,
    strided sample (upstream-style) past _HIST_SAMPLE."""
    n = len(lits)
    if n > _HIST_SAMPLE:
        lits = lits[:: -(-n // _HIST_SAMPLE)]
    npad = 1 << max(10, (len(lits) - 1).bit_length())
    buf = np.zeros(npad, np.uint8)
    buf[: len(lits)] = lits
    h = np.asarray(make_hist_fn(npad)(buf)).copy()
    h[0] -= npad - len(lits)
    return h


@functools.lru_cache(maxsize=16)
def make_hufpack_fn(n_pad: int, n_streams: int):
    """jit: (lits (S, n_pad) u8, n_lit (S,) i32, code_val (256,) i32,
    code_len (256,) i32) -> (words (S, W) u32, total_bits (S,) i32).

    Produces, per stream row, EXACTLY the bit pattern of
    zstd_frame._huf_encode_stream before the sentinel: literal i's code
    sits at bit offset sum(len[j] for j > i), bits stacked LSB-up.

    The combine exploits that Huffman code bits are DISJOINT across
    literals: scatter-ADD of each literal's two shifted word
    contributions equals the bitwise OR, so packing is one cumsum + two
    table gathers + two n-element scatter-adds — no per-word fan-in
    loop.  The sum is exact in any order, so atomic scatter-adds on a
    GPU give the same words as the sequential host encoder."""
    import jax
    import jax.numpy as jnp

    W = (n_pad * MAX_HUF_BITS + 31) // 32 + 1
    u32 = jnp.uint32

    @jax.jit
    def fn(lits, n_lit, code_val, code_len):
        b = lits.astype(jnp.int32)                       # (S, n_pad)
        idx = jnp.arange(n_pad, dtype=jnp.int32)[None, :]
        live = idx < n_lit[:, None]
        L = jnp.where(live, jnp.take(code_len, b), 0)    # (S, n_pad)
        V = jnp.where(live, jnp.take(code_val, b), 0).astype(u32)
        csum = jnp.cumsum(L, axis=1)                     # inclusive
        total = csum[:, -1]                              # (S,)
        bitoff = (total[:, None] - csum)                 # offset of lit i
        sh = (bitoff & 31).astype(u32)
        lo = V << sh
        hi = (V >> (u32(31) - sh)) >> u32(1)             # spill word
        w0 = (bitoff >> 5)                               # (S, n_pad)

        def pack_row(lo_r, hi_r, w0_r):
            acc = jnp.zeros((W,), u32)
            acc = acc.at[w0_r].add(lo_r, mode="drop")
            acc = acc.at[w0_r + 1].add(hi_r, mode="drop")
            return acc

        words = jax.vmap(pack_row)(lo, hi, w0)
        return words, total

    return fn


def _pack_streams_device(parts: list[np.ndarray], code_val,
                         code_len) -> list[bytes]:
    """Device-pack each literal stream; returns host byte strings with
    the sentinel bit appended (BackBitWriter.close semantics)."""
    n_pad = 1 << max(8, (max(len(p) for p in parts) - 1).bit_length())
    S = len(parts)
    lits = np.zeros((S, n_pad), np.uint8)
    n_lit = np.zeros((S,), np.int32)
    for i, p in enumerate(parts):
        lits[i, : len(p)] = p
        n_lit[i] = len(p)
    fn = make_hufpack_fn(n_pad, S)
    words, totals = fn(lits, n_lit,
                       np.asarray(code_val + [0] * (256 - len(code_val)),
                                  np.int32),
                       np.asarray(code_len + [0] * (256 - len(code_len)),
                                  np.int32))
    words = np.asarray(words)
    totals = np.asarray(totals)
    out = []
    for i in range(S):
        t = int(totals[i])
        w = words[i].copy()
        w[t >> 5] |= np.uint32(1 << (t & 31))        # sentinel bit
        nbytes = (t + 1 + 7) // 8
        out.append(w.tobytes()[:nbytes])
    return out


def encode_literals_device(lits: bytes) -> bytes:
    """Device-entropy literals section, byte-compatible with
    zstd_frame._encode_literals (drop-in for any zstd frame)."""
    n = len(lits)
    if n == 0:
        return _pack_literals_header(0, 0, None, False)
    if n >= 2 and lits.count(lits[0]) == n:
        return _pack_literals_header(1, n, None, False) + lits[:1]
    raw = _pack_literals_header(0, n, None, False) + lits
    if n < 64:
        return raw
    arr = np.frombuffer(lits, np.uint8)
    freqs = device_histogram(arr).tolist()
    # sampled histogram may miss rare symbols: every literal present in
    # the data MUST have a code, so backfill exact presence cheaply
    if n > _HIST_SAMPLE:
        present = np.flatnonzero(np.bincount(arr, minlength=256))
        for s in present:
            if freqs[s] == 0:
                freqs[s] = 1
    built = build_huffman(freqs)
    if built is None:
        return raw
    weights, code_val, code_len = built
    try:
        tree_desc = write_huffman_weights(weights[: len(weights) - 1])
    except ZstdError:
        return raw
    four = n > 1023
    if four:
        seg = (n + 3) // 4
        parts = [arr[0:seg], arr[seg:2 * seg], arr[2 * seg:3 * seg],
                 arr[3 * seg:]]
        streams = _pack_streams_device(parts, code_val, code_len)
        body = struct.pack("<3H", len(streams[0]), len(streams[1]),
                           len(streams[2])) + b"".join(streams)
    else:
        body = _pack_streams_device([arr], code_val, code_len)[0]
    comp = len(tree_desc) + len(body)
    hdr = _pack_literals_header(2, n, comp, four)
    if len(hdr) + comp >= len(raw):
        return raw
    return hdr + tree_desc + body


# ---------------------------------------------------------------------------
# frame assembly from device-found sequences
# ---------------------------------------------------------------------------


def _split_blocks(seq_rows, n: int):
    """Slice a whole-input sequence list into <= BLOCK_MAX zstd blocks.

    seq_rows: (m, 4) u32 ZSTD_Sequence rows (offset, litLength,
    matchLength, rep) covering src in order; bytes not covered by any
    sequence are literals.  Returns [(block_len, [(ll, ml, off)],
    tail_literal_bytes)]: a match straddling a block boundary splits (or
    degrades to literals when a side would fall under zstd's 3-byte
    minimum match — boundary-only, ~64 spots per 8 MiB).  Offsets may
    reach before the block start: the frame window is the whole input."""
    # normalize to (ll, ml, off) events; the gap after the last sequence
    # becomes a final literal-only event
    rows = [(int(r[1]), int(r[2]), int(r[0])) for r in seq_rows]
    covered = sum(ll + ml for ll, ml, _ in rows)
    if covered < n:
        rows.append((n - covered, 0, 0))

    blocks = []
    cur: list = []      # sequences of the open block
    cur_tail = 0        # literal bytes after the open block's last seq
    bstart = 0
    c = 0               # absolute cursor

    def close():
        nonlocal bstart, cur, cur_tail
        blocks.append((c - bstart, cur, cur_tail))
        bstart = c
        cur = []
        cur_tail = 0

    i = 0
    pend_ll = 0         # literals carried across a boundary/split
    while i < len(rows):
        ll, ml, off = rows[i]
        ll += pend_ll
        pend_ll = 0
        be = bstart + min(BLOCK_MAX, n - bstart)
        if c + ll + ml <= be:                    # fits entirely
            if ml > 0:
                cur.append((ll, ml, off))
            else:
                cur_tail += ll
            c += ll + ml
            i += 1
            if c == be and c < n:
                close()
            continue
        if c + ll >= be:                         # literal run crosses
            head = be - c
            cur_tail += head
            c = be
            rows[i] = (ll - head, ml, off)
            close()
            continue
        m1 = be - (c + ll)                       # match crosses
        m2 = ml - m1
        if m1 >= 3:
            cur.append((ll, m1, off))
            rows[i] = (0, m2, off) if m2 >= 3 else (m2, 0, 0)
        else:
            cur_tail += ll + m1                  # too short: literals
            rows[i] = (0, m2, off) if m2 >= 3 else (m2, 0, 0)
        c = be
        close()
    if c > bstart or not blocks:
        close()
    return blocks


def frame_from_sequences(src: bytes, seq_rows,
                         encode_literals=None) -> bytes:
    """One standard zstd frame for ``src`` using externally-found
    sequences (the device anchor scan's output) — the from-spec replacement
    for libzstd's ZSTD_compressSequences, with the literals section
    routed through the device Huffman stage by default.

    Decodable by upstream zstd and ops/zstd_frame.decompress."""
    if encode_literals is None:
        encode_literals = encode_literals_device
    n = len(src)
    out = bytearray(MAGIC.to_bytes(4, "little"))
    if n <= 255:
        out.append((0 << 6) | (1 << 5))
        out.append(n)
    elif n - 256 <= 0xFFFF:
        out.append((1 << 6) | (1 << 5))
        out += (n - 256).to_bytes(2, "little")
    else:
        out.append((2 << 6) | (1 << 5))
        out += n.to_bytes(4, "little")
    if n == 0:
        out += (1).to_bytes(3, "little")
        return bytes(out)

    rep = [1, 4, 8]
    pos = 0
    for blen, seqs, tail_lits in _split_blocks(seq_rows, n):
        last = 1 if pos + blen == n else 0
        parts = []
        c = pos
        for ll, ml, off in seqs:
            parts.append(src[c:c + ll])
            c += ll + ml
        parts.append(src[c:c + tail_lits])
        lits = b"".join(parts)
        rep_try = list(rep)
        try:
            payload = encode_literals(lits) + \
                _encode_sequences(seqs, rep_try)
        except ZstdError:
            payload = None
        if payload is not None and len(payload) < blen:
            out += ((last | (2 << 1) | (len(payload) << 3))
                    ).to_bytes(3, "little")
            out += payload
            rep = rep_try
        else:
            out += ((last | (0 << 1) | (blen << 3))).to_bytes(3, "little")
            out += src[pos:pos + blen]
        pos += blen
    return bytes(out)
