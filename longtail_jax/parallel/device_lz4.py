"""Device LZ4 block codec: batched device anchor scan + host assembly.

The match search (the O(n log n) part the reference spends its scalar
hash-chain loop on, lib/lz4/longtail_lz4.c:10 / vendored lz4 1.10) runs
on the device as the batched-sort anchor scan (parallel/device_match.py);
the byte-level LZ4 stream is assembled on the host by a ~60-line native
C walk (native/lz4_anchors.c, ops/lz4.assemble_anchors fallback) that
memcmp-validates and byte-extends every anchor, so device output is a
*hint*, never a correctness dependency.  Outputs decode with any
upstream LZ4 decoder.

Matches found through 4-byte-aligned 8-byte grams: offsets are
multiples of 4 (periodic data still compresses via lcm(period, 4)
offsets; the loss is one-off repeats at unaligned distances), but match
*extents* are byte-granular thanks to host extension — unlike the
round-3 design, which also quantized lengths.
"""

from __future__ import annotations

import numpy as np

from longtail_jax.parallel.device_match import (
    ROW_WORDS,
    collect_anchors,
    decode_anchors,
    submit_anchors,
)

ROW_BYTES = ROW_WORDS * 4


def block_anchors(src: bytes):
    """One-shot device anchor scan of a host buffer: returns
    position-sorted (pos, ref) byte-offset arrays (hints for any LZ
    assembler)."""
    import jax

    n = len(src)
    # pow2 row-count classes: one compiled anchor program per class
    # instead of one per distinct block size (upsyncs produce arbitrary
    # final-block sizes)
    npad = ROW_BYTES
    while npad < n:
        npad *= 2
    buf = np.zeros(npad, np.uint8)
    buf[:n] = np.frombuffer(src, np.uint8)
    words = jax.device_put(np.frombuffer(buf.tobytes(), "<u4"))
    rows, counts = collect_anchors(submit_anchors(words))
    pos, ref = decode_anchors(rows, counts, 0, rows.shape[0])
    keep = pos < n
    return pos[keep], ref[keep]


def compress_block(src: bytes) -> bytes:
    """Full device-codec path: device anchor scan + host byte assembly.

    Output is standard LZ4 block format.  Zero padding to the row
    geometry can only create anchors at/past ``len(src)`` (stripped) or
    referencing real bytes (validated by the assembler), so correctness
    is unconditional."""
    from longtail_jax.ops import lz4 as _lz4

    if len(src) < ROW_BYTES:
        return _lz4.compress(src)   # host path for sub-row blocks
    pos, ref = block_anchors(src)
    return _lz4.assemble_anchors(src, pos, ref)
