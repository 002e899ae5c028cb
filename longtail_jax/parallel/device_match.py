"""Device LZ match-anchor finding: the device half of the block codecs.

The reference compresses blocks with upstream LZ4/zstd scalar hash-chain
loops (lib/lz4/longtail_lz4.c:10, lib/zstd/longtail_zstd.c:11-22).  A
port would serialize on the device; one flat ``lax.sort`` over a whole
block is data-parallel but sorts far more than the codec needs.  This
design exploits the codec's *window locality* with a *batched* sort of
short rows:

1. Sample an 8-byte gram at every word (4-byte stride) of the stream.
2. Split samples into rows of ``W`` = 16Ki words (64 KiB of data) and
   sort ALL rows in one batched single-operand ``lax.sort``: the sort
   key packs (hash<<14 | position) into one u32, so equal-hash samples
   are neighbors ordered by position; short row-local sorts stay in
   fast memory.  The full 32-bit gram hash rides
   along as the one payload array to reject packed-key collisions.
3. A sample matches when its sorted predecessor has the same 32-bit
   hash: the nearest earlier occurrence (<= 64 KiB back, always inside
   the LZ4 window).  No gram verification on device — anchors are
   *hints*; the host assembler memcmp-validates and byte-extends them,
   so a hash collision costs ratio, never correctness.
4. A second batched single-operand sort compacts candidates to the row
   front in position order; consecutive (+1,+1) chains collapse to
   their first anchor (the host's forward extension covers the rest),
   and a third tiny sort repacks the survivors.

The device->host payload is (rows, Cmax) packed anchors + per-row
counts, adaptively trimmed — O(distinct matches), not O(bytes).  The
host walk (native/lz4_anchors.c) is O(output): literals memcpy straight
out of the block, matches extend byte-granular in both directions (so
the word-aligned sampling costs only sub-12-byte and non-4-aligned
matches, not match *length* precision).

Anchors are codec-neutral: the LZ4 assembler (ops/lz4.assemble_anchors)
and the zstd sequence encoder both consume them.

Matches the reference hot loop 3: compress-on-put,
lib/compressblockstore/longtail_compressblockstore.c:69-140.
"""

from __future__ import annotations

import functools

import numpy as np

ROW_WORDS = 16384        # samples per sort row = 64 KiB of data
MAX_ANCHORS = 2048       # compacted anchors kept per row

_POS_BITS = 14
_POS_MASK = (1 << _POS_BITS) - 1


@functools.lru_cache(maxsize=8)
def make_anchor_fn(n_words: int, row_words: int = ROW_WORDS,
                   cap: int = MAX_ANCHORS):
    """jit: (n_words,) u32 word stream -> (packed (S, cap) u32,
    counts (S,) i32) with S = n_words // row_words.

    packed[s, j] for j < counts[s] encodes an anchor of row s:
    bits [14, 28) = sample position within the row, bits [0, 14) = the
    matching earlier sample position (same row, so the byte offset is
    at most row_words * 4 - 4 <= 65532: always LZ4-encodable).  Entries
    past counts[s] have bit 28 set.  Trailing words beyond S * row_words
    are ignored.
    """
    import jax
    import jax.numpy as jnp

    S = n_words // row_words
    assert S >= 1 and row_words == 1 << _POS_BITS
    u32 = jnp.uint32
    K = S * row_words

    @jax.jit
    def fn(words):
        w0 = words[:K]
        w1 = jnp.concatenate([words[1:K], jnp.zeros((1,), u32)])
        # gram hash: fibonacci-style multiplicative mixing of the
        # 8-byte gram into 32 bits
        h = (w0 * u32(0x9E3779B1)) ^ ((w1 * u32(0x85EBCA77)) >> u32(13)) \
            ^ (w1 << u32(7))
        pos = jax.lax.broadcasted_iota(jnp.int32, (S, row_words), 1)
        posu = pos.astype(u32)
        key = ((h >> u32(_POS_BITS)) << u32(_POS_BITS)).reshape(
            S, row_words) | posu
        ks, hs = jax.lax.sort(
            (key, h.reshape(S, row_words)), dimension=1, num_keys=1)

        def prevc(a):
            return jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)

        col0 = pos == 0
        cand = (~col0) & ((ks >> u32(_POS_BITS)) ==
                          (prevc(ks) >> u32(_POS_BITS))) & (hs == prevc(hs))
        spos = ks & u32(_POS_MASK)
        sref = prevc(ks) & u32(_POS_MASK)
        key2 = jnp.where(cand, u32(0), u32(1 << 28)) | \
            (spos << u32(_POS_BITS)) | sref
        # full-width positional compaction — the chain check below needs
        # position adjacency over ALL candidates; truncating first would
        # let one dense run starve the rest of the row of anchor slots
        s2 = jax.lax.sort(key2, dimension=1)                # (S, W)

        apos = (s2 >> u32(_POS_BITS)) & u32(_POS_MASK)
        aref = s2 & u32(_POS_MASK)
        valid = (s2 >> u32(28)) == 0
        # chain suppression: an anchor continuing its predecessor's run
        # (+1 position, +1 ref) is covered by the host's forward
        # extension from the run's first anchor.  Gap-2 same-offset
        # continuations are also suppressed: a packed-key collision
        # knocks one position out of a run (~W^2/2^19 per row) and
        # would otherwise restart the chain, multiplying anchor counts
        # ~10x on tiled data.  (Gap >= 3 is kept: struct-like spans —
        # repeated words — legitimately re-anchor at distance 3.)
        dpos = apos - prevc(apos)
        dref = aref - prevc(aref)
        chain = valid & prevc(valid) & (dpos == dref) & \
            (dpos >= 1) & (dpos <= 2)
        keep = valid & ~chain
        key3 = jnp.where(keep, u32(0), u32(1 << 28)) | \
            (apos << u32(_POS_BITS)) | aref
        s3 = jax.lax.sort(key3, dimension=1)[:, :cap]       # (S, cap)
        counts = jnp.minimum(jnp.sum(keep, axis=1),
                             cap).astype(jnp.int32)
        return s3, counts

    return fn


@functools.lru_cache(maxsize=32)
def _make_trim_fn(cap: int, k: int):
    import jax

    return jax.jit(lambda a: a[:, :k])


# ---------------------------------------------------------------------------
# fast tier: content-defined bin-sampled anchors (1/BIN density)
# ---------------------------------------------------------------------------

BIN_WORDS = 64           # one sampled anchor per 64 words (256 B)
FAST_CAP = 4096          # anchors kept per block
_GPOS_BITS = 22          # block word-position bits (<= 16 MiB blocks)


@functools.lru_cache(maxsize=8)
def make_fast_anchor_fn(n_words: int, block_words: int,
                        cap: int = FAST_CAP,
                        max_offset_words: int = 16383,
                        suppress_sampled_chains: bool = True):
    """jit: (n_words,) u32 words -> (pos (B, cap) i32 word positions,
    ref (B, cap) i32, counts (B,) i32) per block of ``block_words``.

    ``max_offset_words`` bounds the match distance (16383 words = the
    LZ4 64 KiB window; pass block_words for zstd's whole-block window) —
    out-of-window candidates must be dropped on device or they starve
    the per-block anchor cap on self-similar data.

    The fast tier samples ONE anchor per 64-word bin — the position
    minimizing the gram hash, a shift-invariant (content-defined)
    choice, so both copies of a repeated span >= ~2 bins sample the
    same relative position — then matches the 1/64-density anchor set
    with one small batched sort per block.  ~10x cheaper than the
    full-density tier and finds matches at ANY offset within the block
    (the LZ4 assembler clips to 64 KiB; the zstd path uses the full
    range).  Misses fine-grained structure (repeats < ~512 B), which
    the full-density tier exists for.

    The redesign of zstd's long-distance-matcher idea for a batched
    device sort (reference codec seam: lib/zstd/longtail_zstd.c:11-22).
    """
    import jax
    import jax.numpy as jnp

    assert block_words % BIN_WORDS == 0
    # ceil: a trailing partial block is zero-padded, not dropped
    nblk = max(1, -(-n_words // block_words))
    K = nblk * block_words
    nbins_b = block_words // BIN_WORDS

    @jax.jit
    def fn(words):
        words = words.reshape(-1)
        if K > words.shape[0]:
            words = jnp.concatenate(
                [words, jnp.zeros((K - words.shape[0],), jnp.uint32)])
        m = bin_mins_from_words(words, K)
        return _anchors_from_bin_mins(m, nblk, nbins_b, cap,
                                      max_offset_words,
                                      suppress_sampled_chains)

    return fn


def bin_mins_from_words(words, K: int):
    """(>= K words) u32 stream -> (K // BIN_WORDS,) packed per-bin
    argmin values: top 26 bits = min gram hash, low 6 = its word
    position within the bin.  Shift-invariant content-defined sampling.
    The stage-1 program computes it from the same word rows it emits
    (stage1.py), so the pipeline never re-reads the bytes."""
    import jax
    import jax.numpy as jnp

    u32 = jnp.uint32
    words = words.reshape(-1)
    w0 = words[:K]
    w1 = jnp.concatenate([words[1:K], jnp.zeros((1,), u32)])
    h = (w0 * u32(0x9E3779B1)) ^ ((w1 * u32(0x85EBCA77)) >> u32(13)) \
        ^ (w1 << u32(7))
    pos6 = jax.lax.broadcasted_iota(
        jnp.int32, (K // BIN_WORDS, BIN_WORDS), 1).astype(u32)
    packed = (h.reshape(-1, BIN_WORDS) & ~u32(BIN_WORDS - 1)) | pos6
    return jnp.min(packed, axis=1)


def _anchors_from_bin_mins(m, nblk: int, nbins_b: int, cap: int,
                           max_offset_words: int,
                           suppress_sampled_chains: bool):
    """The anchor-extraction tail shared by the standalone fast scan and
    the stage-1-fused path: batched sorts over the 1/64-density bin-min
    samples (trace under jit)."""
    import jax
    import jax.numpy as jnp

    u32 = jnp.uint32
    lg = BIN_WORDS.bit_length() - 1
    hmin = m >> u32(lg)                         # 26-bit min-hash
    binpos = (jax.lax.broadcasted_iota(
        jnp.int32, (nblk, nbins_b), 1).astype(u32) << u32(lg))
    gpos = binpos.reshape(-1) + (m & u32(BIN_WORDS - 1))
    hs, ps = jax.lax.sort(
        (hmin.reshape(nblk, nbins_b), gpos.reshape(nblk, nbins_b)),
        dimension=1, num_keys=2)

    def prevc(a):
        return jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)

    col = jax.lax.broadcasted_iota(jnp.int32, (nblk, nbins_b), 1)
    cand = (col > 0) & (hs == prevc(hs)) & \
        (ps - prevc(ps) <= u32(max_offset_words))
    # positional compaction (full width): (flag | gpos) ascending,
    # ref rides as payload
    key2 = jnp.where(cand, u32(0), u32(1) << u32(_GPOS_BITS)) | ps
    k2, ref = jax.lax.sort((key2, prevc(ps)), dimension=1, num_keys=1)
    apos = k2 & (u32(1 << _GPOS_BITS) - u32(1))
    valid = (k2 >> u32(_GPOS_BITS)) == 0
    # chain suppression BEFORE the cap (a chained run would starve
    # it): (a) same-offset continuations within ~4 bins, and (b)
    # anchors whose ref IS the previous anchor's position — the
    # sampled-occurrence chain a periodic region produces even when
    # bin-phase wobble makes the deltas unequal.  Both are covered
    # by the host's forward extension from the run's first anchor.
    dpos = apos - prevc(apos)
    dref = ref - prevc(ref)
    # dpos >= 1 excludes the column-0 self-compare (dpos == dref == 0
    # would suppress every chain HEAD, zeroing out pure-periodic rows)
    chain = valid & prevc(valid) & (dpos >= u32(1)) & \
        (dpos == dref) & (dpos <= u32(4 * BIN_WORDS))
    if suppress_sampled_chains:
        # anchors whose ref IS the previous anchor's position: the
        # sampled-occurrence chain a periodic region produces even
        # when bin-phase wobble makes the deltas unequal.  Vital for
        # the LZ4 tier (a wobbly-periodic block otherwise floods the
        # cap); the zstd tier keeps these anchors — its whole-block
        # window + entropy stage turn them into cheap sequences and
        # over-suppression costs ratio at content transitions.
        chain = chain | (valid & prevc(valid) & (dpos >= u32(1)) &
                         (ref == prevc(apos)))
    keep = valid & ~chain
    key3 = jnp.where(keep, u32(0), u32(1) << u32(_GPOS_BITS)) | apos
    k3, ref3 = jax.lax.sort((key3, ref), dimension=1, num_keys=1)
    k3 = k3[:, :cap]
    ref3 = ref3[:, :cap]
    valid3 = (k3 >> u32(_GPOS_BITS)) == 0
    counts = jnp.minimum(jnp.sum(keep, axis=1), cap).astype(jnp.int32)
    pos_out = jnp.where(valid3, k3, 0).astype(jnp.int32)
    ref_out = jnp.where(valid3, ref3, 0).astype(jnp.int32)
    return pos_out, ref_out, counts


@functools.lru_cache(maxsize=8)
def make_fast_anchor_packed_fn(n_words: int, block_words: int,
                               cap: int = FAST_CAP,
                               max_offset_words: int = 16383):
    """Single-output form of make_fast_anchor_fn: (B, 2*cap + 1) i32 =
    [pos row | ref row | count] per block, so the whole result rides ONE
    device->host fetch per batch."""
    import jax
    import jax.numpy as jnp

    base = make_fast_anchor_fn(n_words, block_words, cap,
                               max_offset_words)

    @jax.jit
    def fn(words):
        pos, ref, counts = base(words)
        return jnp.concatenate([pos, ref, counts[:, None]], axis=1)

    return fn


@functools.lru_cache(maxsize=8)
def make_bins_anchor_packed_fn(n_bins: int, bins_per_block: int,
                               cap: int = FAST_CAP,
                               max_offset_words: int = 16383,
                               suppress_sampled_chains: bool = True):
    """Anchor extraction straight from precomputed per-bin packed mins
    (the stage-1 scan kernel's fused output): (n_bins,) u32 ->
    (B, 2*cap + 1) i32 single-fetch result.  Skips the whole-stream
    hash + reduce pass — the bytes were already read by stage 1.

    A trailing partial block is padded with no-candidate sentinels (the
    padding bins can only pair among themselves or produce anchors past
    the real data, which the host assembler's memcmp rejects) — flooring
    would silently drop the tail block's anchors entirely."""
    import jax
    import jax.numpy as jnp

    nblk = -(-n_bins // bins_per_block)

    @jax.jit
    def fn(bins):
        m = bins.reshape(-1)
        pad = nblk * bins_per_block - m.shape[0]
        if pad:
            m = jnp.concatenate(
                [m, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])
        pos, ref, counts = _anchors_from_bin_mins(
            m, nblk, bins_per_block, cap, max_offset_words,
            suppress_sampled_chains)
        return jnp.concatenate([pos, ref, counts[:, None]], axis=1)

    return fn


def fast_block_anchors(words, block_words: int, cap: int = FAST_CAP,
                       max_offset_words: int = 16383,
                       suppress_sampled_chains: bool = True):
    """One-shot fast-tier scan: returns per-block position-sorted
    (pos_bytes, ref_bytes) anchor lists."""
    n = int(np.prod(words.shape))
    pos, ref, counts = make_fast_anchor_fn(
        n, block_words, cap, max_offset_words,
        suppress_sampled_chains)(words)
    pos = np.asarray(pos)
    ref = np.asarray(ref)
    counts = np.asarray(counts)
    out = []
    for b in range(pos.shape[0]):
        c = int(counts[b])
        out.append((pos[b, :c].astype(np.int64) * 4,
                    ref[b, :c].astype(np.int64) * 4))
    return out


def submit_anchors(words, row_words: int = ROW_WORDS,
                   cap: int = MAX_ANCHORS):
    """Async half: dispatch the anchor scan over a device word stream,
    start the counts D2H copy, return a handle.  Callers pipelining many
    batches submit them all before collecting."""
    n = int(words.shape[0])
    packed, counts = make_anchor_fn(n, row_words, cap)(words)
    counts.copy_to_host_async()
    return (packed, counts, row_words, cap)


def collect_anchors(handle):
    """Sync half: fetch counts + the adaptively trimmed anchor rows.

    Returns (rows (S, Cmax) u32 packed anchors, counts (S,) i32).  Two
    device syncs per batch (counts, then the trimmed payload)."""
    packed, counts, row_words, cap = handle
    counts = np.asarray(counts)
    cmax = int(counts.max()) if counts.size else 0
    k = 8
    while k < cmax:
        k *= 2
    k = min(k, cap)
    rows = np.asarray(_make_trim_fn(cap, k)(packed))
    return rows, counts


def decode_anchors(rows: np.ndarray, counts: np.ndarray, row0: int,
                   n_rows: int, base_bytes: int = 0,
                   row_words: int = ROW_WORDS):
    """Decode rows [row0, row0 + n_rows) into position-sorted byte-offset
    anchor arrays (pos, ref) relative to the span starting at the global
    byte offset ``base_bytes`` (= row0 * row_words * 4 for span-aligned
    callers)."""
    sel = rows[row0: row0 + n_rows]
    cnt = counts[row0: row0 + n_rows]
    k = sel.shape[1]
    j = np.arange(k, dtype=np.int32)[None, :]
    mask = j < cnt[:, None]
    vals = sel[mask]                      # row-major: position-sorted
    rowi = np.broadcast_to(
        np.arange(n_rows, dtype=np.int64)[:, None], sel.shape)[mask]
    rbase = (row0 + rowi) * row_words * 4 - base_bytes
    pos = (rbase + ((vals >> _POS_BITS) & _POS_MASK) * 4).astype(np.int64)
    ref = (rbase + (vals & _POS_MASK) * 4).astype(np.int64)
    return pos, ref
