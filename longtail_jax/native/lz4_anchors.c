/* LZ4 block-format assembly from device match anchors.
 *
 * The device anchor scan (parallel/device_match.py) emits position-sorted
 * (pos, ref) hints: "an 8-byte gram at pos probably re-occurs at ref".
 * This walk owns correctness: every anchor is memcmp-validated and
 * byte-extended backward/forward, so any anchor list (including hash
 * collisions) yields a valid stream - worst case all-literals.  The
 * work is O(output + matched bytes): literals memcpy straight out of
 * the source block.
 *
 * Output is standard LZ4 block format (decodable by upstream lz4 and
 * ops/lz4.decompress).  Counterpart of the reference's compress-on-put
 * hot loop, lib/compressblockstore/longtail_compressblockstore.c:69-140.
 */
#include <stdint.h>
#include <string.h>

#define MINMATCH 4
#define MFLIMIT 12
#define LASTLITERALS 5
#define MAXDIST 65535

static long emit_len(uint8_t *dst, long o, long cap, long rest)
{
    rest -= 15;
    while (rest >= 255) {
        if (o >= cap) return -1;
        dst[o++] = 255;
        rest -= 255;
    }
    if (o >= cap) return -1;
    dst[o++] = (uint8_t)rest;
    return o;
}

long lt_lz4_assemble_anchors(const uint8_t *src, long n,
                             const int64_t *apos, const int64_t *aref,
                             long m, uint8_t *dst, long cap)
{
    long anchor = 0, o = 0;
    long mflimit = n - MFLIMIT;
    long mlimit = n - LASTLITERALS;
    for (long i = 0; i < m; i++) {
        long p = apos[i], r = aref[i];
        if (r < 0 || r >= p) continue;
        long off = p - r;
        if (off > MAXDIST) continue;
        /* anchors inside the previous match are covered by it; snapping
         * them to the cursor and re-scanning would turn a dense run
         * into a quadratic walk (upstream lz4 also skips past matches) */
        if (p < anchor) continue;
        if (p >= mflimit) continue;
        /* backward byte extension into the pending literals */
        while (p > anchor && r > 0 && src[p - 1] == src[r - 1]) {
            p--;
            r--;
        }
        /* forward scan, 32 bytes per iteration (matches can span tens
         * of KiB on tiled data; a byte loop caps assembly at
         * ~0.3 GB/s, an 8B loop at ~2); memcmp-validates the anchor as
         * a side effect */
        long lim = mlimit - p, l = 0;
        while (l + 32 <= lim) {
            uint64_t a0, b0, a1, b1, a2, b2, a3, b3;
            memcpy(&a0, src + p + l, 8);      memcpy(&b0, src + r + l, 8);
            memcpy(&a1, src + p + l + 8, 8);  memcpy(&b1, src + r + l + 8, 8);
            memcpy(&a2, src + p + l + 16, 8); memcpy(&b2, src + r + l + 16, 8);
            memcpy(&a3, src + p + l + 24, 8); memcpy(&b3, src + r + l + 24, 8);
            uint64_t x0 = a0 ^ b0, x1 = a1 ^ b1, x2 = a2 ^ b2, x3 = a3 ^ b3;
            if (x0 | x1 | x2 | x3) {
#if defined(__GNUC__) || defined(__clang__)
                if (x0)      l += (long)(__builtin_ctzll(x0) >> 3);
                else if (x1) l += 8 + (long)(__builtin_ctzll(x1) >> 3);
                else if (x2) l += 16 + (long)(__builtin_ctzll(x2) >> 3);
                else         l += 24 + (long)(__builtin_ctzll(x3) >> 3);
#else
                while (src[p + l] == src[r + l]) l++;
#endif
                goto scanned;
            }
            l += 32;
        }
        while (l + 8 <= lim) {
            uint64_t a, b;
            memcpy(&a, src + p + l, 8);
            memcpy(&b, src + r + l, 8);
            uint64_t x = a ^ b;
            if (x) {
#if defined(__GNUC__) || defined(__clang__)
                l += (long)(__builtin_ctzll(x) >> 3);
#else
                while (src[p + l] == src[r + l]) l++;
#endif
                goto scanned;
            }
            l += 8;
        }
        while (l < lim && src[p + l] == src[r + l]) l++;
scanned:
        if (l < MINMATCH) continue;
        long lit = p - anchor;
        long token_at = o;
        if (o + 1 + lit + lit / 255 + 3 > cap) return -1;
        long lit_code = lit >= 15 ? 15 : lit;
        long ml_code = l - MINMATCH >= 15 ? 15 : l - MINMATCH;
        dst[o++] = (uint8_t)((lit_code << 4) | ml_code);
        if (lit >= 15 && (o = emit_len(dst, o, cap, lit)) < 0) return -1;
        memcpy(dst + o, src + anchor, (size_t)lit);
        o += lit;
        if (o + 2 > cap) return -1;
        dst[o++] = (uint8_t)(off & 0xFF);
        dst[o++] = (uint8_t)(off >> 8);
        if (l - MINMATCH >= 15 &&
            (o = emit_len(dst, o, cap, l - MINMATCH)) < 0) return -1;
        (void)token_at;
        anchor = p + l;
    }
    long lit = n - anchor;
    if (o + 1 + lit + lit / 255 + 1 > cap) return -1;
    dst[o++] = (uint8_t)((lit >= 15 ? 15 : lit) << 4);
    if (lit >= 15 && (o = emit_len(dst, o, cap, lit)) < 0) return -1;
    memcpy(dst + o, src + anchor, (size_t)lit);
    o += lit;
    return o;
}
