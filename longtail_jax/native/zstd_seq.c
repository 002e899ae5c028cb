/* zstd sequence assembly from device match anchors.
 *
 * Counterpart of lz4_anchors.c for the zstd codec seam
 * (lib/zstd/longtail_zstd.c:11-22): the device anchor scan proposes
 * (pos, ref) hints; this walk memcmp-validates and byte-extends each
 * into a ZSTD_Sequence-compatible (offset, litLength, matchLength)
 * triple.  The caller hands the triples to libzstd's
 * ZSTD_compressSequences (entropy stage), so the output is a standard
 * zstd frame.  Any anchor list yields a valid sequence set.
 */
#include <stdint.h>
#include <string.h>

#define ZSTD_MINMATCH 4

/* out: 4 u32 per sequence = {offset, litLength, matchLength, rep=0}.
 * Returns the number of sequences written (<= max_seq). */
long lt_zstd_sequences(const uint8_t *src, long n,
                       const int64_t *apos, const int64_t *aref, long m,
                       uint32_t *out, long max_seq)
{
    long anchor = 0, k = 0;
    for (long i = 0; i < m && k < max_seq; i++) {
        long p = apos[i], r = aref[i];
        if (r < 0 || r >= p) continue;
        if (p < anchor) continue;     /* covered by the previous match */
        if (p >= n - 16) continue;
        while (p > anchor && r > 0 && src[p - 1] == src[r - 1]) {
            p--;
            r--;
        }
        /* leave a literal tail margin: some libzstd versions reject
         * sequence sets whose last match runs to the very end */
        long lim = n - 8 - p, l = 0;
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
        if (l < ZSTD_MINMATCH) continue;
        out[4 * k + 0] = (uint32_t)(p - r);
        out[4 * k + 1] = (uint32_t)(p - anchor);
        out[4 * k + 2] = (uint32_t)l;
        out[4 * k + 3] = 0;
        k++;
        anchor = p + l;
    }
    return k;
}
