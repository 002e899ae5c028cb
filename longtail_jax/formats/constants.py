"""Format version IDs and type tags, bit-compatible with the reference.

Reference: src/longtail.c:16-24 (format versions),
lib/blake3/longtail_blake3.c:6, lib/blake2/longtail_blake2.c:9,
lib/meowhash/longtail_meowhash.c:7 (hash type IDs),
lib/zstd/longtail_zstd.c:17-22, lib/lz4/longtail_lz4.c:10,
lib/brotli/longtail_brotli.c:24-30 (compression type tags).
"""

from __future__ import annotations


def fourcc(tag: str) -> int:
    """Pack up to 4 chars big-endian into a uint32 tag (reference packs
    ``(c0<<24)|(c1<<16)|(c2<<8)|c3``)."""
    value = 0
    for ch in tag:
        value = (value << 8) | ord(ch)
    value <<= 8 * (4 - len(tag))
    return value


def _version(major: int, minor: int, patch: int) -> int:
    # src/longtail.c:16 LONGTAIL_VERSION macro
    return (major << 24) | (minor << 16) | patch


VERSION_INDEX_VERSION_0_0_1 = _version(0, 0, 1)
VERSION_INDEX_VERSION_0_0_2 = _version(0, 0, 2)
STORE_INDEX_VERSION_1_0_0 = _version(1, 0, 0)
ARCHIVE_VERSION_0_0_1 = _version(0, 0, 1)

CURRENT_VERSION_INDEX_VERSION = VERSION_INDEX_VERSION_0_0_2
CURRENT_STORE_INDEX_VERSION = STORE_INDEX_VERSION_1_0_0
CURRENT_ARCHIVE_VERSION = ARCHIVE_VERSION_0_0_1

# Hash type identifiers
HASH_TYPE_BLAKE2 = fourcc("blk2")
HASH_TYPE_BLAKE3 = fourcc("blk3")
HASH_TYPE_MEOW = fourcc("meow")

# Compression type tags.  0 = store raw
# (lib/compressblockstore/longtail_compressblockstore.c:86-93).
COMPRESSION_TYPE_NONE = 0

_ZSTD_BASE = fourcc("ztd")          # 'z','t','d',0
COMPRESSION_TYPE_ZSTD_MIN = _ZSTD_BASE + ord("1")
COMPRESSION_TYPE_ZSTD_DEFAULT = _ZSTD_BASE + ord("2")
COMPRESSION_TYPE_ZSTD_MAX = _ZSTD_BASE + ord("3")
COMPRESSION_TYPE_ZSTD_HIGH = _ZSTD_BASE + ord("4")
COMPRESSION_TYPE_ZSTD_LOW = _ZSTD_BASE + ord("5")

COMPRESSION_TYPE_LZ4_DEFAULT = fourcc("lz42")

_BROTLI_BASE = fourcc("btl")
COMPRESSION_TYPE_BROTLI_GENERIC_MIN = _BROTLI_BASE + ord("0")
COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT = _BROTLI_BASE + ord("1")
COMPRESSION_TYPE_BROTLI_GENERIC_MAX = _BROTLI_BASE + ord("2")
COMPRESSION_TYPE_BROTLI_TEXT_MIN = _BROTLI_BASE + ord("a")
COMPRESSION_TYPE_BROTLI_TEXT_DEFAULT = _BROTLI_BASE + ord("b")
COMPRESSION_TYPE_BROTLI_TEXT_MAX = _BROTLI_BASE + ord("c")

# CLI defaults (cmd/main.c:3003-3009)
DEFAULT_TARGET_CHUNK_SIZE = 32768
DEFAULT_TARGET_BLOCK_SIZE = 8 * 1024 * 1024
DEFAULT_MAX_CHUNKS_PER_BLOCK = 1024
DEFAULT_MIN_BLOCK_USAGE_PERCENT = 80

# Chunker parameter derivation (src/longtail.c:1985-1987):
# min = target/8, avg = target/2, max = target*2, each clamped below by the
# chunker's minimum window (48 bytes).
CHUNKER_WINDOW_SIZE = 48


def chunker_params_from_target(target_chunk_size: int,
                               min_chunk_size: int = CHUNKER_WINDOW_SIZE):
    """(min, avg, max) chunker params for a target chunk size."""
    def clamp(v: int) -> int:
        return min_chunk_size if v < min_chunk_size else v
    return (clamp(target_chunk_size // 8),
            clamp(target_chunk_size // 2),
            clamp(target_chunk_size * 2))
