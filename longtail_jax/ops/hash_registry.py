"""Hash providers keyed by type identifier (the reference's HashAPI +
hash-registry seam, src/longtail.h:209-246,
lib/hashregistry/longtail_full_hash_registry.c:10-40).

Every provider produces the longtail 64-bit hash: the first 8 bytes of the
underlying digest interpreted little-endian.  ``hash_buffer`` is the scalar
host path (paths, hash-of-hashes); ``hash_chunks`` is the bulk batched path
used by the chunking pipeline (lanes of padded chunk bytes).
"""

from __future__ import annotations

import hashlib

import numpy as np

from longtail_jax.formats.constants import (
    HASH_TYPE_BLAKE2,
    HASH_TYPE_BLAKE3,
    HASH_TYPE_MEOW,
)
from longtail_jax.ops import blake3 as _blake3


class Blake3Hasher:
    """BLAKE3 (default): lib/blake3/longtail_blake3.c."""

    identifier = HASH_TYPE_BLAKE3

    def hash_buffer(self, data: bytes) -> int:
        return _blake3.hash64(data)

    def hash_chunks(self, data_u8: np.ndarray, lengths: np.ndarray,
                    xp=np) -> np.ndarray:
        return _blake3.hash_chunks(data_u8, lengths, xp=xp)

    def hash_ranges(self, base_u8: np.ndarray, offsets: np.ndarray,
                    sizes: np.ndarray) -> np.ndarray | None:
        """Native C batch path (None -> caller falls back to hash_chunks)."""
        return _blake3.hash64_ranges(base_u8, offsets, sizes)


class Blake2Hasher:
    """BLAKE2s with an 8-byte digest (lib/blake2/longtail_blake2.c:43
    ``blake2s_init(state, sizeof(uint64_t))``).  Bulk path is the
    lane-batched implementation (ops/blake2.py, numpy or device)."""

    identifier = HASH_TYPE_BLAKE2

    def hash_buffer(self, data: bytes) -> int:
        d = hashlib.blake2s(data, digest_size=8).digest()
        return int.from_bytes(d, "little")

    def hash_chunks(self, data_u8: np.ndarray, lengths: np.ndarray,
                    xp=np) -> np.ndarray:
        from longtail_jax.ops import blake2
        return blake2.hash_chunks(data_u8, lengths, xp=xp)


class MeowHasher:
    """MeowHash 0.5 (lib/meowhash/longtail_meowhash.c:7) with the AES round
    in software (ops/meow.py) — works on any host, unlike the reference's
    x64-only AES-NI build (CHANGELOG 0.4.0 arm64 note).  Compat/parity
    hash; not a data-plane path."""

    identifier = HASH_TYPE_MEOW

    def hash_buffer(self, data: bytes) -> int:
        from longtail_jax.ops import meow
        return meow.hash64(data)

    def hash_chunks(self, data_u8, lengths, xp=np) -> np.ndarray:
        from longtail_jax.ops import meow
        # numpy-batched lockstep path (ops/meow.hash_chunks_batched):
        # all lanes' AES rounds run together instead of one Python-int
        # hash per chunk
        return meow.hash_chunks_batched(np.asarray(data_u8),
                                        np.asarray(lengths))


_REGISTRY = {
    HASH_TYPE_BLAKE3: Blake3Hasher(),
    HASH_TYPE_BLAKE2: Blake2Hasher(),
    HASH_TYPE_MEOW: MeowHasher(),
}


def get_hasher(identifier: int):
    try:
        return _REGISTRY[identifier]
    except KeyError:
        raise KeyError(f"no hash provider registered for {identifier:#x}")


def register_hasher(hasher) -> None:
    _REGISTRY[hasher.identifier] = hasher
