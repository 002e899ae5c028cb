"""Seeded synthetic build corpora with the structure of real game content.

Each segment is a fresh structured batch (``structured_rows``: text-like
short-period data, zeros, tiled repeats and incompressible noise, which
compresses ~2.5-4x like the reference's game-content corpora,
CHANGELOG.md:51-58), and every 8th segment duplicates an earlier one so
chunk-level dedup sees real hits.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def structured_rows(base_rows, xp):
    """Build a realistic 8-region corpus batch from random base rows:
    2/8 short-period data (4.25 KiB tiles: text-analog), 1/8 zeros,
    2/8 24 KiB tile repeats, 3/8 incompressible noise.  Works for both
    numpy (host) and jnp (device), so a device batch and its host mirror
    are byte-identical.  base_rows carries the 3/8 of unique randomness;
    the output has 8/3 x base rows."""
    r8 = base_rows.shape[0] // 3
    text = xp.tile(base_rows[:34], (2 * r8 // 34 + 1, 1))[: 2 * r8]
    zeros = xp.zeros((r8, 128), dtype=base_rows.dtype)
    tiled = xp.tile(base_rows[34:226], (2 * r8 // 192 + 1, 1))[: 2 * r8]
    noise = base_rows
    return xp.concatenate([text, zeros, tiled, noise], axis=0)


def segments(n_seg: int, seed: int, seg_bytes: int = 64 << 20):
    """Yield ``n_seg`` (seg_bytes,) u8 segments: structured batches, with
    segment j a copy of segment j - 5 whenever j >= 5 and j % 8 == 7."""
    rng = np.random.default_rng(seed)
    R = seg_bytes // 128
    recent: deque = deque(maxlen=5)
    for j in range(n_seg):
        if j >= 5 and j % 8 == 7:
            seg = recent[0]
        else:
            base = rng.integers(0, 256, (3 * (R // 8), 128), dtype=np.uint8)
            seg = structured_rows(base, np).reshape(-1)
        recent.append(seg)
        yield seg
