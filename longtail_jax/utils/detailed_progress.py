"""Terminal detailed-progress monitor: a live block/asset activity line.

The reference's --detailed-progress opens a MiniFB pixel grid driven by the
Longtail_Monitor tap (cmd/main.c:581, :3055-3422).  Ours renders the same
event stream as an in-place terminal status line (block states: pending ->
loading -> composing -> done; plus asset write throughput) — no GUI
dependency, same observability.
"""

from __future__ import annotations

import sys
import threading
import time

from longtail_jax.utils.monitor import Monitor


class TerminalDetailedProgress(Monitor):
    def __init__(self, out=None, interval: float = 0.1):
        self.out = out or sys.stderr
        self.interval = interval
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._last = 0.0
        self.total_blocks = 0
        self.loading = 0
        self.loaded = 0
        self.saved = 0
        self.asset_bytes = 0
        self.save_bytes = 0
        self.assets = 0
        self.chunks = 0

    def _render(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last < self.interval:
            return
        self._last = now
        dt = max(now - self._t0, 1e-9)
        line = (f"\r[{dt:6.1f}s] blocks loaded {self.loaded}"
                f" (in-flight {self.loading}) saved {self.saved}"
                f" | written {self.asset_bytes / 1e6:.1f} MB"
                f" ({self.asset_bytes / dt / 1e6:.1f} MB/s)"
                f" | stored {self.save_bytes / 1e6:.1f} MB")
        self.out.write(line)
        self.out.flush()

    # -- monitor hooks ------------------------------------------------------

    def version_begin(self, asset_count: int, chunk_count: int) -> None:
        with self._lock:
            self.assets = asset_count
            self.chunks = chunk_count
            self._t0 = time.monotonic()

    def version_end(self) -> None:
        with self._lock:
            self._render(force=True)
            self.out.write("\n")
            self.out.flush()

    def block_load(self, block_index, block_hash, byte_count) -> None:
        with self._lock:
            self.loading += 1
            self._render()

    def block_load_complete(self, block_index, block_hash) -> None:
        with self._lock:
            self.loading -= 1
            self.loaded += 1
            self._render()

    def block_save(self, block_index, block_hash, byte_count) -> None:
        with self._lock:
            self.save_bytes += byte_count
            self._render()

    def block_save_complete(self, block_index, block_hash) -> None:
        with self._lock:
            self.saved += 1
            self._render()

    def asset_write(self, asset_index, offset, byte_count) -> None:
        with self._lock:
            self.asset_bytes += byte_count
            self._render()
