"""Monitor tap: block/asset lifecycle events fire from the hot loops
(Longtail_Monitor analog, src/longtail.h:840-858)."""

import numpy as np

from longtail_jax import api
from longtail_jax.stores.compressblockstore import CompressBlockStore
from longtail_jax.stores.fsblockstore import FSBlockStore
from longtail_jax.stores.storage import MemStorage
from longtail_jax.utils.monitor import Monitor, set_monitor


class Recorder(Monitor):
    def __init__(self):
        self.events = []

    def __getattribute__(self, name):
        if name in ("events",) or name.startswith("_"):
            return object.__getattribute__(self, name)
        events = object.__getattribute__(self, "events")

        def record(*a):
            events.append((name, a))
        return record


def test_monitor_sees_full_lifecycle():
    storage = MemStorage()
    storage.create_dir("src")
    rng = np.random.default_rng(2)
    for i in range(3):
        storage.write(f"src/f{i}", rng.integers(0, 256, 9000,
                                                np.uint8).tobytes())
    store = CompressBlockStore(FSBlockStore(storage, "store"))
    rec = Recorder()
    set_monitor(rec)
    try:
        vi, _ = api.upsync(storage, "src", store, target_chunk_size=2048,
                           workers=1)
        api.downsync(store, storage, "out", vi, workers=1)
    finally:
        set_monitor(None)
    names = [n for n, _ in rec.events]
    for expected in ("block_prepare", "block_save", "block_save_complete",
                     "version_begin", "block_load", "block_load_complete",
                     "block_compose", "asset_write", "version_end"):
        assert expected in names, f"missing {expected}: {set(names)}"
    written = sum(a[2] for n, a in rec.events if n == "asset_write")
    assert written == sum(len(storage.read(f"src/f{i}")) for i in range(3))


def test_detailed_progress_renders():
    import io

    from longtail_jax.utils.detailed_progress import TerminalDetailedProgress

    buf = io.StringIO()
    mon = TerminalDetailedProgress(out=buf, interval=0.0)
    mon.version_begin(3, 10)
    mon.block_load(0, 123, 0)
    mon.block_load_complete(0, 123)
    mon.asset_write(1, 0, 5000)
    mon.version_end()
    out = buf.getvalue()
    assert "blocks loaded 1" in out
    assert "MB" in out
