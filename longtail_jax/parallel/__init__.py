"""Device-parallel execution layer (the device replacement for the reference's
Bikeshed thread-pool JobAPI, lib/bikeshed/longtail_bikeshed.c).

The reference parallelizes by fanning file-parts and blocks out over worker
threads; we parallelize by batching file-parts into fixed-shape lanes and
sharding them over a ``jax.sharding.Mesh``:

- ``device_chunker``: single-device jittable chunk+hash step (two-phase CDC
  scan + batched BLAKE3), the data-plane hot loop.
- ``pipeline``: the streamed production data plane — async two-stage
  dispatch (resolve, then bucketed gather+hash) with prefetch-threaded file
  I/O overlap.
- ``distributed``: multi-chip sharding — ``shard_map`` over a device mesh
  with the global dedup collective (allgather + sort-unique of chunk hashes).
"""

from longtail_jax.parallel.device_chunker import (  # noqa: F401
    ChunkerConfig,
    index_parts,
    make_index_parts_fn,
)
from longtail_jax.parallel.pipeline import DevicePartIndexer  # noqa: F401
