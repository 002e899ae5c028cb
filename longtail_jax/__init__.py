"""longtail-jax: an incremental asset-delivery framework with a JAX device plane.

A from-scratch reimplementation of the capabilities of DanEngelbrecht/longtail
(content-defined chunking, content-addressed dedup storage, incremental version
sync) designed for an accelerator from the start:

- the data plane (CDC boundary scan, BLAKE3 chunk hashing, block compression)
  runs as JAX programs and Pallas kernels over device-resident byte streams,
  sharded with ``jax.sharding`` across a device mesh;
- the control plane (zero-parse indices, composable block stores, CLI) is
  host-side Python with serialized formats bit-compatible with the reference
  C library (``src/longtail.c`` of DanEngelbrecht/longtail).

Nothing in this package is a port: the reference defines *what* (formats,
semantics, API surface); the implementation here is built for XLA semantics
(static shapes, batched kernels, collectives) rather than thread pools.
"""

__version__ = "0.1.0"

from longtail_jax.formats.version_index import VersionIndex
from longtail_jax.formats.store_index import BlockIndex, StoreIndex, StoredBlock

__all__ = [
    "VersionIndex",
    "StoreIndex",
    "BlockIndex",
    "StoredBlock",
]
