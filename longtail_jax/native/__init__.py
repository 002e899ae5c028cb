"""Native host-side helpers (C, built on demand with the system compiler).

The device data plane is JAX; these cover the host runtime paths the
reference implements in C (block codecs, chunk scan, hashing).  Each
library is built from the C sources in this directory into
``build/lib<name>-<key>.so``, where the key hashes the sources, the
compile command and the host's CPU (the build uses ``-march=native``),
so a library built on one host is never loaded on another, and a source
edit always rebuilds.  A pure-Python fallback exists for every native
entry point, so the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_DIR = os.path.dirname(__file__)
_BUILD = os.path.join(_DIR, "build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}

# every native library: name -> its C sources in this directory
LIBRARIES = {
    "blake3_hash": ["blake3_hash.c"],
    "cdc_scan": ["cdc_scan.c"],
    "lz4_block": ["lz4_block.c"],
    "lz4_assemble": ["lz4_assemble.c"],
    "lz4_anchors": ["lz4_anchors.c"],
    "zstd_seq": ["zstd_seq.c"],
}


def _host_id() -> bytes:
    """What ``-march=native`` compiles for: the machine and its CPU
    model and feature flags."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features"):
                    parts.append(line.strip())
                if len(parts) >= 3:
                    break
    except OSError:
        parts.append(platform.processor())
    return "\n".join(parts).encode()


def _build(name: str, sources: list[str]) -> str | None:
    src_paths = [os.path.join(_DIR, s) for s in sources]
    cc = os.environ.get("CC", "cc")
    flags = ["-O3", "-march=native", "-fPIC", "-shared"]
    try:
        key = hashlib.sha256()
        key.update(" ".join([cc] + flags).encode())
        key.update(_host_id())
        for p in src_paths:
            with open(p, "rb") as f:
                key.update(f.read())
        so_path = os.path.join(_BUILD, f"lib{name}-{key.hexdigest()[:16]}.so")
        if os.path.exists(so_path):
            return so_path
        os.makedirs(_BUILD, exist_ok=True)
        # build under a private name, then rename: concurrent builders
        # (test workers) never load a half-written library
        tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        subprocess.run([cc] + flags + ["-o", tmp] + src_paths,
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.CalledProcessError):
        return None


def _disabled() -> bool:
    """LONGTAIL_NO_NATIVE, or the same switch under the package's former
    name (LONGTAIL_<name>_NO_NATIVE), is set."""
    return any(v and k.startswith("LONGTAIL_") and k.endswith("NO_NATIVE")
               for k, v in os.environ.items())


def load(name: str) -> ctypes.CDLL | None:
    """The native library ``name`` (built on first use), or None when
    LONGTAIL_NO_NATIVE is set or it cannot be built or loaded."""
    if _disabled():
        # force the pure-Python fallbacks (CI exercises them explicitly;
        # a built library would otherwise mask a missing compiler)
        return None
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = _build(name, LIBRARIES[name])
        lib = None
        if so is not None:
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                lib = None
        _LIBS[name] = lib
        return lib
