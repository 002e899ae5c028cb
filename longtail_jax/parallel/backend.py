"""The one seam between a JAX backend and the device stages it runs.

The device data plane (parallel/pipeline.py) runs three stages on the
accelerator: the candidate scan, the cut walk (stage 1) and chunk
pack + hash (stage 3).  This module names, for each backend, which
implementation of each stage runs:

- ``gpu``: what the card runs.  Each stage is either plain XLA or a
  Pallas kernel compiled through Triton, whichever measured faster end to
  end on the card (PERF.md, Findings).
- ``cpu``: the plain XLA references.  This entry exists for tests and
  rehearsals on machines without a card; nothing is measured on it.  Its
  lane cap bounds XLA's CPU compile time, which grows with the lane count.

Any other backend is an error that names it.  Pallas interpret mode is
never derived from the backend: tests and ``chip_smoke.py --rehearse``
ask for the card's kernels in interpret mode explicitly (``rehearsal``).
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass(frozen=True)
class StageImpls:
    """Implementation choice per device stage (hashable: jit cache key)."""
    walk: str                     # "triton" kernel | "xla" while_loop
    hash: str                     # stage-3 BLAKE3: "triton" kernel | "xla"
    max_lanes: int | None = None  # cap on the default lane count
    interpret: bool = False       # run Pallas kernels in interpret mode


GPU = StageImpls(walk="triton", hash="triton")
CPU = StageImpls(walk="xla", hash="xla", max_lanes=8)

_BY_BACKEND = {"gpu": GPU, "cpu": CPU}
_forced: StageImpls | None = None


def for_backend(name: str) -> StageImpls:
    """The stage implementations for JAX backend ``name``."""
    try:
        return _BY_BACKEND[name]
    except KeyError:
        raise RuntimeError(
            f"no device stages for JAX backend {name!r}: the data plane "
            f"runs on {sorted(_BY_BACKEND)} only") from None


def current() -> StageImpls:
    """The implementations in force: an explicit ``forced`` choice, else
    the one for JAX's default backend."""
    if _forced is not None:
        return _forced
    import jax

    return for_backend(jax.default_backend())


def rehearsal() -> StageImpls:
    """The card's implementations with every Pallas kernel in interpret
    mode, so the GPU path's control flow runs on a CPU."""
    return dataclasses.replace(GPU, interpret=True)


@contextlib.contextmanager
def forced(impls: StageImpls):
    """Run the enclosed code with ``impls`` in force."""
    global _forced
    prev, _forced = _forced, impls
    try:
        yield impls
    finally:
        _forced = prev
