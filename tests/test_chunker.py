"""CDC conformance: golden vectors from the reference ChunkerLargeFile test
(test/test.cpp:3363-3462, fixture test/testdata/chunker.input) plus
two-phase vs sequential-oracle cross-checks."""

import os

import numpy as np
import pytest

from longtail_jax.ops import cdc

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")

GOLDEN = [  # (offset, length) — test/test.cpp:3421-3443
    (0, 81590), (81590, 46796), (128386, 36543), (164929, 83172),
    (248101, 76749), (324850, 79550), (404400, 41484), (445884, 20326),
    (466210, 31652), (497862, 19995), (517857, 103873), (621730, 38087),
    (659817, 38377), (698194, 23449), (721643, 47321), (768964, 86692),
    (855656, 28268), (883924, 65465), (949389, 33255), (982644, 65932),
]


def test_golden_vectors():
    data = np.fromfile(os.path.join(TESTDATA, "chunker.input"), dtype=np.uint8)
    ends = cdc.chunk_part(data, 16 * 1024, 64 * 1024, 256 * 1024)
    offs = np.concatenate([[0], ends[:-1]])
    got = list(zip(offs.tolist(), (ends - offs).tolist()))
    assert got == GOLDEN


@pytest.mark.parametrize("params", [(48, 128, 512), (64, 256, 1024),
                                    (48, 48, 48 * 4), (100, 200, 300)])
def test_two_phase_matches_sequential(params):
    rng = np.random.default_rng(3)
    mn, avg, mx = params
    for size in [0, 1, 47, 48, 49, mn, mn + 1, mx, mx + 1, 3000, 10000]:
        data = rng.integers(0, 256, size, dtype=np.uint8)
        fast = cdc.chunk_part(data, mn, avg, mx).tolist()
        slow = cdc.chunk_part_sequential(bytes(data), mn, avg, mx)
        assert fast == slow, (size, params)


def test_low_entropy_hits_max():
    # constant data has no candidates -> all chunks are max-size
    data = np.zeros(10000, dtype=np.uint8)
    ends = cdc.chunk_part(data, 48, 128, 512)
    sizes = np.diff(np.concatenate([[0], ends]))
    assert (sizes[:-1] == 512).all()
    assert ends[-1] == 10000


def test_min_size_consume_all():
    data = np.arange(40, dtype=np.uint8)
    assert cdc.chunk_part(data, 48, 128, 512).tolist() == [40]


def test_discriminator():
    # HPCDCDiscriminatorFromAvg for the golden params (avg 64 KiB) must match
    # the value implied by the golden vectors (indirectly covered above); also
    # spot-check determinism of the formula.
    assert cdc.discriminator_from_avg(65536.0) == \
        int(65536.0 / (-1.42888852e-7 * 65536.0 + 1.33237515))
