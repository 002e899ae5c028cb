"""JobGraph (the Bikeshed counterpart): dependencies, channels, error
propagation, suspend/resume — mirroring the reference's scheduler
semantics (lib/bikeshed/longtail_bikeshed.c:240-270)."""

import threading
import time

import pytest

from longtail_jax.parallel.jobgraph import JobGraph, Suspend


def test_dependencies_order_and_results():
    order = []
    lock = threading.Lock()

    def mk(name, val):
        def fn():
            with lock:
                order.append(name)
            return val
        return fn

    g = JobGraph(workers=4)
    a = g.add(mk("a", 1))
    b = g.add(mk("b", 2))
    c = g.add(mk("c", 3), deps=[a, b])
    d = g.add(mk("d", 4), deps=[c])
    g.run()
    assert g.result(d) == 4 and g.result(c) == 3
    assert order.index("c") > order.index("a")
    assert order.index("c") > order.index("b")
    assert order.index("d") > order.index("c")


def test_channels_run_concurrently():
    """A slow channel-1 job must not starve channel 0 (the reference's
    block-reader channel exists exactly for this)."""
    hit = threading.Event()

    def slow():
        hit.wait(5)
        return "slow"

    def fast():
        hit.set()
        return "fast"

    g = JobGraph(workers={0: 1, 1: 1})
    s = g.add(slow, channel=1)
    f = g.add(fast, channel=0)
    t0 = time.time()
    g.run()
    assert time.time() - t0 < 5
    assert g.result(s) == "slow" and g.result(f) == "fast"


def test_first_error_cancels_group():
    ran = []

    def boom():
        raise RuntimeError("job failed")

    def late():
        time.sleep(0.2)
        ran.append(1)

    g = JobGraph(workers=1)
    g.add(boom)
    for _ in range(50):
        g.add(late)
    with pytest.raises(RuntimeError, match="job failed"):
        g.run()
    # the single worker stops at the first error; the 50 followers never run
    assert not ran


def test_suspend_resume():
    """EBUSY analog: a job parks on an async completion and finishes with
    the delivered payload; dependents run after the resume."""
    resumes = []

    def async_put(register):
        def complete():
            time.sleep(0.05)
            resumes.append(1)
            register("payload-42")
        threading.Thread(target=complete, daemon=True).start()

    def job(resumed=None):
        if resumed is None:
            return Suspend(lambda cb: async_put(cb))
        return resumed

    g = JobGraph(workers=2)
    j = g.add(job)
    after = g.add(lambda: "after", deps=[j])
    g.run()
    assert g.result(j) == "payload-42"
    assert g.result(after) == "after"
    assert resumes == [1]
