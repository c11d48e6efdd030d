"""Native RT runtime: seqlock consistency under contention + loop timing."""
import shutil
import threading
import time

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")


def test_policy_slot_snapshot_consistency():
    from bipedal_nmpc.runtime.native_rt import PolicySlot

    n = 256
    slot = PolicySlot(n)
    seq0, _ = slot.read()
    assert seq0 == 0  # nothing published yet

    stop = threading.Event()
    versions = 0

    def writer():
        nonlocal versions
        v = 0
        while not stop.is_set():
            v += 1
            slot.write(np.full(n, float(v)))
            versions = v

    th = threading.Thread(target=writer)
    th.start()
    try:
        deadline = time.time() + 1.0
        reads = 0
        while time.time() < deadline:
            seq, snap = slot.read()
            if seq:
                # every element must come from ONE write (torn reads forbidden)
                assert np.all(snap == snap[0]), "torn read detected"
                reads += 1
        assert reads > 100
        assert versions > 100
    finally:
        stop.set()
        th.join()
        slot.close()


def test_rt_loop_rate_and_stats():
    from bipedal_nmpc.runtime.native_rt import RtLoop

    ticks = []

    def cb():
        ticks.append(time.perf_counter())
        return len(ticks) >= 500  # stop after 500 cycles

    loop = RtLoop(1000.0, cb)  # 1 kHz
    t0 = time.time()
    while len(ticks) < 500 and time.time() - t0 < 5.0:
        time.sleep(0.01)
    loop.stop()
    stats = loop.stats()
    loop.close()
    assert stats["cycles"] >= 499  # the stopping cycle itself is not counted
    elapsed = ticks[-1] - ticks[0]
    # 499 periods at 1 kHz ~ 0.5 s (generous CI bounds)
    assert 0.3 < elapsed < 1.5, elapsed
