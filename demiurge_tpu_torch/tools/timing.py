"""Device time of a short kernel call, without its wrapper's host time.

``device_ms(fn, reps)`` queues ``reps`` calls of ``fn`` behind a sleep
kernel of about 0.1 s, so that the device runs them back to back while the
host is still ahead; CUDA events around the queued calls give the mean
device milliseconds a call.  It raises if the host took longer to queue
the calls than the sleep lasts, when the events would time the host.
"""

from __future__ import annotations

import time

import torch

SLEEP_CYCLES = 200_000_000   # about 0.1 s at the H100's clock
HOST_BUDGET_S = 0.05         # the host must queue every call within this


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, after a
    warm-up call, the calls queued behind a sleep kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    if queued_s > HOST_BUDGET_S:
        raise RuntimeError(f"the host took {queued_s:.3f} s to queue {reps} "
                           f"calls, past the sleep kernel: the events would "
                           f"time the host")
    return start.elapsed_time(end) / reps
