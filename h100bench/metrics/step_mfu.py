"""The whole step's share of the chip's peak: the least time of every
stage of a step (``work.py``, counted from the step's shapes and sweep
counts, not from the program's kernels) over the wall time a step of the
traced run's unprofiled steps (the profiler slows the steps it records)."""

from h100bench.work import stages_bound_s


def read(t):
    if t.peaks is None or not t.step_s or not t.in_window():
        return None
    return 100.0 * stages_bound_s(t.stages, t.peaks) / t.step_s
