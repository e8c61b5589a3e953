"""The ocean's two Jacobi solves (pressure, viscosity; K2, K3) against
their bound: the stages' least time (``work.py``: the solve's inputs read
and outputs written once, 10 and 2 x 9 operations a sweep) over the
device time of the kernels named ``jacobi``.  Nothing to read where no
such kernel ran."""

from h100bench.work import stages_bound_s

STAGES = ("pressure", "viscosity")


def read(t):
    busy = t.device_time(lambda n: "jacobi" in n)
    if not busy or t.peaks is None:
        return None
    return 100.0 * t.steps * stages_bound_s(t.stages, t.peaks, STAGES) / busy
