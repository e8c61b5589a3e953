"""Device milliseconds a step of the operations launched inside the
program's ``ocean.project`` span (``ops.ocean.project``: the pressure
gradient and the coastal free-slip redirect, plain torch)."""


def read(t):
    s = t.time_under("ocean.project")
    return 1e3 * s / t.steps if s and t.steps else None
