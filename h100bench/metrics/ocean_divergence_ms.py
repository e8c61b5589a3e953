"""Device milliseconds a step of the operations launched inside the
program's ``ocean.divergence`` span (``ops.ocean.divergence``: the
area-weighted divergence, plain torch)."""


def read(t):
    s = t.time_under("ocean.divergence")
    return 1e3 * s / t.steps if s and t.steps else None
