"""Device milliseconds a step of the operations launched inside the
``ocean_step`` span (advect, viscosity, divergence, pressure, projection)."""


def read(t):
    s = t.time_under("ocean_step")
    return 1e3 * s / t.steps if s and t.steps else None
