"""Device milliseconds a step of the operations launched inside the
program's ``climate`` span (``ops.temperature.temperature_step``: the
insolation table, the heat capacity and K1)."""


def read(t):
    s = t.time_under("climate")
    return 1e3 * s / t.steps if s and t.steps else None
