"""Milliseconds a step of the traced window in which the card idled while
the host was in the program's flow filter: the idle gaps put down to the
``flow`` span or a span under it (``flow.*``: the stages, the solves'
host reads), by ``ocean_idle_ms``'s rule."""

from h100bench.metrics.ocean_idle_ms import idle_under


def read(t):
    s = idle_under(t, "flow")
    return None if s is None or not t.steps else 1e3 * s / t.steps
