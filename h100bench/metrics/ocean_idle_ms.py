"""Milliseconds a step of the traced window in which the card idled while
the host was in the program's ocean step: the idle gaps put down to the
``ocean`` span or a span under it (``ocean.*``).

A gap between the window's merged busy intervals is put down to the
innermost span open at the launch call of the operation that ends it (of
the operations that start at the gap's end, the first launched): the
moment the host sent the work the card was waiting for.  The gap after
the last busy interval ends with no operation and goes to none."""


def idle_under(t, top: str):
    """Seconds of the window's idle gaps put down to ``top`` or a span
    under it; None where the trace has no such span or no operation on
    the card."""
    busy = t.busy()
    if not busy or not any(n == top or n.startswith(top + ".")
                           for n, _, _ in t.spans):
        return None
    launched = {}   # busy start -> the first launch among ops starting there
    for _, a, _, at in t.in_window():
        if at is not None and at < launched.get(a, float("inf")):
            launched[a] = at
    total, end = 0.0, t.window[0]
    for a, b in busy:
        if a > end and a in launched:
            name = t.host_at(launched[a])
            if name == top or name.startswith(top + "."):
                total += a - end
        end = b
    return total


def read(t):
    s = idle_under(t, "ocean")
    return None if s is None or not t.steps else 1e3 * s / t.steps
