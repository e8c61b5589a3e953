"""Device operations (kernels, copies and fills) a step launches in the
traced window."""


def read(t):
    n = len(t.in_window())
    return n / t.steps if n and t.steps else None
