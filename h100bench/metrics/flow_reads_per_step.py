"""Host reads a step of the flow solves' flags: the program's
``flow.read`` spans (one around each batch's or round's read in
``kernels.flow``) that lie in the traced window, over its steps."""


def read(t):
    if t.window is None or not t.steps:
        return None
    w0, w1 = t.window
    n = sum(1 for name, a, b in t.spans
            if name == "flow.read" and w0 <= a and b <= w1)
    return n / t.steps if n else None
