"""Device milliseconds a step of the operations launched inside the
program's ``erosion`` span (``model.coupled_step``'s erosion pass: eight
neighbour taps and the stream-power update, plain torch)."""


def read(t):
    s = t.time_under("erosion")
    return 1e3 * s / t.steps if s and t.steps else None
