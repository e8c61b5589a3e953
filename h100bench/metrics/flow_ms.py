"""Device milliseconds a step of the operations launched inside the
``flow_filter_device`` span (pre-blur, directions and masks, the flow
fixpoint, the flow map)."""


def read(t):
    s = t.time_under("flow_filter_device")
    return 1e3 * s / t.steps if s and t.steps else None
