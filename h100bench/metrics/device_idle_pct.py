"""The share of the traced window in which no operation ran on the card:
100 * (1 - the union of its kernels, copies and fills / the window)."""


def read(t):
    if t.window_s <= 0 or not t.in_window():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
