"""ctypes binding of the native lake solver: the same arguments and result
as ``ops.flow.solve_lakes_numpy``.  ``CALLS`` counts its calls."""

from __future__ import annotations

import numpy as np

CALLS = 0


def solve_lakes_native(mask, mouth, height, parent, grid):
    """The lake connections and water heights (``ops.flow.LakeSolution``)
    from the flattened incoming mask, mouths and unblurred heights;
    ``parent`` is unused, as in the numpy solver."""
    global CALLS
    from ..ops.flow import LakeSolution, _wraps_x
    from .build import library

    fn = library().solve_lakes
    H, W = grid.shape
    mask32 = np.ascontiguousarray(mask, np.int32).reshape(-1)
    mouth8 = np.ascontiguousarray(mouth, bool).reshape(-1).view(np.uint8)
    h32 = np.ascontiguousarray(height, np.float32).reshape(-1)
    if not mask32.size == mouth8.size == h32.size == H * W:
        raise ValueError(f"expected {H * W} cells a field, got "
                         f"{mask32.size}, {mouth8.size}, {h32.size}")

    # a connection leaves a sink at most once
    nsinks = int(((mask32 & 16) != 0).sum()) + 1
    conn_from = np.zeros(nsinks, np.int32)
    conn_to = np.zeros(nsinks, np.int32)
    conn_h = np.zeros(nsinks, np.float32)
    n_conn = np.zeros(1, np.int32)
    lake_wh = np.zeros(H * W, np.float32)

    ret = fn(mask32.ctypes.data, mouth8.ctypes.data, h32.ctypes.data, H, W,
             int(_wraps_x(grid)), conn_from.ctypes.data, conn_to.ctypes.data,
             conn_h.ctypes.data, n_conn.ctypes.data, lake_wh.ctypes.data)
    if ret != 0:
        raise RuntimeError(f"solve_lakes returned {ret}")
    CALLS += 1
    n = int(n_conn[0])
    return LakeSolution(conn_from[:n].astype(np.int64),
                        conn_to[:n].astype(np.int64), conn_h[:n].copy(),
                        lake_wh)
