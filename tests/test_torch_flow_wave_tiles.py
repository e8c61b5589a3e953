"""The schedule of the redesigned K11c (csrc/flow_deadends.cu wave_tiles_kernel), in numpy.

The CUDA kernel cannot run here, so its schedule is transliterated in
float32 numpy in the kernel's order and held bit for bit to the twin,
``flow_solve_wave_plain`` (A and vis):

- the wave runs on tiles of ``rows`` x ``cols``; round t visits the tiles
  on its list in any order (round 0: every tile), reading delta from one
  of two buffers and writing the other;
- a visit loads a window of the tile and a k-cell halo (x wraps, rows
  beyond the grid 0) of delta and of the incoming bits; a tile's region
  of delta reads 0 unless that tile's last nonzero output is the last
  round's (the buffer still holds what it wrote two rounds before);
- k Jacobi sweeps on the shrinking trapezoid, ping-pong: after sweep s
  every cell s inside the window holds d_s, the sum over its incoming
  bits of d_{s-1}, in bit order from 0.0f; each of the tile's cells adds
  d_s to its A in sweep order;
- a tile whose d_k is not all zero writes it and pushes the 3x3 tiles
  around it (x wraps, y clips) onto the next list; the wave ends when the
  list is empty.

vis runs beside it as K11b's vis entries (K8's visits woken by pushed
edge bits): tests/test_torch_flow_fused_tiles.py's schedule in mode
"vis".  Three mutations must disagree with the twin: a halo narrower than
k, a window that reads a tile's stale half of the ping-pong, and A
summed in another order.
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import flow_deadends as kd
from test_torch_flow_fused_tiles import fused_rounds
from test_torch_flow_tiles import SCAN, _case, _port_case

torch.set_num_threads(2)


def wave_rounds(packed, area, tile, k, order_seed, halo=None, stale=False,
                summed=False, unset=np.nan, max_rounds=None):
    """The wave's rounds in numpy: (A, stats).  ``halo`` (default k): the
    window's halo; ``stale``: read every region of the input buffer;
    ``summed``: add a visit's d_1 + ... + d_k to A at once; ``unset``:
    what the second buffer holds before it is written (the kernel's holds
    anything); reaching ``max_rounds`` (default H * W) raises."""
    p = packed.numpy()
    area = area.numpy().astype(np.float32)
    H, W = p.shape
    ty, tx = tile
    nby, nbx = -(-H // ty), -(-W // tx)
    ntw = nby * nbx
    h = k if halo is None else halo
    inc = p & 0xFF
    delta = [area.copy(), np.full((H, W), unset, np.float32)]
    live = np.full((2, ntw), -2)
    live[1] = -1  # round 0 reads the area: every tile's "round -1" output
    A = area.copy()
    rng = np.random.default_rng(order_seed)
    todo, t, visits, depth = list(range(ntw)), 0, 0, 0
    limit = H * W if max_rounds is None else max_rounds
    while todo:
        if t >= limit:
            raise RuntimeError(f"no fixpoint after {t} rounds")
        cur, out = delta[t & 1], delta[(t + 1) & 1]
        queued, nxt = set(), []
        for e in rng.permutation(todo):
            ti, tj = divmod(int(e), nbx)
            r0, c0 = ti * ty, tj * tx
            rows, cols = min(ty, H - r0), min(tx, W - c0)
            r = np.arange(r0 - h, r0 + ty + h)
            c = np.arange(c0 - h, c0 + tx + h) % W
            inr = (r >= 0) & (r < H)
            rc = np.clip(r, 0, H - 1)
            owner = (rc // ty)[:, None] * nbx + (c // tx)[None, :]
            take = inr[:, None] & ((live[(t - 1) & 1][owner] == t - 1)
                                   | stale)
            buf = [np.where(take, cur[np.ix_(rc, c)], 0).astype(np.float32),
                   np.zeros((ty + 2 * h, tx + 2 * h), np.float32)]
            bits = np.where(inr[:, None], inc[np.ix_(rc, c)], 0)
            wh, ww = ty + 2 * h, tx + 2 * h
            acc = A[r0:r0 + rows, c0:c0 + cols].copy()
            total = np.zeros_like(acc)
            for s in range(1, k + 1):
                src, dst = buf[(s - 1) & 1], buf[s & 1]
                i0, i1, j0, j1 = s, wh - s, s, ww - s
                d = np.zeros((i1 - i0, j1 - j0), np.float32)
                for b, (dx, dy) in enumerate(SCAN):
                    on = (bits[i0:i1, j0:j1] >> b) & 1 == 1
                    d = np.where(on, d + src[i0 + dy:i1 + dy, j0 + dx:j1 + dx],
                                 d).astype(np.float32)
                dst[i0:i1, j0:j1] = d
                ds = dst[h:h + rows, h:h + cols]
                if summed:
                    total = (total + ds).astype(np.float32)
                else:
                    acc = np.where(ds != 0, acc + ds, acc).astype(np.float32)
                if (ds != 0).any():
                    depth = max(depth, t * k + s)
            if summed:
                acc = (acc + total).astype(np.float32)
            A[r0:r0 + rows, c0:c0 + cols] = acc
            visits += 1
            dk = buf[k & 1][h:h + rows, h:h + cols]
            if not (dk != 0).any():
                continue
            out[r0:r0 + rows, c0:c0 + cols] = dk
            live[t & 1][e] = t
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    ii = ti + di
                    if 0 <= ii < nby:
                        nb = ii * nbx + (tj + dj) % nbx
                        if nb not in queued:
                            queued.add(nb)
                            nxt.append(nb)
        todo, t = nxt, t + 1
    return A, {"wave_rounds": t, "wave_visits": visits, "tiles": ntw,
               "wave_depth": depth, "sweeps": t * k}


def _cases(name):
    """(grid, packed, area, (tile rows, columns), k) of each case."""
    if name == "port":
        grid, packed, area = _port_case(128, 64)
        return grid, packed, area, (16, 32), 8
    if name == "ragged":
        # neither side a whole number of tiles; the last tile column 4
        # wide, no narrower than k
        grid, packed, area = _port_case(100, 44)
        return grid, packed, area, (8, 16), 4
    grid, packed, area, _, _ = _case("serpentine")  # over the dateline
    return grid, packed, area, (8, 16), 4


@pytest.mark.parametrize("name", ["port", "ragged", "serpentine"])
def test_wave_rounds_equal_the_twin_bit_for_bit(name):
    """A bit for bit with the twin's float32 sum in two visit orders, vis
    by K8's visits equal to the twin's; the last sweep that left a delta
    comes before the twin's certifying sweep."""
    grid, packed, area, tile, k = _cases(name)
    tA, tvis, st = kd.flow_solve_wave_plain(packed, area, grid)
    for order_seed in (0, 1):
        A, sw = wave_rounds(packed, area, tile, k, order_seed)
        np.testing.assert_array_equal(A.view(np.int32),
                                      tA.numpy().view(np.int32))
        assert sw["wave_depth"] < st["sweeps"]
        assert sw["sweeps"] >= sw["wave_depth"]
        if name == "serpentine":  # the wave's dead tiles were skipped
            assert sw["wave_visits"] < sw["wave_rounds"] * sw["tiles"]
    _, vis, _ = fused_rounds(packed, area, (*tile, 8), "vis", "in place", 0)
    np.testing.assert_array_equal(vis, tvis.numpy())
    assert st["delta_cells"] > 0


@pytest.mark.parametrize("name", ["port", "serpentine"])
def test_a_halo_narrower_than_k_disagrees(name):
    """k sweeps need a k-cell halo: with k - 1 the tile's edge cells miss
    their last sweep."""
    grid, packed, area, tile, k = _cases(name)
    tA, _, _ = kd.flow_solve_wave_plain(packed, area, grid)
    A, _ = wave_rounds(packed, area, tile, k, 0, halo=k - 1)
    assert not np.array_equal(A, tA.numpy())


def test_reading_the_stale_half_disagrees():
    """A tile that left no delta writes nothing, so its region of the
    output buffer keeps its delta of two rounds before: a window that
    reads it regardless puts that mass back into the wave, which then
    never dies out: the quiet tile writes nothing again, and its
    neighbour reads the same mass two rounds later (here the unwritten
    buffer holds zeros, so only the stale half can be at fault)."""
    grid, packed, area, tile, k = _cases("serpentine")
    tA, _, st = kd.flow_solve_wave_plain(packed, area, grid)
    limit = 4 * (st["sweeps"] // k + 2)
    A, sw = wave_rounds(packed, area, tile, k, 0, unset=0.0,
                        max_rounds=limit)
    np.testing.assert_array_equal(A, tA.numpy())
    with pytest.raises(RuntimeError, match="no fixpoint after"):
        wave_rounds(packed, area, tile, k, 0, stale=True, unset=0.0,
                    max_rounds=limit)


def test_a_summed_in_another_order_disagrees():
    """A adds d_1, d_2, ... one after another as the twin does; adding
    their sum rounds differently."""
    grid, packed, area, tile, k = _cases("port")
    tA, _, _ = kd.flow_solve_wave_plain(packed, area, grid)
    A, _ = wave_rounds(packed, area, tile, k, 0, summed=True)
    assert not np.array_equal(A, tA.numpy())


def test_the_wave_tiles_are_checked():
    """The kernel's tiles, K8's: k a multiple of 4 in [4, 16], W a multiple
    of 4, and with more than three tile columns the last one no narrower
    than k.  ``flow_solve_wave`` takes the earlier design on the card
    where the tiles do not take the grid."""
    kd.check_wave_tiles(Grid(2000, 1000), 16)   # the last column 80
    kd.check_wave_tiles(Grid(136, 64), 16)      # 8 wide, two columns
    assert kd.wave_tiles_take(Grid(2048, 1024))
    for grid, k in ((Grid(256, 64), 6), (Grid(256, 64), 20),
                    (Grid(256, 64), 0), (Grid(1022, 64), 8),
                    (Grid(520, 64), 16), (Grid(516, 64), 8)):
        with pytest.raises(ValueError):
            kd.check_wave_tiles(grid, k)
    assert not kd.wave_tiles_take(Grid(1022, 64))
    assert not kd.wave_tiles_take(Grid(516, 64))   # 4 wide, five columns
