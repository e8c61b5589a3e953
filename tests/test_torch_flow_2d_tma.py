"""The schedule of the redesigned K11a (csrc/flow_deadends.cu tma_tiles_kernel), in numpy.

The CUDA kernel cannot run here, so its schedule is transliterated and
held to the twin's fixpoint (``flow_solve_2d_plain`` on the same tiles:
A bit for bit, vis exactly; it is K7's and K8's).  An entry is a (field,
tile) pair, A's and vis's:

- round 0's list holds every entry; a block takes any entry of a round's
  list, so the visits run in a random order, in the two models of what
  concurrent blocks see ("concurrent": the round-start state, "in
  place": what the visits before left);
- a visit's window is the kernel's TMA box: the tile, a row above and
  below, ``PAD`` columns each side, cells beyond the grid 0 (a box does
  not wrap), and at the dateline the one halo column across it from a
  side box (the grid's last columns for the first tile column, its first
  for the last);
- k in-place sweeps of the field over the tile's cells, rows down then up
  (a row's cells together, as a warp), stopping after a sweep that wrote
  nothing; the cells that changed are written back;
- a visit that wrote pushes onto the next round's list the same field's
  entries of the tiles its edge bits face (K7's rule, the kernel's), and
  itself where its last sweep still wrote; or, the reference's rule,
  which lost the race on the card and is kept here as the schedule's
  other sound answer, its 3x3 tile neighbourhood (x wraps, y clips); the
  solve ends when the list is empty.

Two mutations must stop short: the dateline box without the wrap (a
river over the dateline), and a wake rule without the diagonal tiles (a
river across a tile corner, fed late), in either rule.
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.kernels import flow_deadends as kd
from test_torch_flow_fused_tiles import FACING
from test_torch_flow_tiles import (BL, BR, SCAN, TL, TR, _case, _edge_bits,
                                   _port_case)

torch.set_num_threads(2)

PAD = 4  # columns each side of a box (the kernel's 16 bytes of A)
# the wake rules: the tiles a visit that wrote pushes, the 3x3 rule's
# (and, a mutation, its edge neighbours only), or K7's edge bits (with a
# mutation that drops the corner bits)
RULES = {"3x3": [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)],
         "3x3 without the diagonals": [(0, 0), (-1, 0), (1, 0), (0, -1),
                                       (0, 1)],
         "edges": ~0, "edges without the corners": ~(TL | TR | BL | BR)}


def _window(field, r0, c0, ty, tx, tj, nbx, wrap=True):
    """The kernel's window of a tile: the TMA box (rows r0 - 1 .. r0 + ty,
    columns c0 - PAD .. c0 + tx + PAD - 1, 0 beyond the grid) with the
    halo column across the dateline copied in from a side box."""
    H, W = field.shape
    box = np.zeros((ty + 2, tx + 2 * PAD), field.dtype)
    r = np.arange(r0 - 1, r0 + ty + 1)
    c = np.arange(c0 - PAD, c0 + tx + PAD)
    rin, cin = (r >= 0) & (r < H), (c >= 0) & (c < W)
    box[np.ix_(rin, cin)] = field[np.ix_(r[rin], c[cin])]
    if wrap:
        side = np.zeros(ty + 2, field.dtype)
        side[rin] = field[r[rin], W - 1]
        if tj == 0:
            box[:, PAD - 1] = side          # the side box's last column
        if tj == nbx - 1:
            side = np.zeros(ty + 2, field.dtype)
            side[rin] = field[r[rin], 0]
            box[:, PAD + W - c0] = side     # its first column
    return box


def tma_rounds(packed, area, tile, k, variant, order_seed, wrap=True,
               wake="3x3", max_rounds=None):
    """K11a's rounds in numpy: (A, vis, stats)."""
    p = packed.numpy()
    area = area.numpy().astype(np.float32)
    H, W = p.shape
    ty, tx = tile
    nby, nbx = -(-H // ty), -(-W // tx)
    nt = nby * nbx
    state = {"A": area.copy(), "vis": ((p >> 16) & 1).astype(bool)}
    rng = np.random.default_rng(order_seed)
    limit = H * W + 1 if max_rounds is None else max_rounds
    todo = list(range(2 * nt))  # entry f * nt + tile, f 0 for A
    rounds, visits, most = 0, 0, 0
    while todo:
        if rounds >= limit:
            raise RuntimeError(f"no fixpoint after {rounds} rounds")
        rounds += 1
        src = {n: v.copy() for n, v in state.items()} \
            if variant == "concurrent" else state
        queued, nxt = set(), []
        for e in rng.permutation(todo):
            f, t = divmod(int(e), nt)
            name = ("A", "vis")[f]
            ti, tj = divmod(t, nbx)
            r0, c0 = ti * ty, tj * tx
            rows, cols = min(ty, H - r0), min(tx, W - c0)
            box = _window(src[name], r0, c0, ty, tx, tj, nbx, wrap)
            before = box[1:1 + rows, PAD:PAD + cols].copy()
            pt = p[r0:r0 + rows, c0:c0 + cols]
            sweeps, settled = 0, False
            for it in range(k):
                wrote = False
                order = range(rows) if it % 2 == 0 else range(rows - 1, -1,
                                                               -1)
                for li in order:
                    ctr = box[li + 1, PAD:PAD + cols]
                    if name == "A":
                        acc = area[r0 + li, c0:c0 + cols].copy()
                        for b, (dx, dy) in enumerate(SCAN):
                            on = (pt[li] >> b) & 1 == 1
                            nb = box[li + 1 + dy, PAD + dx:PAD + dx + cols]
                            acc = np.where(on, acc + nb, acc).astype(
                                np.float32)
                        new = np.where((pt[li] & 0xFF) != 0, acc, ctr)
                        moved = new.view(np.int32) != ctr.view(np.int32)
                    else:
                        new = ctr.copy()
                        for b, (dx, dy) in enumerate(SCAN):
                            on = (pt[li] >> (8 + b)) & 1 == 1
                            nb = box[li + 1 + dy, PAD + dx:PAD + dx + cols]
                            new |= on & nb
                        moved = new != ctr
                    if moved.any():
                        box[li + 1, PAD:PAD + cols] = new
                        wrote = True
                sweeps = it + 1
                if not wrote:
                    settled = True
                    break
            most = max(most, sweeps)
            visits += 1
            after = box[1:1 + rows, PAD:PAD + cols]
            changed = after != before
            if not changed.any():
                continue
            field = state[name]
            field[r0:r0 + rows, c0:c0 + cols] = np.where(
                changed, after, field[r0:r0 + rows, c0:c0 + cols])
            if wake.startswith("edges"):
                bits = _edge_bits(changed, rows, cols) & RULES[wake]
                targets = [(di, dj) for bit, di, dj in FACING if bits & bit]
                targets += [] if settled else [(0, 0)]
            else:
                targets = RULES[wake]
            for di, dj in targets:
                ii = ti + di
                if 0 <= ii < nby:
                    nb = f * nt + ii * nbx + (tj + dj) % nbx
                    if nb not in queued:
                        queued.add(nb)
                        nxt.append(nb)
        todo = nxt
    return state["A"], state["vis"], {"rounds": rounds, "tiles_run": visits,
                                      "max_inner_sweeps": most,
                                      "tiles": 2 * nt}


def _corner_case():
    """A river that crosses a tile corner, (3, 23) to (4, 24) on 4x4
    tiles, into the ocean at (5, 25).  Two tributaries feed (3, 23): a
    short one, and a long one along row 0, whose cells have no area, so
    its one cell's area reaches the corner some 25 rounds after the short
    one's and nothing changes there in between: the tile below and to the
    right has gone quiet by then, and only the corner's diagonal wake
    reaches it."""
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.core.topology import DIR_CODE
    from demiurge_tpu_torch.ops import flow as tf

    grid = Grid(40, 12)
    code = torch.full(grid.shape, 5, dtype=torch.int32)  # land sinks
    path = [(1, 0, (0, -1))] + [(0, c, (1, 0)) for c in range(23)] + [
        (0, 23, (0, 1)), (1, 23, (0, 1)), (2, 23, (0, 1)), (2, 22, (1, 1)),
        (3, 23, (1, 1)), (4, 24, (1, 1))]
    for r, c, d in path:
        code[r, c] = DIR_CODE[d]
    code[5, 25] = 0  # the ocean cell
    _, mouth, _ = tf.incoming_mask(code, grid)
    return grid, kf.pack_masks(code, mouth, grid), \
        tf.cell_area_lower_edge(grid, "cpu"), (4, 4)


def _cases(name):
    """(grid, packed, area, tile) of each case."""
    if name == "corner":
        return _corner_case()
    if name == "ragged":
        # a terrain whose tiles divide neither side (the card's 16x128
        # tiles divide neither 2000 nor 1000)
        grid, packed, area = _port_case(250, 125, seed=5)
        return grid, packed, area, (16, 32)
    if name == "dateline":
        grid, packed, area, _, _ = _case("serpentine")
        return grid, packed, area, (4, 8)
    grid, packed, area, _, _ = _case("diagonal")  # across tile corners
    return grid, packed, area, (4, 4)


@pytest.mark.parametrize("wake", ["3x3", "edges"])
@pytest.mark.parametrize("variant", ["concurrent", "in place"])
@pytest.mark.parametrize("name", ["ragged", "dateline", "corners",
                                  "corner"])
def test_tma_rounds_reach_the_twin_fixpoint(name, variant, wake):
    """A bit for bit with the twin on the same tiles (and K7's twin), vis
    exactly (and K8's), two visit orders, k 16 and 2, either wake rule."""
    grid, packed, area, tile = _cases(name)
    k = min(tile)
    tA, tvis, _ = kd.flow_solve_2d_plain(packed, area, grid, k=k,
                                         tiles=tile)
    np.testing.assert_array_equal(
        tA.numpy(), kf.flow_solve_area_plain(packed, area, grid).numpy())
    np.testing.assert_array_equal(tvis.numpy(),
                                  kf.vis_solve_plain(packed, grid).numpy())
    for kk, order_seed in ((16, 0), (2, 1)):
        A, vis, st = tma_rounds(packed, area, tile, kk, variant, order_seed,
                                wake=wake)
        np.testing.assert_array_equal(A, tA.numpy())
        np.testing.assert_array_equal(vis, tvis.numpy())
        assert st["rounds"] >= 2 and 1 <= st["max_inner_sweeps"] <= kk
        if name == "dateline":  # the lists skip quiet tiles
            assert st["tiles_run"] < st["rounds"] * st["tiles"]


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
def test_the_dateline_box_without_the_wrap_stops_short(variant):
    """Boxes do not wrap: without the side box's column a river over the
    dateline loses what crosses it."""
    grid, packed, area, tile = _cases("dateline")
    want = kf.flow_solve_area_plain(packed, area, grid).numpy()
    for order_seed in (0, 1):
        A, _, _ = tma_rounds(packed, area, tile, 4, variant, order_seed)
        np.testing.assert_array_equal(A, want)
        A_cut, _, _ = tma_rounds(packed, area, tile, 4, variant, order_seed,
                                 wrap=False)
        assert not np.array_equal(A_cut, want)


@pytest.mark.parametrize("rule", ["3x3", "edges"])
@pytest.mark.parametrize("variant", ["concurrent", "in place"])
def test_a_wake_rule_without_the_diagonal_tiles_stops_short(variant, rule):
    """A river across a tile corner, fed late: a write at a corner reaches
    only the diagonal tile's halo, so a rule that wakes the edge
    neighbours alone leaves that tile stale once it has gone quiet."""
    grid, packed, area, tile = _cases("corner")
    want = kf.flow_solve_area_plain(packed, area, grid).numpy()
    assert want[5, 25] > want[4, 24] > want[3, 23] > 0
    cut = {"3x3": "3x3 without the diagonals",
           "edges": "edges without the corners"}[rule]
    for order_seed in (0, 1):
        A, _, _ = tma_rounds(packed, area, tile, 1, variant, order_seed,
                             wake=rule)
        np.testing.assert_array_equal(A, want)
        A_cut, _, _ = tma_rounds(packed, area, tile, 1, variant, order_seed,
                                 wake=cut)
        np.testing.assert_array_equal(A_cut[:4], want[:4])
        assert A_cut[4, 24] < want[4, 24]


def test_the_round_limit_raises():
    grid, packed, area, tile = _cases("dateline")
    _, _, st = tma_rounds(packed, area, tile, 4, "in place", 0)
    tma_rounds(packed, area, tile, 4, "in place", 0,
               max_rounds=st["rounds"])
    with pytest.raises(RuntimeError, match="no fixpoint after"):
        tma_rounds(packed, area, tile, 4, "in place", 0,
                   max_rounds=st["rounds"] - 1)


def test_twin_tiles_option():
    """The twin on given tiles, ragged at the far edges, reaches the same
    fixpoint as on the reference's tiles; without tiles it keeps the
    reference's pick (which raises where none divide the grid)."""
    grid, packed, area = _port_case(256, 128, seed=3)
    A, vis, st = kd.flow_solve_2d_plain(packed, area, grid, k=8)
    A2, vis2, st2 = kd.flow_solve_2d_plain(packed, area, grid, k=8,
                                           tiles=(48, 80))
    assert st["tiles"] == (128, 256) and st2["tiles"] == (48, 80)
    assert torch.equal(A, A2) and torch.equal(vis, vis2)
    with pytest.raises(ValueError, match="k must be"):
        kd.flow_solve_2d_plain(packed, area, grid, k=16, tiles=(8, 128))
