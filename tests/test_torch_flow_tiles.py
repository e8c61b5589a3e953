"""The schedule of the tiled flow kernels K7 and K8 (csrc/flow.cu), in numpy.

The CUDA kernels cannot run here, so their schedule is transliterated and
held to the plain twins' fixpoint (``flow_solve_area_plain``'s A bit for
bit, ``vis_solve_plain``'s vis exactly): it is what checks the argument in
csrc/flow.cu.  A round visits, in a random order, the tiles whose halo a
neighbour tile wrote in the last round (x wraps, y clips; round 1 visits
all): each tile leaves edge bits, which of its border rows, columns and
corners it wrote.  A visit loads its tile and a one-cell halo, solves the
tile's local fixpoint with the halo held and writes back the cells that
changed.  K7 relaxes in strips of columns (the kernel's warps): passes
over a strip's dirty rows, down then up, a row repeated while a cell that
feeds its own row changed, a change making the rows above and below dirty
and, in an edge column, marking the rows of the strip beside, until no
row is dirty.  K8 jumps pointers down the paths until none moves.  Two
variants bound what concurrent blocks can see:

- "concurrent": every visit of a round reads the round-start state;
- "in place": a visit reads the state the visits before it left.

A round in which no tile wrote ends the solve.  A wrong rule that wakes a
tile on its own writes only must stop short of the fixpoint.  The grids are
ragged (the tile divides neither W nor H).
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.tools import serpentine

torch.set_num_threads(2)

SCAN = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1), (0, -1),
        (-1, -1))
ROW_FEED = (1 << 3) | (1 << 4)  # out bits to the dy = 0 neighbours


def _port_case(W, H, seed=2):
    """(grid, packed masks, area) of a smooth random terrain, through the
    port's own direction pass."""
    from demiurge_tpu_torch.ops import flow as tf

    grid = Grid(W, H)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(4):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    code = tf.flow_directions(torch.from_numpy((h + 0.1) * 10),
                              torch.ones(H, W), grid)
    _, mouth, _ = tf.incoming_mask(code, grid)
    return grid, kf.pack_masks(code, mouth, grid), \
        tf.cell_area_lower_edge(grid, "cpu")


def _jump(local, bits, real):
    """K8's visit: every cell of the halo'd tile ``local`` points down its
    path (ends at themselves), and the pointers jump, all at once, until
    none changes; a cell turns to 1 when it points at a 1.  Returns the
    passes it took."""
    ty, tx = bits.shape
    flat = local.reshape(-1)
    q = (np.arange(1, ty + 1)[:, None] * (tx + 2)
         + np.arange(1, tx + 1)[None, :])
    nxt = np.arange(flat.size)
    for k, (dx, dy) in enumerate(SCAN):
        on = real & ((bits >> k) & 1 == 1)
        nxt[q[on]] = q[on] + dy * (tx + 2) + dx
    passes = 0
    while True:
        passes += 1
        n = nxt[q]
        live = (n != q) & ~flat[q]
        gain = live & flat[n]
        hop = live & ~flat[n] & (nxt[n] != n)
        flat[q[gain]] = True
        nxt[q[hop]] = nxt[n[hop]]
        if not (gain.any() or hop.any()):
            return passes


def _relax(local, bits, feed, real, area, strip, rng):
    """K7's visit: the relaxation of the halo'd tile ``local`` in place,
    in strips of ``strip`` columns (the kernel's warps), each with its own
    dirty rows; the strips of a pass run one after another in a random
    order (the kernel runs them at once).  Returns the passes it took."""
    ty, tx = bits.shape
    ns = tx // strip
    dirty = np.ones((ns, ty), bool)
    marks = np.zeros((ns, ty), bool)
    passes = 0
    while dirty.any():
        rows = range(ty) if passes % 2 == 0 else range(ty - 1, -1, -1)
        for w in rng.permutation(ns):
            cols = slice(w * strip, (w + 1) * strip)
            for li in rows:
                if not dirty[w, li]:
                    continue
                dirty[w, li] = False
                near = slice(max(li - 1, 0), li + 2)
                while True:
                    cur = local[li + 1, 1 + cols.start:1 + cols.stop]
                    new = area[li, cols].copy()
                    for k, (dx, dy) in enumerate(SCAN):
                        on = (bits[li, cols] >> k) & 1 == 1
                        nb = local[li + 1 + dy, 1 + dx + cols.start:
                                   1 + dx + cols.stop]
                        new = np.where(on, new + nb, new).astype(np.float32)
                    ch = real[li, cols] & (new.view(np.int32)
                                           != cur.view(np.int32))
                    local[li + 1, 1 + cols.start:1 + cols.stop] = \
                        np.where(ch, new, cur)
                    if ch.any():  # the rows above and below read this one
                        dirty[w, near] = True
                        dirty[w, li] = False
                    if ch[0] and w > 0:  # the strips beside read the edges
                        marks[w - 1, near] = True
                    if ch[-1] and w < ns - 1:
                        marks[w + 1, near] = True
                    if not (ch & feed[li, cols]).any():
                        break
        passes += 1
        dirty |= marks
        marks[:] = False
    return passes


# a tile's edge bits, as csrc/flow.cu leaves them: the cells it wrote of
# its top, bottom rows, left, right columns, and of its 4 corners (the
# last real row and column of a ragged tile)
TOP, BOTTOM, LEFT, RIGHT, TL, TR, BL, BR = (1 << i for i in range(8))
ALL_EDGES = 255


def _edge_bits(moved, h, w):
    top, bottom = moved[0].any(), moved[h - 1].any()
    left, right = moved[:, 0].any(), moved[:, w - 1].any()
    return (TOP * top | BOTTOM * bottom | LEFT * left | RIGHT * right
            | TL * moved[0, 0] | TR * moved[0, w - 1]
            | BL * moved[h - 1, 0] | BR * moved[h - 1, w - 1])


def _woken(edges):
    """(nby, nbx) bool: the tiles whose halo a neighbour tile wrote (x
    wraps, y clips)."""
    e = np.pad(edges, ((1, 1), (0, 0)))

    def at(di, dj):  # the bits of the tile at (i + di, j + dj)
        return np.roll(e[1 + di:e.shape[0] - 1 + di], -dj, 1)

    return ((at(-1, 0) & BOTTOM) | (at(1, 0) & TOP) | (at(0, -1) & RIGHT)
            | (at(0, 1) & LEFT) | (at(-1, -1) & BR) | (at(-1, 1) & BL)
            | (at(1, -1) & TR) | (at(1, 1) & TL)) != 0


def _rounds(start, visit, tile, variant, order_seed, own_only=False):
    """Tiled rounds from ``start`` (H, W) until a round writes nothing.
    ``visit(local, cells, real, rng)`` solves the halo'd tile ``local`` in
    place (``cells(a)``: the tile's cells of a grid array, 0 beyond the
    grid) and returns the passes it took.  ``own_only``: the wrong rule, a
    tile woken by its own writes only.  Returns (field, stats)."""
    H, W = start.shape
    ty, tx = tile
    nby, nbx = -(-H // ty), -(-W // tx)
    # the tiles' (rows, columns) of the grid, padded to whole tiles, with
    # one halo cell a side: x periodic, rows beyond the grid never read
    pad_r = np.arange(-1, nby * ty + 1)
    pad_c = np.arange(-1, nbx * tx + 1) % W
    X = start.copy()
    edges = np.full((nby, nbx), ALL_EDGES)
    wrote = np.ones((nby, nbx), bool)
    rng = np.random.default_rng(order_seed)
    visits, most = 0, 0
    for rnd in range(1, H * W + 2):
        awake = wrote if own_only else _woken(edges)
        src = X.copy() if variant == "concurrent" else X
        wrote = np.zeros((nby, nbx), bool)
        edges = np.zeros((nby, nbx), int)
        for t in rng.permutation(nby * nbx):
            i, j = divmod(int(t), nbx)
            if not awake[i, j]:
                continue
            r = pad_r[i * ty:(i + 1) * ty + 2]
            c = pad_c[j * tx:(j + 1) * tx + 2]
            ok = (r >= 0) & (r < H)
            local = np.zeros((ty + 2, tx + 2), X.dtype)
            local[ok] = src[r[ok]][:, c]
            rr, cc = r[1:-1], np.arange(j * tx, (j + 1) * tx)
            real = ((rr >= 0) & (rr < H))[:, None] & (cc < W)[None, :]
            inner = np.ix_(np.clip(rr, 0, H - 1), np.minimum(cc, W - 1))

            def cells(a, real=real, inner=inner):
                return np.where(real, a[inner], 0)

            before = local[1:-1, 1:-1].copy()
            most = max(most, visit(local, cells, real, rng))
            visits += 1
            after = local[1:-1, 1:-1]
            if X.dtype == np.float32:
                moved = real & (after.view(np.int32) != before.view(np.int32))
            else:
                moved = real & (after != before)
            if moved.any():
                X[rr[:, None].repeat(tx, 1)[moved],
                  cc[None, :].repeat(ty, 0)[moved]] = after[moved]
                wrote[i, j] = True
                edges[i, j] = _edge_bits(moved, min(ty, H - i * ty),
                                         min(tx, W - j * tx))
        if not wrote.any():
            return X, {"rounds": rnd, "tiles_run": visits,
                       "max_inner_sweeps": most, "tiles": nby * nbx}
    raise AssertionError("no fixpoint")


def _tile_rounds(packed, start, area, tile, variant, order_seed,
                 own_only=False):
    """The tiled solve of A (``area`` given: K7's visit) or vis (``area``
    None: K8's) from ``start``.  Returns (field, stats)."""
    p = packed.numpy()
    ty, tx, strip = tile
    if area is None:
        def visit(local, cells, real, rng):
            return _jump(local, cells((p >> 8) & 0xFF), real)
    else:
        def visit(local, cells, real, rng):
            return _relax(local, cells(p & 0xFF),
                          cells((p >> 8) & ROW_FEED) != 0, real,
                          cells(area).astype(np.float32), strip, rng)
    return _rounds(start, visit, (ty, tx), variant, order_seed, own_only)


def _rivers(grid, rivers):
    """(packed, area) of straight rivers, each (row, column, (dx, dy), n):
    n cells from (row, column), one step (dx, dy) at a time (x periodic),
    into an ocean cell; every other cell a land sink."""
    from demiurge_tpu_torch.core.topology import DIR_CODE
    from demiurge_tpu_torch.ops import flow as tf

    code = torch.full(grid.shape, 5, dtype=torch.int32)
    for r, c, (dx, dy), n in rivers:
        for k in range(n):
            code[r + k * dy, (c + k * dx) % grid.width] = DIR_CODE[(dx, dy)]
        code[r + n * dy, (c + n * dx) % grid.width] = 0
    _, mouth, _ = tf.incoming_mask(code, grid)
    return kf.pack_masks(code, mouth, grid), \
        tf.cell_area_lower_edge(grid, "cpu")


def _case(name):
    """(grid, packed, area, A start, (tile rows, columns, strip columns))
    of each case."""
    if name == "diagonal":
        # 26 cells from (1, 37) over the dateline of a 42-wide grid, through
        # ragged tiles of 4 x 4: corners before the dateline, edges after
        grid = Grid(42, 30)
        packed, area = _rivers(grid, [(1, 37, (1, 1), 26)])
        return grid, packed, area, area, (4, 4, 2)
    if name == "rows":
        # one river east along row 5, one west along row 9, each across
        # every strip of 2 columns of its row
        grid = Grid(42, 14)
        packed, area = _rivers(grid, [(5, 3, (1, 0), 38),
                                      (9, 40, (-1, 0), 38)])
        return grid, packed, area, area, (4, 8, 2)
    if name == "serpentine":
        # one river of 10 columns x 18 rows from x = 55 over the dateline
        # of a 60-wide grid, through 6 x 8 ragged tiles of 4 x 8
        grid = Grid(60, 22)
        packed, area = serpentine(grid, "cpu", 55, 10, 18)
        return grid, packed, area, area, (4, 8, 4)
    if name == "one-column":
        # W below a tile: the tile's halo columns are its own cells, and
        # it wakes itself through its own edge bits
        grid, packed, area = _port_case(12, 44)
        return grid, packed, area, area, (8, 16, 4)
    if name == "one-row":
        grid, packed, area = _port_case(100, 6)
        return grid, packed, area, area, (8, 16, 4)
    grid, packed, area = _port_case(100, 44)
    if name == "port":
        return grid, packed, area, area, (8, 16, 4)
    # warm: the fixpoint of another terrain, as a step after the first
    _, other, _ = _port_case(100, 44, seed=3)
    return grid, packed, area, kf.flow_solve_area_plain(other, area, grid), \
        (8, 16, 4)


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
@pytest.mark.parametrize("name", ["port", "serpentine", "warm",
                                  "diagonal", "rows", "one-column",
                                  "one-row"])
def test_tile_schedule_reaches_the_plain_fixpoint(name, variant):
    """A bit for bit and vis exactly, in both variants and two visit
    orders; vis starts at the mouths in every case."""
    grid, packed, area, a0, tile = _case(name)
    want_A = kf.flow_solve_area_plain(packed, area, grid, a0).numpy()
    want_vis = kf.vis_solve_plain(packed, grid).numpy()
    mouth = ((packed >> 16) & 1).bool().numpy()
    for order_seed in (0, 1):
        A, st = _tile_rounds(packed, a0.numpy(), area.numpy(), tile, variant,
                             order_seed)
        np.testing.assert_array_equal(A, want_A)
        vis, sv = _tile_rounds(packed, mouth, None, tile, variant,
                               order_seed)
        np.testing.assert_array_equal(vis, want_vis)
        if name == "serpentine":  # quiet tiles were skipped
            assert st["tiles_run"] < st["rounds"] * st["tiles"]
            assert sv["tiles_run"] < sv["rounds"] * sv["tiles"]
        for s in (st, sv):
            assert s["rounds"] >= 2 and s["max_inner_sweeps"] >= 2
    assert want_vis.sum() > mouth.sum()


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
def test_tile_schedule_with_a_wrong_wake_rule_stops_short(variant):
    """Warm-started from the serpentine's fixpoint with no area in its
    first column, every tile but that column's starts consistent and goes
    quiet before the correction reaches it: the halo rule wakes it when
    the correction does, a rule that wakes a tile on its own writes only
    leaves it stale."""
    grid, packed, area, _, tile = _case("serpentine")
    want = kf.flow_solve_area_plain(packed, area, grid).numpy()
    dry = area.clone()
    dry[1:19, 55] = 0.0
    a0 = kf.flow_solve_area_plain(packed, dry, grid).numpy()
    for order_seed in (0, 1):
        A, _ = _tile_rounds(packed, a0, area.numpy(), tile, variant,
                            order_seed)
        np.testing.assert_array_equal(A, want)
        A_own, _ = _tile_rounds(packed, a0, area.numpy(), tile, variant,
                                order_seed, own_only=True)
        assert not np.array_equal(A_own, want)


def test_serpentine_is_one_long_river():
    """The hand-built field: 180 river cells, the ocean cell they end in
    carrying the area of all, and every river cell reaches the ocean."""
    grid = Grid(60, 22)
    packed, area = serpentine(grid, "cpu", 55, 10, 18)
    A = kf.flow_solve_area_plain(packed, area, grid)
    vis = kf.vis_solve_plain(packed, grid)
    inc = (packed & 0xFF) != 0   # 179 river cells and the ocean cell
    river = ((packed >> 8) & 0xFF) != 0
    assert int(river.sum()) == 180 and int(inc.sum()) == 180
    assert bool(vis[river].all())
    assert torch.isclose(A.max(), area[river | inc].sum(), rtol=1e-5)
    with pytest.raises(ValueError, match="does not fit"):
        serpentine(grid, "cpu", 0, 10, 20)
