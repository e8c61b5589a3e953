"""The schedule of the tiled K12 solve (csrc/lakeflow.cu), in numpy.

The CUDA kernels cannot run here, so their schedule is transliterated and
held to the plain twin's fixpoint (``kernels.lakeflow.relax_solve_twin``:
A bit for bit, vis and root exactly): it is what checks the argument in
csrc/lakeflow.cu.  The rounds are K7/K8's (``tests/test_torch_flow_tiles.py``
``_rounds``: tiles woken by the edge bits of their neighbours' writes, in a
random visit order, "concurrent" and "in place" variants, a round that
writes nothing ends a solve), with K12's remote reads and wakes; the
visits are K7's and K8's with K12's neighbours (the row clamped to the
grid, the column wrapped or, on a regional grid, clamped):

- A: K7's relaxation in strips, + A[conn_src] at an attach pixel after
  the taps: read live from the tile where the lake sink lies in it (a
  change of the sink marks the attach pixel's row dirty), else read at
  the visit's start, and then a write of A at the sink wakes the attach
  pixel's tile.  After the first round a visit starts with only the rows
  whose inputs may have changed dirty: those next to the halo cells the
  neighbours' edge bits name, in the strips that read them, and the
  attach pixels' rows where a remote write woke the tile;
- vis: K8's pointer jumping from the mouths, a lake sink pointing at its
  attach pixel where that lies in the tile, else turned to 1 at the
  visit's start where vis[conn_dst] is 1, and then a write of vis at the
  attach pixel wakes the sink's tile;
- root: pointer jumping to the ends (a sink at its flat index, a cell
  without an out bit at -1, a halo cell and a cell that points at itself
  at root as loaded), then every cell takes its end's value.

The cases: a ragged globe (the tile divides neither side) and a regional
grid, each with the port's numpy lake solution, the globe without its
connections, straight rivers north and along three diagonals across tile
edges and corners, and a chain of lakes (every cell a sink but 12 rivers, each
lake's sink feeding the head of the next river, the last into the ocean)
on tiles that put every connection across tiles, and on tiles that hold
all but one of them.  The wrong rule that ignores the connections' wakes
must stop short on the chain.
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.core.topology import DIR_CODE
from demiurge_tpu_torch.kernels import lakeflow as kl
from demiurge_tpu_torch.ops import flow as tf
from test_torch_flow_tiles import (BL, BOTTOM, BR, LEFT, REMOTE, RIGHT,
                                   SCAN, TL, TOP, TR, _jump, _relax,
                                   _rounds)

torch.set_num_threads(2)

REGIONAL = (-0.4, 0.3, -1.0, 0.5)   # coords: no pole, no dateline
ROW_FEED = (1 << 3) | (1 << 4)      # out bits to the dy = 0 neighbours
NEG_OUT, POS_OUT = 0xE0, 0x07       # out bits to dy = -1, to dy = +1


def _terrain_case(W, H, regional=False, seed=4):
    """(grid, code, mouth, conn_from, conn_to) of a smooth random terrain
    through the port's direction pass and numpy lake solver."""
    grid = Grid(W, H, REGIONAL) if regional else Grid(W, H)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    h = torch.from_numpy((h + 0.05) * 20)
    code = tf.flow_directions(tf.blur(h, grid, 0.5), torch.ones(H, W), grid)
    mask, mouth, _ = tf.incoming_mask(code, grid)
    sol = tf.solve_lakes_numpy(mask.numpy().reshape(-1),
                               mouth.numpy().reshape(-1),
                               h.numpy().reshape(-1), None, grid)
    return grid, code, mouth, torch.from_numpy(
        sol.conn_from.astype(np.int64)), torch.from_numpy(
            sol.conn_to.astype(np.int64))


def _chain_case():
    """12 straight rivers of 5 cells on a 60x30 globe, every other cell a
    sink: river k (row 2 + 2k, every other one running west) ends in a
    lake sink whose connection attaches to the head of river k + 1, 17
    columns on; the last river ends in the ocean."""
    grid = Grid(60, 30)
    code = torch.full(grid.shape, 5, dtype=torch.int32)
    heads, sinks = [], []
    for k in range(12):
        r, c, dx = 2 + 2 * k, (17 * k) % 60, 1 if k % 2 == 0 else -1
        for i in range(5):
            code[r, (c + i * dx) % 60] = DIR_CODE[(dx, 0)]
        end = (c + 5 * dx) % 60
        code[r, end] = 0 if k == 11 else 5
        heads.append(r * 60 + c)
        sinks.append(r * 60 + end)
    _, mouth, _ = tf.incoming_mask(code, grid)
    cfrom = torch.tensor(sinks[:-1], dtype=torch.int64)
    cto = torch.tensor(heads[1:], dtype=torch.int64)
    return grid, code, mouth, cfrom, cto


def _rivers_case():
    """Rivers on a 42x30 globe, every other cell a sink: one north up a
    column in the middle of its tiles, three diagonals (north-east,
    north-west, south-west) across tile corners, each into an ocean
    cell.  On 4 x 8 tiles each crossing of a tile edge or corner is the
    only thing that wakes the tile it enters."""
    grid = Grid(42, 30)
    code = torch.full(grid.shape, 5, dtype=torch.int32)
    for r, c, (dx, dy), n in ((28, 22, (0, -1), 27), (27, 25, (1, -1), 15),
                              (25, 12, (-1, -1), 10), (2, 10, (-1, 1), 9)):
        for k in range(n):
            assert code[r + k * dy, c + k * dx] == 5
            code[r + k * dy, c + k * dx] = DIR_CODE[(dx, dy)]
        assert code[r + n * dy, c + n * dx] == 5
        code[r + n * dy, c + n * dx] = 0
    _, mouth, _ = tf.incoming_mask(code, grid)
    none = torch.zeros(0, dtype=torch.int64)
    return grid, code, mouth, none, none


def _case(name):
    """(grid, packed, area, conn_src, conn_dst, (tile rows, columns,
    strip columns))."""
    if name == "rivers":
        grid, code, mouth, cfrom, cto = _rivers_case()
        tile = (4, 8, 4)
    elif name.startswith("chain"):
        grid, code, mouth, cfrom, cto = _chain_case()
        # 4 x 8 tiles put every connection across tiles, 16 x 64 all but
        # one within a tile
        tile = (4, 8, 4) if name == "chain" else (16, 64, 16)
    else:
        grid, code, mouth, cfrom, cto = _terrain_case(
            50, 26, regional=name == "regional")
        assert cfrom.numel() > 0
        if name == "no-connections":
            cfrom = cto = torch.zeros(0, dtype=torch.int64)
        tile = (8, 16, 4)
    src, dst = kl.conn_fields(cfrom, cto, grid.shape)
    packed = kl.pack_lake_masks(code, mouth, grid, src, dst)
    area = tf.cell_area_lower_edge(grid, "cpu")
    return grid, packed, area, src, dst, tile


def _nbr_slots(at, tile, H, W, wrap):
    """(ty, tx, 8): each tile cell's neighbour slot in the halo'd tile,
    the row clamped to the grid and the column wrapped or clamped."""
    (i, j), (ty, tx) = at, tile
    rows = i * ty + np.arange(ty)
    cols = j * tx + np.arange(tx)
    out = np.empty((ty, tx, 8), np.int64)
    for k, (dx, dy) in enumerate(SCAN):
        r = np.clip(rows + dy, 0, H - 1)[:, None]
        c = cols[None, :] + dx
        if not wrap:
            c = np.clip(c, 0, W - 1)
        out[..., k] = (r - i * ty + 1) * (tx + 2) + c - j * tx + 1
    return out


def _root_jump(local, outs, real, pin, slots):
    """The root visit on the halo'd tile ``local`` (int): the ends pinned
    (``pin``: a sink's flat index, -1 elsewhere, at the cells without an
    out bit), the pointers jump, all at once, until each is at an end,
    then every cell of the grid takes its end's value.  Returns the
    passes."""
    ty, tx = outs.shape
    flat = local.reshape(-1)
    q = (np.arange(1, ty + 1)[:, None] * (tx + 2)
         + np.arange(1, tx + 1)[None, :])
    ends = real & (outs == 0)
    flat[q[ends]] = pin[ends]
    nxt = np.arange(flat.size)
    for k in range(8):
        on = real & ((outs >> k) & 1 == 1)
        nxt[q[on]] = slots[..., k][on]
    passes = 0
    while True:
        passes += 1
        n = nxt[q]
        m = nxt[n]
        hop = m != n
        nxt[q[hop]] = m[hop]
        if not hop.any():
            break
    flat[q[real]] = flat[nxt[q[real]]]
    return passes


def _lake_rounds(field, grid, packed, area, src, dst, tile, variant,
                 order_seed, wake=True):
    """The tiled solve of ``field`` ("A", "vis" or "root") from its start
    (the area, the mouths, ``root_start``).  ``wake=False``: the wrong
    rule, the connections' writes wake nobody.  Returns (field, stats)."""
    p = packed.numpy()
    H, W = grid.shape
    ty, tx, strip = tile
    s, d = src.numpy(), dst.numpy()
    outs = (p >> 8) & 0xFF
    rows = np.arange(H)[:, None]
    feed = ((outs & ROW_FEED) != 0) | ((rows == 0) & ((outs & NEG_OUT) != 0)) \
        | ((rows == H - 1) & ((outs & POS_OUT) != 0))
    has_src, has_dst = s >= 0, d >= 0
    flat_id = np.arange(H * W).reshape(H, W)
    pin = np.where((p & kl.SINK_BIT) != 0, flat_id, -1)

    def slots(at):
        return _nbr_slots(at, (ty, tx), H, W, grid.wrap_x)

    def tile(g):  # (row, column) of the tile that holds flat cell g
        return (g // W) // ty, (g % W) // tx

    def here(other, at):
        """The tile cells (row * tx + column) of ``other``'s cells that lie
        in tile ``at``, -1 elsewhere (and where ``other`` is -1)."""
        g = np.maximum(other, 0)
        ti, tj = tile(g)
        inside = (other >= 0) & (ti == at[0]) & (tj == at[1])
        cell = (g // W - at[0] * ty) * tx + g % W - at[1] * tx
        return np.where(inside, cell, -1)

    def halo_slot(cell):  # a tile cell's slot in the halo'd tile
        return np.where(cell >= 0, (cell // tx + 1) * (tx + 2)
                        + cell % tx + 1, -1)

    def away(g, other):  # the cells of ``other`` in another tile than g's
        ti, tj = tile(g)
        oi, oj = tile(other)
        return other[(oi != ti) | (oj != tj)]

    def first_dirty(woke, at, far):
        """The kernel's starting rows a strip: every row in the first
        round, else the rows next to the halo cells a neighbour wrote, in
        the strips that read them, and the rows of ``far`` (the attach
        pixels whose sink lies in another tile) where a cell read remotely
        was written."""
        ns = tx // strip
        if woke == -1:
            return np.ones((ns, ty), bool)
        rows = np.zeros((ns, ty), bool)
        rows[:, 0] |= bool(woke & BOTTOM)
        rows[:, ty - 1] |= bool(woke & TOP)
        if woke & REMOTE:
            rows |= far.reshape(ty, ns, strip).any(2).T
        last = (min(tx, W - at[1] * tx) - 1) // strip
        for w, side, first, end in ((0, RIGHT, BR, TR),
                                    (last, LEFT, BL, TL)):
            rows[w] |= bool(woke & side)
            rows[w, 0] |= bool(woke & first)
            rows[w, ty - 1] |= bool(woke & end)
        return rows

    if field == "A":
        def visit(local, cells, real, rng, read, at, woke):
            has = cells(has_src) != 0
            link = halo_slot(here(cells(np.where(has_src, s, -1)), at))
            far = has & (link < 0)
            term = np.where(far, read(np.maximum(cells(s), 0)), 0)
            return _relax(local, cells(p & 0xFF), cells(feed) != 0, real,
                          cells(area.numpy()).astype(np.float32), strip,
                          rng, slots(at),
                          (has, term.astype(np.float32), link),
                          here(cells(np.where(has_dst, d, -1)), at),
                          first_dirty(woke, at, far))

        def wakes(g):  # a lake sink's A is read at its attach pixel
            g = g[has_dst.reshape(-1)[g]]
            return away(g, d.reshape(-1)[g])
        start = area.numpy().copy()
    elif field == "vis":
        def visit(local, cells, real, rng, read, at, woke):
            q = (np.arange(1, ty + 1)[:, None] * (tx + 2)
                 + np.arange(1, tx + 1)[None, :])
            dd = cells(np.where(has_dst, d, -1))
            link = halo_slot(here(dd, at))
            far = real & (dd >= 0) & (link < 0) & read(np.maximum(dd, 0))
            local.reshape(-1)[q[far]] = True
            return _jump(local, cells(outs), real, slots(at), link)

        def wakes(g):  # an attach pixel's vis is read at its lake sink
            g = g[has_src.reshape(-1)[g]]
            return away(g, s.reshape(-1)[g])
        start = ((p >> 16) & 1) != 0
    else:
        def visit(local, cells, real, rng, read, at, woke):
            return _root_jump(local, cells(outs), real, cells(pin),
                              slots(at))

        wakes = None
        start = kl.root_start(packed).numpy().astype(np.int64)
    return _rounds(start, visit, (ty, tx), variant, order_seed,
                   remote=True, wakes=wakes if wake else None)


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
@pytest.mark.parametrize("with_root", [True, False], ids=["root",
                                                          "no-root"])
@pytest.mark.parametrize("name", ["globe", "regional", "no-connections",
                                  "rivers", "chain", "chain-in-tile"])
def test_lake_tile_schedule_reaches_the_twin_fixpoint(name, with_root,
                                                      variant):
    """A bit for bit and vis (and root) exactly, in two visit orders."""
    grid, packed, area, src, dst, tile = _case(name)
    assert grid.wrap_x == (name != "regional")
    wA, wvis, wroot, _ = kl.relax_solve_twin(packed, area, src, dst, grid,
                                             want_root=with_root)
    assert (wroot is None) != with_root
    n_conn = int((src >= 0).sum())
    assert (n_conn == 0) == (name in ("no-connections", "rivers"))
    fields = ("A", "vis", "root") if with_root else ("A", "vis")
    for order_seed in (0, 1):
        got = {f: _lake_rounds(f, grid, packed, area, src, dst, tile,
                               variant, order_seed) for f in fields}
        np.testing.assert_array_equal(got["A"][0].view(np.int32),
                                      wA.numpy().view(np.int32))
        np.testing.assert_array_equal(got["vis"][0], wvis.numpy())
        if with_root:
            np.testing.assert_array_equal(got["root"][0], wroot.numpy())
        for f in ("A", "vis"):
            assert got[f][1]["rounds"] >= 2
    mouth = ((packed >> 16) & 1).bool()
    assert bool((wvis & ~mouth).any())
    if name.startswith("chain"):
        # every river reaches the ocean through the chain, and the ocean
        # cell sums all 12 rivers' areas
        river = ((packed >> 8) & 0xFF) != 0
        assert int(river.sum()) == 60 and bool(wvis[river].all())
        assert float(wA.max()) > 59 * float(area.min())
        assert (wroot is None) or int((wroot >= 0).sum()) > 0


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
def test_lake_tile_schedule_without_remote_wakes_stops_short(variant):
    """On the chain, a rule that wakes no tile for a connection's write
    leaves A and vis short of the fixpoint: the attach pixel's tile read
    its lake sink's A (and the sink's tile its attach pixel's vis) before
    they settled, and nothing wakes them again."""
    grid, packed, area, src, dst, tile = _case("chain")
    wA, wvis, _, _ = kl.relax_solve_twin(packed, area, src, dst, grid)
    for order_seed in (0, 1):
        A, _ = _lake_rounds("A", grid, packed, area, src, dst, tile, variant,
                            order_seed, wake=False)
        vis, _ = _lake_rounds("vis", grid, packed, area, src, dst, tile,
                              variant, order_seed, wake=False)
        assert not np.array_equal(A, wA.numpy())
        assert not np.array_equal(vis, wvis.numpy())


def test_twin_solve_is_flow_solve_stencil():
    """``relax_solve_twin`` is what ``flow_solve_stencil`` runs on the CPU:
    the same fields and sweeps."""
    grid, code, mouth, cfrom, cto = _terrain_case(50, 26)
    A, vis, root = tf.flow_solve_stencil(
        code, tf.cell_area_lower_edge(grid, "cpu"), mouth, grid,
        conn_from=cfrom, conn_to=cto, want_root=True)
    assert set(tf.LAST_SOLVE) == {"sweeps"}
    sweeps = tf.LAST_SOLVE["sweeps"]
    src, dst = kl.conn_fields(cfrom, cto, grid.shape)
    packed = kl.pack_lake_masks(code, mouth, grid, src, dst)
    wA, wvis, wroot, st = kl.relax_solve_twin(
        packed, tf.cell_area_lower_edge(grid, "cpu"), src, dst, grid,
        want_root=True)
    assert st == {"sweeps": sweeps} and sweeps % 64 == 0
    assert torch.equal(A.view(torch.int32), wA.view(torch.int32))
    assert torch.equal(vis, wvis) and torch.equal(root, wroot.long())
