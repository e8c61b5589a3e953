"""The block schedule of the packed direction kernel (csrc/directions.cu,
K6's packed form), in numpy.

The CUDA kernel cannot run here, so what a block does is transliterated and
held to the plain passes: a block owns a 16 x 128 tile, loads hb and sel of
the tile and a 2-cell halo (rows clamped, columns mod W), codes the tile
and a 1-cell ring around it (here the codes are taken from the plain
direction pass at the ring's clamped rows), and packs each tile cell's
masks from the ring: incoming bits from the neighbours' codes (no pole
wrap: a row beyond the grid drops), outgoing bits from its own code, and
the mouth from the interesting test (hb > 0 and sel != 0) of its 8
pole-wrapped neighbours, the pole rows reading the turned edge row from
device memory.  The result must equal ``pack_masks(code,
incoming_mask(code)[1])`` exactly, on ragged grids, an odd width (the pole
turn by round(W/2)), a grid below a tile and a band that touches no pole;
copies with a known bug must not.
"""

import math

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.core.topology import shift
from demiurge_tpu_torch.kernels import directions as kd
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.ops import flow as tf

torch.set_num_threads(2)

PI = math.pi
SCAN = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1), (0, -1),
        (-1, -1))
TY, TX = kd.TILE

GRIDS = {"128x64": (128, 64, None), "96x48": (96, 48, None),
         "255x128": (255, 128, None), "64x12": (64, 12, None),
         "2000x1000": (2000, 1000, None),
         "band-128x64": (128, 64, (-1.0, 0.9, -PI, PI))}


def _case(name, seed=3):
    """(grid, hb, sel, plain codes) of a smooth random terrain with land
    on both pole rows, and a selection with holes (some on the pole
    rows)."""
    W, H, coords = GRIDS[name]
    grid = Grid(W, H) if coords is None else Grid(W, H, coords)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    h = (h + 0.05) * 20
    sel = np.ones((H, W), np.float32)
    sel[:, 5:9] = 0.0
    sel[0, W // 3:W // 3 + 7] = 0.0
    sel[-1, W // 5:W // 5 + 5] = 0.0
    hb = tf.blur(torch.from_numpy(h), grid, 0.5)
    code = kd.flow_directions_plain(hb, torch.from_numpy(sel), grid)
    return grid, hb.numpy(), sel, code


def _packed_schedule(grid, hb, sel, code, bug=None):
    """The packed kernel's blocks, one tile at a time, as numpy."""
    H, W = grid.shape
    turn_s, turn_n, wrap = kd.pole_turns(grid)
    if bug == "no pole turn":
        turn_s = turn_n = 0
    elif bug == "floor turn" and turn_s:
        turn_s = turn_n = W // 2
    out = np.zeros((H, W), np.int32)
    for r0 in range(0, H, TY):
        for c0 in range(0, W, TX):
            halo = np.ix_(np.clip(np.arange(r0 - 2, r0 + TY + 2), 0, H - 1),
                          np.mod(np.arange(c0 - 2, c0 + TX + 2), W))
            sh, ss = hb[halo], sel[halo]
            ring = code[np.ix_(np.clip(np.arange(r0 - 1, r0 + TY + 1), 0,
                                       H - 1),
                               np.mod(np.arange(c0 - 1, c0 + TX + 1), W))]
            ty, tx = min(TY, H - r0), min(TX, W - c0)
            r = np.arange(r0, r0 + ty)[:, None]
            c = np.arange(c0, c0 + tx)[None, :]
            own = ring[1:1 + ty, 1:1 + tx]
            bits = np.zeros((ty, tx), np.int32)
            open_ = np.zeros((ty, tx), bool)
            for k, (dx, dy) in enumerate(SCAN):
                rn = r + dy
                row_ok = (rn >= 0) & (rn < H)
                if wrap:
                    col_ok = np.ones_like(c, bool)
                else:
                    col_ok = c < W - dx if dx > 0 else c >= -dx
                nb = ring[1 + dy:1 + dy + ty, 1 + dx:1 + dx + tx]
                keep = col_ok if bug == "rows beyond kept" else \
                    row_ok & col_ok
                bits |= np.where(keep & (nb == 5 - dx - 3 * dy), 1 << k, 0)
                bits |= np.where(row_ok & (own == 5 + dx + 3 * dy),
                                 1 << (8 + k), 0)
                nh = sh[2 + dy:2 + dy + ty, 2 + dx:2 + dx + tx]
                ns = ss[2 + dy:2 + dy + ty, 2 + dx:2 + dx + tx]
                edge = np.where(rn < 0, 0, H - 1)
                gc = np.mod(c + dx + np.where(rn < 0, turn_s, turn_n), W)
                nh = np.where(row_ok, nh, hb[edge, gc])
                ns = np.where(row_ok, ns, sel[edge, gc])
                open_ |= ~((nh > 0) & (ns != 0))
            bits |= np.where((own != 0) & open_, 1 << 16, 0)
            out[r0:r0 + ty, c0:c0 + tx] = bits
    return out


def _want(grid, code):
    _, mouth, _ = tf.incoming_mask(code, grid)
    return kf.pack_masks(code, mouth, grid).numpy()


@pytest.mark.parametrize("name", list(GRIDS))
def test_packed_schedule_equals_pack_masks(name):
    grid, hb, sel, code = _case(name)
    want = _want(grid, code)
    got = _packed_schedule(grid, hb, sel, code.numpy())
    np.testing.assert_array_equal(got, want)
    mouths = (want >> 16) & 1
    assert mouths.any()
    if grid.wrap_south:  # the pole rows' mouths read across the pole
        assert mouths[0].any() and mouths[-1].any()


@pytest.mark.parametrize("bug", ["no pole turn", "floor turn",
                                 "rows beyond kept"])
def test_packed_schedule_with_a_known_bug_fails(bug):
    """Each bug shows on some grid: the pole neighbours read without the
    column turn, turned by W // 2 at odd W, or incoming bits kept from
    the ring rows beyond the grid."""
    failed = []
    for name in GRIDS:
        if name == "2000x1000":
            continue  # the small grids suffice; keeps the test fast
        grid, hb, sel, code = _case(name)
        got = _packed_schedule(grid, hb, sel, code.numpy(), bug=bug)
        if not np.array_equal(got, _want(grid, code)):
            failed.append(name)
    assert failed, bug
    if bug == "floor turn":
        assert failed == ["255x128"]


def _interesting_mouth(hb, sel, grid):
    """mouth = interesting & OR over the 8 pole-wrapped neighbours of (not
    interesting): no codes needed."""
    closed = ~((hb > 0.0) & (sel != 0.0))
    any_closed = torch.zeros_like(closed)
    for dx, dy in SCAN:
        any_closed = any_closed | shift(closed, dx, dy, grid)
    return ~closed & any_closed


@pytest.mark.parametrize("name", list(GRIDS))
def test_interesting_mouth_equals_incoming_mask(name):
    grid, hb, sel, code = _case(name)
    _, mouth, interesting = tf.incoming_mask(code, grid)
    hb_t, sel_t = torch.from_numpy(hb), torch.from_numpy(sel)
    assert torch.equal(interesting, (hb_t > 0) & (sel_t != 0))
    assert torch.equal(_interesting_mouth(hb_t, sel_t, grid), mouth)


def test_pole_turns():
    assert kd.pole_turns(Grid(255, 128)) == (128, 128, 1)
    assert kd.pole_turns(Grid(256, 128)) == (128, 128, 1)
    assert kd.pole_turns(Grid(128, 64, (-1.0, 0.9, -PI, PI))) == (0, 0, 1)
    assert kd.pole_turns(Grid(64, 1)) == (0, 0, 1)
