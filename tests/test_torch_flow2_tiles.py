"""The schedule of the two-level flow kernels K10a and K10b (csrc/flow.cu),
in numpy.

The CUDA kernels cannot run here, so their schedule is transliterated and
held to the plain twins' fixpoints bit for bit (``flow_local_solve_plain``'s
A and exit ids, ``flow_local_vis_plain``'s vis).  The rounds are K7/K8's
(``tests/test_torch_flow_tiles.py`` ``_rounds``: tiles woken by the edge
bits of their neighbours' writes, "concurrent" and "in place" variants, a
round that writes nothing ends the solve); the visits are K10's:

- A: K7's visit as it stands, on the masked masks (``mask_local``);
- exit ids: every cell of the halo'd tile points at its target, the ends
  pinned (a crossing cell at its own id, a cell without an out bit at -1,
  halo cells at E as loaded); the pointers jump until each is at an end,
  then every cell takes its end's id;
- vis: K8's pointer jumping with the crossing cells as ends.

Tiles of 16 rows (the kernels') span several bands of 2 and 8 rows, or
parts of a band of 32; the grids are ragged (the tile divides neither W
nor H) or one tile wide.  Two wrong rules must miss the fixpoint: exit-id
tiles woken by their own writes only, and crossing cells left unpinned.
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import flow2 as k2
from test_torch_flow_tiles import SCAN, _jump, _port_case, _rivers, \
    _rounds, _tile_rounds

torch.set_num_threads(2)

TILE = (16, 16, 4)  # rows (the kernels'), columns, strip columns
NEG_OUT, POS_OUT = 0xE0, 0x07  # out bits to dy = -1, to dy = +1


def _exit_jump(local, outs, real, cross, selfid):
    """K10a's exit-id visit on the halo'd tile ``local`` (int): ends
    pinned, the pointers jump, all at once, until each is at an end; then
    every cell of the grid takes its end's id.  Returns the passes."""
    ty, tx = outs.shape
    cross = cross != 0
    flat = local.reshape(-1)
    q = (np.arange(1, ty + 1)[:, None] * (tx + 2)
         + np.arange(1, tx + 1)[None, :])
    flat[q[real & cross]] = selfid[real & cross]
    flat[q[real & (outs == 0)]] = -1
    nxt = np.arange(flat.size)
    for k, (dx, dy) in enumerate(SCAN):
        on = real & ~cross & ((outs >> k) & 1 == 1)
        nxt[q[on]] = q[on] + dy * (tx + 2) + dx
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


def _layout(ploc, band):
    """(out bits, crossing cells, own ids) of the grid, numpy."""
    p = ploc.numpy()
    H, W = p.shape
    rl = np.arange(H)[:, None] % band
    outs = (p >> 8) & 0xFF
    cross = ((rl == 0) & ((outs & NEG_OUT) != 0)) \
        | ((rl == band - 1) & ((outs & POS_OUT) != 0))
    cols = np.arange(W)[None, :]
    return outs, cross, np.where(rl == 0, cols, W + cols).astype(np.int64)


def _exit_rounds(ploc, band, variant, order_seed, own_only=False,
                 pinned=True):
    outs, cross, selfid = _layout(ploc, band)
    if not pinned:
        cross = np.zeros_like(cross)

    def visit(local, cells, real, rng):
        return _exit_jump(local, cells(outs), real, cells(cross),
                          cells(selfid))

    start = np.full(outs.shape, -1, np.int64)
    return _rounds(start, visit, TILE[:2], variant, order_seed, own_only)


def _vis_rounds(ploc, seed, band, variant, order_seed, pinned=True):
    outs, cross, _ = _layout(ploc, band)
    ends = np.where(cross, 0, outs) if pinned else outs

    def visit(local, cells, real, rng):
        return _jump(local, cells(ends), real)

    start = (((ploc.numpy() >> 16) & 1) != 0) | (seed != 0)
    return _rounds(start, visit, TILE[:2], variant, order_seed)


def _boundary_seed(shape, band):
    """Resolved-reachability seeds on the bands' first and last rows, as
    the sharded solve scatters them."""
    seed = np.zeros(shape, np.float32)
    seed[band - 1::band, ::7] = 1.0
    seed[band::band, 3::11] = 1.0
    return seed


def _hold_to_twins(W, H, band, variant, order_seeds=(0,)):
    grid, packed, area = _port_case(W, H)
    ploc = k2.mask_local(packed, band)
    wA, wE = k2.flow_local_solve_plain(ploc, area, area, band)
    warm = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 2, (H, W)).astype(np.float32))
    wA2, _ = k2.flow_local_solve_plain(ploc, area, warm, band,
                                       with_exit=False)
    assert torch.equal(wA, wA2)
    for order_seed in order_seeds:
        for a0, want in ((area, wA), (warm, wA2)):
            A, st = _tile_rounds(ploc, a0.numpy(), area.numpy(), TILE,
                                 variant, order_seed)
            np.testing.assert_array_equal(A, want.numpy())
        E, se = _exit_rounds(ploc, band, variant, order_seed)
        np.testing.assert_array_equal(E, wE.numpy())
        for seed in (np.zeros((H, W), np.float32),
                     _boundary_seed((H, W), band)):
            want = k2.flow_local_vis_plain(ploc, torch.from_numpy(seed),
                                           band).numpy()
            vis, sv = _vis_rounds(ploc, seed, band, variant, order_seed)
            np.testing.assert_array_equal(vis, want != 0)
            assert set(np.unique(want)) <= {0.0, 1.0}
        for s in (st, se, sv):
            assert s["rounds"] >= 2 and s["max_inner_sweeps"] >= 2
    _, cross, _ = _layout(ploc, band)
    assert cross.any() and (wE.numpy() >= 0).any() \
        and (wE.numpy() == -1).any()


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
@pytest.mark.parametrize("band", [2, 8, 32])
def test_k10_schedule_reaches_the_twins_fixpoints(band, variant):
    """A (cold and warm), the exit ids and vis (zero and boundary seeds)
    bit for bit on a 70x64 grid, ragged in x: tiles of 16 rows hold 8
    bands of 2, 2 bands of 8, or half a band of 32."""
    _hold_to_twins(70, 64, band, variant)


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
@pytest.mark.parametrize("name", ["ragged", "one-column"])
def test_k10_schedule_on_ragged_and_narrow_grids(name, variant):
    """The same at band 8, two visit orders: 70x40 (the last tile row
    holds one band), and 12x48 (one tile column, whose halo columns are
    its own cells)."""
    W, H = (70, 40) if name == "ragged" else (12, 48)
    _hold_to_twins(W, H, 8, variant, order_seeds=(0, 1))


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
def test_k10_schedule_with_a_wrong_rule_stops_short(variant):
    """Two wrong rules miss the twins' fixpoint where the right ones reach
    it.  A river runs down column 10 from row 2 to row 42 of a 70x64
    grid; at band 32 it leaves its band at row 31.  The first tile row
    (rows 0-15) holds no crossing cell, so its exit ids start right at -1
    and it writes nothing in the first round: woken by its own writes
    only, it never learns the id that reaches it across its bottom edge.
    On a terrain at band 8, crossing cells left unpinned follow their out
    bit into the next band, for the exit ids and for vis."""
    grid = Grid(70, 64)
    river, river_area = _rivers(grid, [(2, 10, (0, 1), 40)])
    ploc = k2.mask_local(river, 32)
    _, wE = k2.flow_local_solve_plain(ploc, river_area, river_area, 32)
    assert (wE[2:32, 10] == 70 + 10).all()
    E, _ = _exit_rounds(ploc, 32, variant, 0)
    np.testing.assert_array_equal(E, wE.numpy())
    E_own, _ = _exit_rounds(ploc, 32, variant, 0, own_only=True)
    assert not np.array_equal(E_own, wE.numpy())

    _, packed, area = _port_case(70, 64)
    band = 8
    ploc = k2.mask_local(packed, band)
    _, wE = k2.flow_local_solve_plain(ploc, area, area, band)
    seed = np.zeros(packed.shape, np.float32)
    wvis = k2.flow_local_vis_plain(ploc, torch.from_numpy(seed), band)
    vis, _ = _vis_rounds(ploc, seed, band, variant, 0)
    np.testing.assert_array_equal(vis, wvis.numpy() != 0)
    E_loose, _ = _exit_rounds(ploc, band, variant, 0, pinned=False)
    assert not np.array_equal(E_loose, wE.numpy())
    vis_loose, _ = _vis_rounds(ploc, seed, band, variant, 0, pinned=False)
    assert not np.array_equal(vis_loose, wvis.numpy() != 0)
