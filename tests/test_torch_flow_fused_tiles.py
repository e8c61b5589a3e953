"""The schedule of the persistent K11b (csrc/flow_deadends.cu fused_tiles_kernel), in numpy.

The CUDA kernel cannot run here, so its schedule is transliterated and
held to the twin's fixpoint (``flow_solve_fused_plain``: A bit for bit,
vis exactly, in modes "both", "A" and "vis").  It reuses K7's and K8's
visits from tests/test_torch_flow_tiles.py (the kernel reuses theirs from
csrc/flow_tiles.cuh).  An entry is a (field, tile) pair, A's and, in mode
"both", vis's:

- round 0's list holds every entry; a block takes any entry of a round's
  list, so the visits run in a random order, in the two models of what
  concurrent blocks see ("concurrent": the round-start state, "in place":
  what the visits before left);
- a visit solves its field of its tile, A by K7's relaxation or vis by
  K8's pointer jumping, and writes back the cells that changed;
- the visit pushes each edge bit of its writes to the same field's entry
  of the tile whose halo it faces (x wraps, y clips); the push that turns
  an entry's wake word from 0 appends it to the next round's list (and
  the pushed set is exactly the set K7's pull, ``_woke``, would wake);
- the device stop rule: the solve ends when the next round's list is
  empty; at the round limit it raises.

A wake rule that drops one field's writes must stop that field short of
its fixpoint.
"""

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.kernels import flow_deadends as kd
from test_torch_flow_tiles import (BL, BOTTOM, BR, LEFT, RIGHT, ROW_FEED,
                                   TL, TOP, TR, _case, _edge_bits, _jump,
                                   _port_case, _relax, _woke)

torch.set_num_threads(2)

# (bit, tile rows down, tile columns right): the tile each edge bit faces,
# in the order the kernel's wake_facing pushes them
FACING = ((BOTTOM, 1, 0), (TOP, -1, 0), (RIGHT, 0, 1), (LEFT, 0, -1),
          (BR, 1, 1), (BL, 1, -1), (TR, -1, 1), (TL, -1, -1))


def fused_rounds(packed, area, tile, mode, variant, order_seed,
                 wake_from=("A", "vis"), max_rounds=None):
    """K11b's rounds in numpy: (A, vis, stats).  ``wake_from``: the fields
    whose writes push their edge bits (the kernel: both)."""
    p = packed.numpy()
    area = area.numpy()
    H, W = p.shape
    ty, tx, strip = tile
    nby, nbx = -(-H // ty), -(-W // tx)
    nt = nby * nbx
    fields = ("A", "vis") if mode == "both" else (mode,)
    pad_r = np.arange(-1, nby * ty + 1)
    pad_c = np.arange(-1, nbx * tx + 1) % W
    state = {"A": area.copy(), "vis": ((p >> 16) & 1).astype(bool)}
    rng = np.random.default_rng(order_seed)
    limit = H * W + 1 if max_rounds is None else max_rounds
    todo = list(range(len(fields) * nt))  # entry f * nt + tile
    rounds, visits, most = 0, 0, 0
    while todo:
        if rounds >= limit:
            raise RuntimeError(f"no fixpoint after {rounds} rounds")
        rounds += 1
        src = {k: v.copy() for k, v in state.items()} \
            if variant == "concurrent" else state
        wake = np.zeros(len(fields) * nt, int)
        nxt = []
        edges = np.zeros((len(fields), nby, nbx), int)
        for e in rng.permutation(todo):
            f, t = divmod(int(e), nt)
            name = fields[f]
            i, j = divmod(t, nbx)
            r = pad_r[i * ty:(i + 1) * ty + 2]
            c = pad_c[j * tx:(j + 1) * tx + 2]
            ok = (r >= 0) & (r < H)
            rr, cc = r[1:-1], np.arange(j * tx, (j + 1) * tx)
            real = ((rr >= 0) & (rr < H))[:, None] & (cc < W)[None, :]
            inner = np.ix_(np.clip(rr, 0, H - 1), np.minimum(cc, W - 1))

            def cells(a):
                return np.where(real, a[inner], 0)

            field = state[name]
            local = np.zeros((ty + 2, tx + 2), field.dtype)
            local[ok] = src[name][r[ok]][:, c]
            before = local[1:-1, 1:-1].copy()
            if name == "A":
                passes = _relax(local, cells(p & 0xFF),
                                cells((p >> 8) & ROW_FEED) != 0, real,
                                cells(area).astype(np.float32), strip, rng)
                after = local[1:-1, 1:-1]
                wrote = real & (after.view(np.int32) != before.view(np.int32))
            else:
                passes = _jump(local, cells((p >> 8) & 0xFF), real)
                after = local[1:-1, 1:-1]
                wrote = real & (after != before)
            most = max(most, passes)
            visits += 1
            if not wrote.any():
                continue
            mr = rr[:, None].repeat(tx, 1)[wrote]
            mc = cc[None, :].repeat(ty, 0)[wrote]
            field[mr, mc] = after[wrote]
            if name not in wake_from:
                continue
            bits = _edge_bits(wrote, min(ty, H - i * ty), min(tx, W - j * tx))
            edges[f, i, j] = bits
            for bit, di, dj in FACING:
                ii = i + di
                if not bits & bit or not 0 <= ii < nby:
                    continue
                nb = f * nt + ii * nbx + (j + dj) % nbx
                if wake[nb] == 0:
                    nxt.append(nb)
                wake[nb] |= bit
        # the push wakes exactly the entries K7's pull would, field by field
        assert sorted(nxt) == [f * nt + int(k) for f in range(len(fields))
                               for k in np.flatnonzero(_woke(edges[f]))]
        todo = nxt
    return state["A"], state["vis"], {"rounds": rounds, "tiles_run": visits,
                                      "max_inner_sweeps": most,
                                      "tiles": nt * len(fields)}


def _ragged_case():
    """A 2000x1000-shaped terrain scaled down by 8 (250x125), through the
    port's own direction pass, with tiles of 16 x 32 that divide neither
    side (the card's 16 x 128 tiles divide neither 2000 nor 1000)."""
    grid, packed, area = _port_case(250, 125, seed=5)
    return grid, packed, area, (16, 32, 8), 25


def _cases(name):
    """(grid, packed, area, (tile rows, columns, strip columns), a band of
    the twin that divides H)."""
    if name == "ragged":
        return _ragged_case()
    grid, packed, area, _, tile = _case(name)
    return grid, packed, area, tile, {"port": 4, "serpentine": 2}[name]


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
@pytest.mark.parametrize("name", ["port", "serpentine", "ragged"])
def test_persistent_rounds_reach_the_twin_fixpoint(name, variant):
    """Every mode, two visit orders: A bit for bit with the twin (and with
    K7's twin), vis exactly (and K8's)."""
    grid, packed, area, tile, band = _cases(name)
    want_A = kf.flow_solve_area_plain(packed, area, grid).numpy()
    want_vis = kf.vis_solve_plain(packed, grid).numpy()
    mouth = ((packed >> 16) & 1).bool().numpy()
    for mode in kd.MODES:
        tA, tvis, _ = kd.flow_solve_fused_plain(packed, area, grid, k=band,
                                                band=band, mode=mode)
        for order_seed in (0, 1):
            A, vis, st = fused_rounds(packed, area, tile, mode, variant,
                                      order_seed)
            np.testing.assert_array_equal(A, tA.numpy())
            np.testing.assert_array_equal(vis, tvis.numpy())
            np.testing.assert_array_equal(
                A, want_A if mode != "vis" else area.numpy())
            np.testing.assert_array_equal(
                vis, want_vis if mode != "A" else mouth)
            assert st["rounds"] >= 2 and st["max_inner_sweeps"] >= 2
            if name == "serpentine":  # the lists skip quiet tiles
                assert st["tiles_run"] < st["rounds"] * st["tiles"]
    assert want_vis.sum() > mouth.sum()


@pytest.mark.parametrize("variant", ["concurrent", "in place"])
@pytest.mark.parametrize("dropped", ["A", "vis"])
def test_a_wake_rule_that_drops_a_field_stops_short(dropped, variant):
    """Mode "both" on the serpentine with one field's writes pushing no
    edge bits: that field's fronts stop at the first tile edge, short of
    its fixpoint, while the other still reaches its own."""
    grid, packed, area, tile, _ = _cases("serpentine")
    want_A = kf.flow_solve_area_plain(packed, area, grid).numpy()
    want_vis = kf.vis_solve_plain(packed, grid).numpy()
    kept = ("vis",) if dropped == "A" else ("A",)
    for order_seed in (0, 1):
        A, vis, _ = fused_rounds(packed, area, tile, "both", variant,
                                 order_seed, wake_from=kept)
        if dropped == "A":
            assert not np.array_equal(A, want_A)
            np.testing.assert_array_equal(vis, want_vis)
        else:
            assert not np.array_equal(vis, want_vis)
            np.testing.assert_array_equal(A, want_A)


def test_the_round_limit_raises():
    """The device stop rule's other exit: a solve that has not certified
    by the round limit raises, and one round more than it needs does
    not."""
    grid, packed, area, tile, _ = _cases("serpentine")
    _, _, st = fused_rounds(packed, area, tile, "both", "in place", 0)
    fused_rounds(packed, area, tile, "both", "in place", 0,
                 max_rounds=st["rounds"])
    with pytest.raises(RuntimeError, match="no fixpoint after"):
        fused_rounds(packed, area, tile, "both", "in place", 0,
                     max_rounds=st["rounds"] - 1)
