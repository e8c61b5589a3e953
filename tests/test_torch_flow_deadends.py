"""The reference's alternative flow solvers (kernels/flow_deadends.py, K11a-d)
against the reference.

The reference's inputs (fBm seed 7, 4 octaves, pre-blur 0.5, at 256x128,
as tests/test_pallas.py makes them) cross to the port as numpy arrays, and
the port's plain twins run on the CPU.  Tolerances, and why:

- K11a, b and d against the reference's ``flow_solve_stencil``: A bit for
  bit and vis exactly; the fixpoint is unique, and the skip rules only
  change which cells a sweep visits;
- K11b against the reference's ``flow_solve_fused`` (interpret mode): A bit
  for bit and vis exactly, in all three modes;
- K11c against the reference's ``flow_solve_wave`` (interpret mode) and
  ``flow_solve_stencil``: A within rtol 1e-5, atol 1e-7 (the reference's
  own bound: the wave adds arrivals in hop order, and the reference's
  bands group them differently again), vis exactly.

The CUDA kernels cannot run here.  A numpy transliteration of their
schedule (in-place sweeps, rows in a random order, under the same skip
rules) is held to the stencil fixpoint instead: it is what checks the
argument in csrc/flow_deadends.cu.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic import flow_deadends as jd
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import flow as jf
from demiurge_tpu.ops.blur import blur as jblur
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu.pallas_kernels import flow as jpf
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.kernels import flow as kf
from demiurge_tpu_torch.kernels import flow_deadends as kd

torch.set_num_threads(2)

SCAN = ((1, 1), (0, 1), (-1, 1), (1, 0), (-1, 0), (1, -1), (0, -1),
        (-1, -1))


@pytest.fixture(scope="module")
def case():
    """The reference's inputs and fixpoint, and the port's packed masks."""
    jg = JGrid(256, 128)
    h = fbm(jg, NoiseParams(mode="default", octaves=4, scale=2.0, min=-2.0,
                            max=3.0, seed=7))
    hb = jblur(h, jg, 0.5)
    code = jf.flow_directions(hb, jnp.ones(jg.shape, jnp.float32), jg)
    _, mouth, _ = jf.incoming_mask(code, jg)
    area = jf.cell_area_lower_edge(jg)
    A0, vis0, _ = jf.flow_solve_stencil(code, area, mouth, jg)
    tg = TGrid(256, 128)
    t = {name: torch.from_numpy(np.array(x)) for name, x in
         (("code", code), ("mouth", mouth), ("area", area))}
    packed = kf.pack_masks(t["code"], t["mouth"], tg)
    return {"jgrid": jg, "grid": tg, "code": code, "jmouth": mouth,
            "jarea": area, "A": np.asarray(A0), "vis": np.asarray(vis0),
            "packed": packed, "area": t["area"], "mouth": t["mouth"]}


def _port_case(W, H, seed=2):
    """(grid, packed masks, area) of a smooth random terrain, through the
    port's own direction pass."""
    from demiurge_tpu_torch.ops import flow as tf

    tg = TGrid(W, H)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(4):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    code = tf.flow_directions(torch.from_numpy((h + 0.1) * 10),
                              torch.ones(H, W), tg)
    _, mouth, _ = tf.incoming_mask(code, tg)
    area = tf.cell_area_lower_edge(tg, "cpu")
    return tg, kf.pack_masks(code, mouth, tg), area


def _hold_exact(case, A, vis):
    np.testing.assert_array_equal(A.numpy(), case["A"])
    np.testing.assert_array_equal(vis.numpy(), case["vis"])


def test_picks_match_the_reference():
    for H in (1024, 512, 192, 96, 100):
        assert kd.pick_band(H) == jpf._pick_band(H)
        for W in (2048, 768, 384, 200):
            assert kd.pick_tiles(H, W) == jd._pick_tiles(H, W)


@pytest.mark.parametrize("band,k", [(64, 16), (16, 8), (32, 1)])
def test_banded_rounds_twin_reaches_the_stencil_fixpoint(case, band, k):
    A, vis, st = kd.flow_solve_banded_rounds(case["packed"], case["area"],
                                             case["grid"], band, k)
    _hold_exact(case, A, vis)
    assert st["sweeps"] == st["rounds"] * k and st["launches"] == 0
    assert st["active"][0] == 128 // band
    assert st["band_runs"] == sum(st["active"]) < st["rounds"] * 128 // band


def test_2d_tiles_twin_reaches_the_stencil_fixpoint(case):
    A, vis, st = kd.flow_solve_2d(case["packed"], case["area"], case["grid"],
                                  k=8)
    _hold_exact(case, A, vis)
    assert st["tiles"] == jd._pick_tiles(128, 256) == (128, 256)
    assert st["tile_runs"] == st["rounds"] and st["sweeps"] == 8 * st["rounds"]


def test_2d_tiles_twin_skips_quiet_tiles():
    """At 1536x384 the reference's tiles are 128x512, 3x3 of them, so the
    3x3 neighbourhood rule (x wraps, y clips) leaves the far row of tiles
    out once the activity has narrowed (fBm, 4 octaves: long rivers); the
    fixpoint is still K7's and K8's."""
    from demiurge_tpu_torch.ops.noise import NoiseParams
    from demiurge_tpu_torch.ops.noise import fbm as tfbm
    from demiurge_tpu_torch.tools import flow_inputs

    grid = TGrid(1536, 384)
    packed, area = flow_inputs(tfbm(grid, NoiseParams(
        octaves=4, scale=2.0, min=-2.0, max=3.0, seed=7), "cpu"), grid)
    A, vis, st = kd.flow_solve_2d(packed, area, grid, k=8)
    # one sweep that changes nothing certifies the fixpoint, which is
    # unique (the flow graph is acyclic): K7's A and K8's vis
    A1, vis1 = kd._PlainSweep(packed, area, grid)(A, vis)
    assert torch.equal(A1, A) and torch.equal(vis1, vis)
    assert st["tiles"] == (128, 512)
    assert st["tile_runs"] < 9 * st["rounds"]


@pytest.mark.parametrize("mode", ["both", "A", "vis"])
def test_fused_twin_matches_pallas_interpret(case, mode):
    """The reference kernel itself (interpret mode), bit for bit, and the
    stencil fixpoint for the halves the mode solves."""
    jA, jvis = jd.flow_solve_fused(case["code"], case["jarea"],
                                   case["jmouth"], case["jgrid"], band=64,
                                   narrow=384, mode=mode, interpret=True)
    A, vis, st = kd.flow_solve_fused(case["packed"], case["area"],
                                     case["grid"], band=64, narrow=384,
                                     mode=mode)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    if mode != "vis":
        np.testing.assert_array_equal(A.numpy(), case["A"])
    if mode != "A":
        np.testing.assert_array_equal(vis.numpy(), case["vis"])
    assert st["rounds"] >= 1 and st["sweeps"] <= st["rounds"] * 16
    assert st["band_visits"] >= st["narrow_visits"]


@pytest.mark.parametrize("narrow", [96, 1])
def test_fused_twin_windows_reach_the_fixpoint(case, narrow):
    """Narrow windows in many visits (96 columns) and in none (1 column:
    a window is at least 2k + 1 wide)."""
    A, vis, st = kd.flow_solve_fused(case["packed"], case["area"],
                                     case["grid"], k=4, band=16,
                                     narrow=narrow)
    _hold_exact(case, A, vis)
    assert (st["narrow_visits"] > 0) == (narrow > 1)


def test_wave_twin_matches_pallas_interpret(case):
    jA, jvis, jstats = jd.flow_solve_wave(case["code"], case["jarea"],
                                          case["jmouth"], case["jgrid"],
                                          interpret=True, with_stats=True)
    A, vis, st = kd.flow_solve_wave(case["packed"], case["area"],
                                    case["grid"])
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(vis.numpy(), case["vis"])
    for want in (np.asarray(jA), case["A"]):
        np.testing.assert_allclose(A.numpy(), want, rtol=1e-5, atol=1e-7)
    differ = int((A.numpy() != np.asarray(jA)).sum())
    print(f"wave: {differ} of {A.numel()} A cells differ from the "
          f"reference's wave, {int((A.numpy() != case['A']).sum())} from "
          f"the stencil; port {st}, reference (rounds, sweeps) "
          f"{np.asarray(jstats).tolist()}")
    assert st["sweeps"] > 1 and st["rounds"] >= 1


def test_activity_rules():
    assert kd.active_bands([0, 0, 0, 0]) == []
    assert kd.active_bands([7, 0, 0, 0]) == [0, 1]
    assert kd.active_bands([0, 2, 0, 0]) == [0]      # low edge wakes b-1
    assert kd.active_bands([0, 4, 0, 0]) == [2]      # high edge wakes b+1
    assert kd.active_bands([0, 1, 0, 5]) == [1, 3]
    f = np.zeros((3, 4), np.int32)
    f[0, 0] = 1
    act = kd.tile_activity(f)
    np.testing.assert_array_equal(act, [[1, 1, 0, 1], [1, 1, 0, 1],
                                        [0, 0, 0, 0]])
    windows, n = kd.plan_windows([(10, 12), (-1, -1), (-1, -1)], 100, 2,
                                 20)
    assert windows == [(0, 8, 7), (1, 8, 7)] and n == 2
    windows, _ = kd.plan_windows([(0, 5), (-1, -1)], 100, 4, 20)
    assert windows == [(0, 96, 14), (1, 96, 14)]       # wraps the seam
    windows, n = kd.plan_windows([(0, 90), (-1, -1)], 100, 4, 20)
    assert windows == [(0, 0, 100), (1, 0, 100)] and n == 0


def test_band_flags():
    changed = torch.zeros(32, 8, dtype=torch.bool)
    changed[0, 3] = changed[15, 1] = changed[21, 0] = True
    assert kd.band_flags(changed, 8, 2) == [3, 5, 1, 0]


# ---------------------------------------------------------------------------
# the CUDA schedule, transliterated
# ---------------------------------------------------------------------------


def _in_place_rounds(packed, area, rule, order_seed, k):
    """In-place sweeps of (A, vis), rows in a random order each sweep, and
    rounds of k sweeps over the cells ``rule(changed_last_round)`` selects
    (None: the first round, every cell), until a round changes nothing."""
    p = packed.numpy()
    area = area.numpy()
    H, W = p.shape
    A, vis = area.copy(), ((p >> 16) & 1).astype(bool)
    rng = np.random.default_rng(order_seed)
    cols = np.arange(W)
    mask = rule(None)
    for _ in range(H * W):
        changed = np.zeros((H, W), bool)
        for _ in range(k):
            for r in rng.permutation(H):
                if not mask[r].any():
                    continue
                acc = area[r].copy()
                v = vis[r].copy()
                for i, (dx, dy) in enumerate(SCAN):
                    rr = min(max(r + dy, 0), H - 1)
                    on = (p[r] >> i) & 1 == 1
                    acc = np.where(on, acc + A[rr, (cols + dx) % W],
                                   acc).astype(np.float32)
                    out = (p[r] >> (8 + i)) & 1 == 1
                    v = v | (out & vis[rr, (cols + dx) % W])
                acc = np.where(mask[r], acc, A[r])
                v = np.where(mask[r], v, vis[r])
                changed[r] |= (acc.view(np.int32) != A[r].view(np.int32)) \
                    | (v != vis[r])
                A[r], vis[r] = acc, v
        if not changed.any():
            return A, vis
        mask = rule(changed)
    raise AssertionError("no fixpoint")


def _banded_rule(H, W, band, k):
    def rule(changed):
        if changed is None:
            return np.ones((H, W), bool)
        flags = kd.band_flags(torch.from_numpy(changed), band, k)
        rows = np.isin(np.arange(H) // band, kd.active_bands(flags))
        return np.broadcast_to(rows[:, None], (H, W))
    return rule


def _window_rule(H, W, band, k, narrow):
    def rule(changed):
        if changed is None:
            return np.ones((H, W), bool)
        per_band = changed.reshape(H // band, band, W).any(1)
        prev = [(int(np.flatnonzero(c).min()), int(np.flatnonzero(c).max()))
                if c.any() else (W, -1) for c in per_band]
        mask = np.zeros((H, W), bool)
        for b, start, n in kd.plan_windows(prev, W, k, narrow)[0]:
            mask[b * band:(b + 1) * band, (start + np.arange(n)) % W] = True
        return mask
    return rule


def _tile_rule(H, W, ty, tx, reach=1):
    """K11a's rule: the tiles of whose 3x3 tile neighbourhood (x wraps, y
    clips) changed; ``reach`` 0 is a wrong rule, a tile's own flag only."""
    def rule(changed):
        if changed is None:
            return np.ones((H, W), bool)
        flags = changed.reshape(H // ty, ty, W // tx, tx).any(axis=(1, 3))
        act = kd.tile_activity(flags) if reach else flags
        return act.repeat(ty, 0).repeat(tx, 1)
    return rule


@pytest.mark.parametrize("rule", ["banded", "windows", "tiles"])
@pytest.mark.parametrize("order_seed", [0, 1])
def test_in_place_schedule_with_skips_reaches_the_fixpoint(rule, order_seed):
    """The kernels' schedule (in-place, any row order) under the band,
    window and 3x3 tile skip rules certifies K7's A bit for bit and K8's
    vis.  The tiles are 8x8 of (8, 16) with one sweep a round, a case where
    the rule skips quiet tiles and a tile's own flag alone would stop
    short."""
    W, H = (128, 64) if rule == "tiles" else (64, 32)
    tg, packed, area = _port_case(W, H)
    chosen, k = {"banded": (_banded_rule(H, W, 8, 2), 2),
                 "windows": (_window_rule(H, W, 8, 2, 12), 2),
                 "tiles": (_tile_rule(H, W, 8, 16), 1)}[rule]
    A, vis = _in_place_rounds(packed, area, chosen, order_seed, k=k)
    want_A = kf.flow_solve_area_plain(packed, area, tg).numpy()
    np.testing.assert_array_equal(A, want_A)
    np.testing.assert_array_equal(vis, kf.vis_solve_plain(packed, tg).numpy())
    if rule == "tiles":
        A_own, _ = _in_place_rounds(packed, area, _tile_rule(H, W, 8, 16, 0),
                                    order_seed, k=k)
        assert not np.array_equal(A_own, want_A)


def test_cpu_tensors_take_the_twins(case):
    counts = (kd.LAUNCHES_BANDED, kd.LAUNCHES_2D, kd.LAUNCHES_FUSED,
              kd.LAUNCHES_WAVE)
    _, _, st = kd.flow_solve_banded_rounds(case["packed"], case["area"],
                                           case["grid"], 64, 16)
    assert st["launches"] == 0
    assert (kd.LAUNCHES_BANDED, kd.LAUNCHES_2D, kd.LAUNCHES_FUSED,
            kd.LAUNCHES_WAVE) == counts
    with pytest.raises(ValueError, match="band"):
        kd.flow_solve_fused(case["packed"], case["area"], case["grid"],
                            band=48)
    with pytest.raises(ValueError, match="mode"):
        kd.flow_solve_fused(case["packed"], case["area"], case["grid"],
                            mode="AB")
    with pytest.raises(ValueError, match="tiles"):
        kd.flow_solve_2d(case["packed"][:100], case["area"][:100],
                         TGrid(256, 100))
