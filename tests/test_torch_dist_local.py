"""The port's block-local stages (demiurge_tpu_torch/dist/local.py), the
overlapped halo sweeps and the traffic counters, on gloo process groups.

For each mesh (1x2, 2x1, 2x2 and 1x4, whose nx/2 = 2 puts the antipodal
cap two shards away) one group of CPU processes runs
tests/torch_mesh_worker.py in its ``local`` mode on 128x64 fields made
here from a numpy seed; this process holds the gathered results to the
port's single-device ops on the whole fields, which test_torch_ocean.py,
test_torch_flow.py and the rest hold to the JAX package.  Bounds, and
why:

- every local stage (the departure points, divergence, projection, both
  coefficient builds, the pre-blur with the D8 codes, the mouths and the
  packed masks on row groups, the packed masks on blocks, the erosion
  pass): bit for bit, since each runs the single-device op's own
  arithmetic on the same inputs; the D8 codes' ties (codes that differ)
  are counted and must be 0;
- the overlapped k sweeps: bit for bit against the monolithic order, for
  pressure (k 8), viscosity (k 10 with its remainder round) and a k the
  blocks are too small to split for (k 20); every split round issued its
  centre's sweeps before the exchange's wait;
- the traffic counters: two default ``CoupledConfig`` mesh steps, and an
  ``exact_quirks`` step, make no ``sharded_call`` and no full-field
  gather on any rank;
- a grid that wraps in x but reaches neither pole: the solvers and the
  flow run their stages on blocks and row groups that end at the grid's
  edge rows, with no ``sharded_call``, bit for bit against the
  single-device ops (the viscosity against its one-process mesh: its
  halo rounds read zeros beyond a row edge that does not wrap, as the
  reference's halo solver does, where the single-device sweep clamps);
- a ``Window`` overrides every ``Grid`` method that reads the size.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid, Window
from demiurge_tpu_torch.dist import mesh as dm
from demiurge_tpu_torch.kernels import jacobi as kj
from demiurge_tpu_torch.kernels.flow import pack_masks
from demiurge_tpu_torch.ops import erosion, ocean
from demiurge_tpu_torch.ops import flow as tf
from demiurge_tpu_torch.ops.blur import blur

torch.set_num_threads(2)

W, H = 128, 64
WORKER = pathlib.Path(__file__).with_name("torch_mesh_worker.py")
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
IDS = ["1x2", "2x1", "2x2", "1x4"]
GRID = Grid(W, H)


def _smooth(rng, scale, shift_=0.0, n=6):
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(n):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    return ((h + shift_) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    """Full fields from a seed: terrain (land and sea), currents that are
    zero on land, a pressure-like field, their divergence, a rough
    terrain (its pole rows far from constant after the pre-blur, so that
    what lies beyond a pole moves the codes there) and a selection with a
    hole, the codes and mouths of the terrain, a flow map with undrained
    cells and an uplift."""
    rng = np.random.default_rng(1)
    terrain = _smooth(rng, 20.0, -0.05)
    land = terrain > 0
    u, v = (np.where(land, 0.0, rng.standard_normal((H, W)) * 0.3)
            .astype(np.float32) for _ in range(2))
    tt = torch.from_numpy(terrain)
    div = ocean.divergence(torch.from_numpy(u), torch.from_numpy(v), tt,
                           GRID, ocean.OceanConfig())
    sel = np.ones((H, W), np.float32)
    sel[20:30, 40:70] = 0.0
    hb = blur(tt, GRID, 0.5)
    code = tf.flow_directions(hb, torch.ones_like(hb), GRID)
    _, mouth, _ = tf.incoming_mask(code, GRID)
    fm = np.where(rng.random((H, W)) < 0.8,
                  rng.random((H, W)) * 5, -1.0).astype(np.float32)
    return {"terrain": terrain, "u": u, "v": v,
            "f": _smooth(rng, 3.0), "div": div.numpy(), "sel": sel,
            "rough": (rng.standard_normal((H, W)) * 20).astype(np.float32),
            "code": code.numpy(), "mouth": mouth.numpy().astype(np.float32),
            "fm": fm, "uplift": (rng.random((H, W)) * 0.01).astype(
                np.float32)}


def _run_group(inputs, shape, tmp, mode="local", grid=GRID):
    """Start the NYxNX gloo group in ``mode``; rank 0's results."""
    ny, nx = shape
    meta = {"shape": [W, H], "coords": list(grid.coords)}
    np.savez(tmp / "in.npz", meta=np.asarray(json.dumps(meta)), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / "in.npz"), str(tmp),
         str(ny), str(nx), str(r), mode], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(ny * nx)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return {shape: _run_group(inputs, shape,
                              tmp_path_factory.mktemp(f"local{shape[0]}"
                                                      f"x{shape[1]}"))
            for shape in MESHES}


def _t(inputs, name):
    return torch.from_numpy(inputs[name])


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_local_departure_points_equal_single_device(runs, inputs, shape):
    dep = ocean._departure(_t(inputs, "u"), _t(inputs, "v"), GRID,
                           ocean.OceanConfig())
    for i, want in enumerate(dep):
        np.testing.assert_array_equal(runs[shape][f"dep{i}"],
                                      want.expand(H, W).numpy(),
                                      err_msg=f"output {i}")


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_local_divergence_and_projection_equal_single_device(runs, inputs,
                                                             shape):
    """The velocity halo is negated beyond a pole, as ``_neighbor_vec``
    flips the single-device neighbour there."""
    cfg = ocean.OceanConfig()
    u, v, t = (_t(inputs, k) for k in ("u", "v", "terrain"))
    div = ocean.divergence(u, v, t, GRID, cfg)
    np.testing.assert_array_equal(runs[shape]["div"], div.numpy())
    pu, pv = ocean.project(u, v, _t(inputs, "f"), t, GRID, cfg)
    np.testing.assert_array_equal(runs[shape]["proj_u"], pu.numpy())
    np.testing.assert_array_equal(runs[shape]["proj_v"], pv.numpy())
    assert np.abs(div.numpy()).max() > 0 and (pu != u).any()


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_local_coefficient_builds_equal_single_device(runs, inputs, shape):
    t = _t(inputs, "terrain")
    for i, c in enumerate(kj.coefficients(_t(inputs, "div"), t, GRID)):
        np.testing.assert_array_equal(runs[shape][f"coef{i}"], c.numpy(),
                                      err_msg=f"pressure {i}")
    for i, c in enumerate(kj.diffusion_coefficients(t, GRID)):
        np.testing.assert_array_equal(runs[shape][f"dcoef{i}"], c.numpy(),
                                      err_msg=f"viscosity {i}")


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_row_group_flow_masks_equal_single_device(runs, inputs, shape):
    """The pre-blur, the D8 codes (0 ties), the mouths and the packed
    masks on row groups, against the single-device passes."""
    t, sel = _t(inputs, "rough"), _t(inputs, "sel")
    code = tf.flow_directions(blur(t, GRID, 0.5), sel, GRID)
    _, mouth, _ = tf.incoming_mask(code, GRID)
    out = runs[shape]
    ties = int((out["rows_code"] != code.numpy()).sum())
    assert ties == 0, f"{ties} direction ties"
    np.testing.assert_array_equal(out["rows_mouth"], mouth.numpy())
    np.testing.assert_array_equal(out["rows_packed"],
                                  pack_masks(code, mouth, GRID).numpy())
    assert mouth.any() and (code.numpy() == 0).any() and \
        (code.numpy() == 5).any()


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_block_packed_masks_and_erosion_equal_single_device(runs, inputs,
                                                            shape):
    code, mouth = _t(inputs, "code"), _t(inputs, "mouth") > 0
    np.testing.assert_array_equal(runs[shape]["pack_b"],
                                  pack_masks(code, mouth, GRID).numpy())
    want = erosion.erosion_pass(_t(inputs, "terrain"), _t(inputs, "fm"),
                                _t(inputs, "uplift"), GRID, 1.0, 1.0)
    np.testing.assert_array_equal(runs[shape]["erosion"], want.numpy())


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("solver", ["p", "d", "fb"])
def test_overlapped_sweeps_equal_monolithic(runs, shape, solver):
    """Pressure (k 8, 3 rounds), viscosity (k 10, rounds of 10, 10 and 5
    sweeps) and k 20, which no block here can split (h or w < 4k): the
    split rounds issue the centre before the wait, every one of them."""
    out = runs[shape]
    np.testing.assert_array_equal(out[f"sweep_{solver}_split"],
                                  out[f"sweep_{solver}_mono"])
    h, w = H // shape[0], W // shape[1]
    k = {"p": 8, "d": 10, "fb": 20}[solver]
    splits = 0 if h < 4 * k or w < 4 * k else 3
    for rank_row in out[f"overlap_{solver}"]:
        rounds, split, in_flight = rank_row.tolist()
        assert (rounds, split, in_flight) == ({"fb": 1}.get(solver, 3),
                                              splits, splits)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_default_mesh_steps_gather_no_field(runs, shape):
    """Two default ``CoupledConfig`` mesh steps: 0 ``sharded_call``s and 0
    full-field gathers on every rank (an earlier tree made 8 and 19 a
    step); an ``exact_quirks`` step, whose viscosity runs its sweep on
    the padded blocks, makes none either, and exchanges halos."""
    out = runs[shape]
    kinds = json.loads(str(out["traffic_kinds"]))
    n = 2 + len(kinds)
    for row in out["traffic_default"]:
        one, two = row[:n], row[n:]
        assert one[0] == two[0] == 0 and one[1] == two[1] == 0, row
        assert two[2 + kinds.index("permute")] > one[2 + kinds.index(
            "permute")] > 0
        assert two[2 + kinds.index("gather_field")] == 0
    for row in out["traffic_quirks"]:
        assert row[0] == row[1] == 0, row
        assert row[2 + kinds.index("gather_field")] == 0
        assert row[2 + kinds.index("permute")] > 0


def test_window_tables_are_the_grids_cut():
    """A row window past both poles of a 16-row grid: every table the
    local stages read is the grid's own at the window's global rows
    (reflected past a pole) and columns, bit for bit."""
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.ops.blur import horizontal_taps

    g = Grid(32, 16)
    win = Window(32, 22, g.coords, g.circumference, full=(32, 16), row0=-3)
    rows = np.r_[2, 1, 0, np.arange(16), 15, 14, 13]
    assert (win.rows_np() == rows).all() and win.shape == (22, 32)
    cpu = torch.device("cpu")
    np.testing.assert_array_equal(win.pixelsize_rows(cpu)[0].numpy(),
                                  g.pixelsize_rows(cpu)[0].numpy()[rows])
    for a, b in zip(ocean.stage_tables(win, cpu)[:6],
                    ocean.stage_tables(g, cpu)[:6]):
        b = b.numpy()
        np.testing.assert_array_equal(a.numpy(),
                                      b[rows] if b.shape[0] == 16 else b)
    np.testing.assert_array_equal(
        tf.cell_area_lower_edge(win, cpu).numpy(),
        tf.cell_area_lower_edge(g, cpu).numpy()[rows])
    np.testing.assert_array_equal(tf.tie_break_noise(win, cpu).numpy(),
                                  tf.tie_break_noise(g, cpu).numpy()[rows])
    for a, b in zip(kd.tables(win, cpu), kd.tables(g, cpu)):
        np.testing.assert_array_equal(a.numpy(), b.numpy()[rows])
    for a, b in zip(horizontal_taps(win, 0.3), horizontal_taps(g, 0.3)):
        np.testing.assert_array_equal(a, b[rows])
    for a, b in zip(kb.tables(win, [0.1, 0.2], cpu)[2:4],
                    kb.tables(g, [0.1, 0.2], cpu)[2:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy()[..., rows])
    block = Window(10, 12, g.coords, g.circumference, full=(32, 16),
                   row0=5, col0=-2)
    assert (block.cols_np() == np.r_[30, 31, np.arange(8)]).all()
    np.testing.assert_array_equal(
        ocean.stage_tables(block, cpu).sin_lam.numpy(),
        ocean.stage_tables(g, cpu).sin_lam.numpy()[:, block.cols_np()])
    assert tf._row_in_range(win, -1, cpu)[:4, 0].tolist() == \
        [False, False, False, False]
    assert tf._row_in_range(win, 1, cpu)[-4:, 0].tolist() == \
        [False, False, False, False]


@pytest.mark.parametrize("group", [0, 1, 2, 3])
def test_row_window_blur_equals_the_whole_grids(group):
    """The pre-blur on a row group of 4 with its halo (``dist.local.
    rows_window``), rough terrain: the group's rows bit for bit those of
    the blur of the whole grid.  A group at a pole starts (ends) at the
    pole and reflects there itself: the blur's five passes sum a row's
    taps in one order, so halo rows beyond a pole would evolve as the
    pole's mirror only up to rounding."""
    from demiurge_tpu_torch.dist.local import flow_rows_reach
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.ops.blur import sigma_list

    g = Grid(256, 128)
    h = torch.from_numpy((np.random.default_rng(5).standard_normal(
        g.shape) * 20).astype(np.float32))
    k, r = flow_rows_reach(0.5), 32
    lo, hi = max(group * r - k, 0), min((group + 1) * r + k, 128)
    win = Window(256, hi - lo, g.coords, g.circumference, full=(256, 128),
                 row0=lo)
    assert (win.wrap_south, win.wrap_north) == (group == 0, group == 3)
    rlist = sigma_list(0.5)
    got = kb.blur_plain(h[lo:hi], win, rlist)
    want = kb.blur_plain(h, g, rlist)
    own = slice(group * r - lo, group * r - lo + r)
    assert torch.equal(got[own], want[group * r:(group + 1) * r])


def test_one_process_overlap_splits_only_when_asked():
    """On a one-process group nothing is in flight: the solvers keep the
    monolithic order (no split round), and a forced split equals it bit
    for bit, its centre issued before the exchange's wait."""
    import torch.distributed as dist

    from demiurge_tpu_torch.dist import halo

    g = Grid(64, 32)
    rng = np.random.default_rng(3)
    terrain = torch.from_numpy(rng.standard_normal(g.shape).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal(g.shape).astype(np.float32))
    dm.initialize("cpu")
    try:
        mesh = dm.make_mesh(device="cpu")
        halo.pressure_solve_sharded(u, terrain, g, mesh, iters=16)
        assert halo.LAST_OVERLAP["rounds"] == 2
        assert halo.LAST_OVERLAP["split"] == 0
        coeffs = kj.diffusion_coefficients(terrain, g)
        padded = halo._padded_coefficients(coeffs, 4, g, mesh) + (
            torch.zeros(40, 72),)
        halo.LAST_OVERLAP.update(split=0, in_flight=0)
        mono = halo._ksweeps(u, 4, padded, lambda q: halo.exchange_halo(
            q, 4, g, mesh, negate_pole=True))
        split = halo._overlapped_ksweeps(u, 4, padded, lambda q: (
            halo.post_halo(q, 4, g, mesh, negate_pole=True)), split=True)
        assert torch.equal(mono, split)
        assert halo.LAST_OVERLAP["split"] == halo.LAST_OVERLAP[
            "in_flight"] == 1
    finally:
        dist.destroy_process_group()


BAND = Grid(W, H, coords=(-1.2, 1.1, -np.pi, np.pi))


@pytest.fixture(scope="module")
def band_inputs(inputs):
    """The shared fields, with the codes and mouths of the band grid."""
    hb = blur(_t(inputs, "terrain"), BAND, 0.5)
    code = tf.flow_directions(hb, torch.ones_like(hb), BAND)
    _, mouth, _ = tf.incoming_mask(code, BAND)
    return dict(inputs, code=code.numpy(),
                mouth=mouth.numpy().astype(np.float32))


@pytest.fixture(scope="module")
def band_runs(band_inputs, tmp_path_factory):
    return {shape: _run_group(band_inputs, shape,
                              tmp_path_factory.mktemp(f"band{shape[0]}"
                                                      f"x{shape[1]}"),
                              mode="band", grid=BAND)
            for shape in MESHES}


@pytest.fixture(scope="module")
def band_viscosity(band_inputs):
    """The mesh viscosity of the band grid on a one-process group."""
    import torch.distributed as dist

    cfg = ocean.OceanConfig(jacobi_iters=24, diffusion_iters=25)
    dm.initialize("cpu")
    try:
        mesh = dm.make_mesh(device="cpu")
        return ocean.diffusion(_t(band_inputs, "u"), _t(band_inputs, "v"),
                               _t(band_inputs, "terrain"), BAND, cfg,
                               mesh=mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_band_grid_mesh_paths_equal_single_device(band_runs, band_inputs,
                                                  band_viscosity, shape):
    """A grid that wraps in x but reaches neither pole: the pressure and
    viscosity halo solvers build their coefficients on the blocks, the
    flow filter its masks on the row groups (then the two-level
    fixpoint), the halo fixpoint its packed masks on the blocks, each
    block or strip ending at the grid's edge rows, with no
    ``sharded_call``; each result bit for bit the single-device op's (the
    viscosity the one-process mesh's, module docstring)."""
    from demiurge_tpu_torch.dist.local import local_supported

    assert BAND.wrap_x and not (BAND.wrap_south or BAND.wrap_north)
    assert local_supported(BAND, dm.Mesh(*shape, 0, 0, None, None))
    out = band_runs[shape]
    cfg = ocean.OceanConfig(jacobi_iters=24, diffusion_iters=25)
    t = _t(band_inputs, "terrain")
    np.testing.assert_array_equal(
        out["pressure"],
        ocean.pressure_solve(_t(band_inputs, "div"), t, BAND, cfg).numpy())
    np.testing.assert_array_equal(out["diff_u"], band_viscosity[0].numpy())
    np.testing.assert_array_equal(out["diff_v"], band_viscosity[1].numpy())
    fm, acc = tf.flow_filter_device(_t(band_inputs, "rough"),
                                    _t(band_inputs, "sel"), BAND,
                                    return_acc=True)
    np.testing.assert_array_equal(out["fm"], fm.numpy())
    np.testing.assert_array_equal(out["acc"], acc.numpy())
    A, vis, _ = tf.flow_solve_stencil(
        _t(band_inputs, "code"), tf.cell_area_lower_edge(BAND, "cpu"),
        _t(band_inputs, "mouth") > 0, BAND)
    np.testing.assert_array_equal(out["flowh_A"], A.numpy())
    np.testing.assert_array_equal(out["flowh_vis"], vis.numpy())
    assert (fm < 0).any() and (fm > 0).any()
    # none in the solvers, none in the flow filter and the halo fixpoint
    assert out["calls"].tolist() == [0, 0]


def test_window_overrides_every_grid_method_that_reads_the_size():
    """A ``Window``'s width and height are its own, not the globe's: every
    ``Grid`` method that reads them, but ``shape`` (the window's field
    shape), is overridden, so that no op reads a window's size as the
    globe's; ``geodistance_tex`` raises."""
    import inspect

    for name, member in vars(Grid).items():
        fn = member.fget if isinstance(member, property) else member
        if name.startswith("__") or name == "shape" or not callable(fn):
            continue
        src = inspect.getsource(fn)
        if "self.width" in src or "self.height" in src:
            assert name in vars(Window), name
    win = Window(10, 12, GRID.coords, GRID.circumference, full=(W, H),
                 row0=5, col0=-2)
    with pytest.raises(NotImplementedError):
        win.geodistance_tex((0.1, 0.2), (0.3, 0.4))
