"""The projection stage's kernel (csrc/project.cu) as far as the CPU reaches.

The CUDA kernel cannot run here.  Its tap indexing is transliterated in
numpy and held to ``core.topology.shift``, the shifts its twin
``ops.ocean.project`` takes: a pixel off the grid's outer ring reads its
plain neighbours; one on the ring reads each tap row through the kernel's
``halo_row`` (the row beyond a pole is the edge row ``pole_shift`` columns
over, the one beyond another edge the edge row itself) and wraps each
column mod W.  Two wrong rules must disagree with the shifts: the pole's
column shift left out, and a diagonal reflected before its roll (its
column step taken on the far side of the pole, where east is west:
c + pole_shift - dx).

The rest is the dispatch: on CPU tensors, and under a mesh, ``ocean_step``
runs plain ``project`` and counts no launch; with the card's condition
held (CUDA tensors, an x-periodic grid) it takes the kernel; the kernel's
per-grid table and scalars are the twin's own numbers.
"""

import math

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.core.topology import _pole_col_shift, shift
from demiurge_tpu_torch.kernels import project as kpr
from demiurge_tpu_torch.ops import ocean

torch.set_num_threads(2)

PI = math.pi
GLOBAL = (-PI / 2, PI / 2, -PI, PI)
BAND = (-1.0, 0.9, -PI, PI)          # x-periodic, clamped in y
SOUTH_CAP = (-PI / 2, 0.5, -PI, PI)  # the south pole only
REGIONAL = (-1.0, 0.9, -2.5, 1.0)

# (W, H, coords): the card test's three grids, an odd width (pole shift
# round(W / 2)), a width that is no multiple of 32, one pole only, and a
# grid of 3 rows, all ring
GRIDS = {
    "256x128-global": (256, 128, GLOBAL),
    "256x120-global": (256, 120, GLOBAL),
    "256x128-band": (256, 128, BAND),
    "255x64-global": (255, 64, GLOBAL),
    "200x40-global": (200, 40, GLOBAL),
    "96x24-south-cap": (96, 24, SOUTH_CAP),
    "64x3-global": (64, 3, GLOBAL),
}
TAPS = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _halo_row(gr, H, wrap_s, wrap_n, pole_shift):
    """csrc/project.cu halo_row, on an array of tap rows: the grid row and
    column offset each reads, and whether it lies beyond a pole."""
    south, north = gr < 0, gr >= H
    row = np.where(south, 0, np.where(north, H - 1, gr))
    beyond = (south & bool(wrap_s)) | (north & bool(wrap_n))
    return row, np.where(beyond, pole_shift, 0), beyond


def kernel_taps(field, grid, rule="kernel"):
    """Every tap (dx, dy) of every pixel as csrc/project.cu load_taps
    reads it.  ``rule``: "kernel", or one of the wrong rules
    "no-pole-shift" and "reflect-first"."""
    H, W = field.shape
    ps = 0 if rule == "no-pole-shift" else _pole_col_shift(grid)
    r = np.arange(H)[:, None] + np.zeros((1, W), int)
    c = np.arange(W)[None, :] + np.zeros((H, 1), int)
    inner = (r > 0) & (r < H - 1) & (c > 0) & (c < W - 1)
    out = {}
    for dx, dy in TAPS:
        row, off, beyond = _halo_row(r + dy, H, grid.wrap_south,
                                     grid.wrap_north, ps)
        step = np.where(beyond & (rule == "reflect-first"), -dx, dx)
        col = c + step + off
        col = np.where(col < 0, col + W, col)
        col = np.where(col >= W, col - W, col)
        row = np.where(inner, r + dy, row)
        col = np.where(inner, c + dx, col)
        assert ((0 <= col) & (col < W)).all()
        out[(dx, dy)] = field[row, col]
    return out


def _field(W, H, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (H, W)).astype(np.float32)


@pytest.mark.parametrize("name", list(GRIDS))
def test_kernel_taps_equal_shift(name):
    """Each of the 9 taps equals ``shift`` bit for bit."""
    W, H, coords = GRIDS[name]
    grid = Grid(W, H, coords)
    f = _field(W, H)
    t = torch.from_numpy(f)
    got = kernel_taps(f, grid)
    for tap in TAPS:
        np.testing.assert_array_equal(got[tap], shift(t, *tap, grid).numpy(),
                                      err_msg=f"tap {tap}")


@pytest.mark.parametrize("rule", ["no-pole-shift", "reflect-first"])
def test_wrong_tap_rules_disagree(rule):
    """The wrong rules differ from ``shift`` at the pole rows of a global
    grid, in every tap that crosses a pole (all three of each pole for
    the missing shift, the two diagonals for the reflection's order), and
    nowhere else."""
    grid = Grid(256, 128, GLOBAL)
    f = _field(256, 128)
    t = torch.from_numpy(f)
    got = kernel_taps(f, grid, rule)
    crossing = [(dx, dy) for dx, dy in TAPS if dy != 0
                and (rule == "no-pole-shift" or dx != 0)]
    for tap in TAPS:
        want = shift(t, *tap, grid).numpy()
        if tap not in crossing:
            np.testing.assert_array_equal(got[tap], want)
            continue
        edge = 0 if tap[1] < 0 else -1
        assert not np.array_equal(got[tap][edge], want[edge]), tap
        np.testing.assert_array_equal(got[tap][1:-1], want[1:-1])


def _ocean_case(W, H, coords=GLOBAL, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    u, v = (rng.standard_normal((2, H, W)) * 0.1).astype(np.float32)
    cfg = ocean.OceanConfig(jacobi_iters=8, diffusion_iters=4)
    return (Grid(W, H, coords), torch.from_numpy((h - 0.05) * 20),
            torch.from_numpy(u), torch.from_numpy(v), cfg)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_ocean_step_on_cpu_tensors_runs_plain_project(monkeypatch):
    """One card, CPU tensors: the stage is ``ocean.project``, once a step,
    and no launch is counted or attempted."""
    grid, h, u, v, cfg = _ocean_case(64, 32)
    calls = _count_calls(monkeypatch, ocean, "project")

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called on CPU tensors")

    monkeypatch.setattr(kpr, "project_stage_cuda", refuse)
    before = kpr.LAUNCHES
    for _ in range(2):
        u, v, _, _ = ocean.ocean_step(u, v, h, grid, cfg)
    assert len(calls) == 2 and kpr.LAUNCHES == before
    assert bool(torch.isfinite(u).all() and torch.isfinite(v).all())


@pytest.mark.parametrize("coords,kernel", [(GLOBAL, True), (BAND, True),
                                           (REGIONAL, False)],
                         ids=["global", "band", "regional"])
def test_ocean_step_routes_by_the_card_condition(monkeypatch, coords,
                                                 kernel):
    """With the card's condition held for these tensors (as CUDA tensors
    would hold it), the single-card step takes the kernel on an x-periodic
    grid, with the stage's inputs, and ``project`` on a regional grid."""
    grid, h, u, v, cfg = _ocean_case(64, 32, coords)
    taken = []

    def on_card(*tensors, grid=None):
        return grid is None or grid.wrap_x

    def fake_kernel(u_, v_, p_, t_, g_, c_):
        taken.append((u_.shape, p_.shape, t_ is h, g_, c_))
        return ocean.project(u_, v_, p_, t_, g_, c_)

    monkeypatch.setattr(kpr, "use_cuda_kernels", on_card)
    monkeypatch.setattr(kpr, "project_stage_cuda", fake_kernel)
    calls = _count_calls(monkeypatch, ocean, "project")
    ocean.ocean_step(u, v, h, grid, cfg)
    if kernel:
        assert taken == [(grid.shape, grid.shape, True, grid, cfg)]
        assert len(calls) == 1   # the fake kernel's own call
    else:
        assert taken == [] and len(calls) == 1


def test_ocean_step_under_a_mesh_keeps_plain_project(monkeypatch):
    """Under a mesh the projection is ``block_or_gathered(project, ...)``
    as before, never the kernel's dispatch, and counts no launch.  The
    mesh's own stages are stubbed: only the choice of function is under
    test."""
    from demiurge_tpu_torch.dist import local

    grid, h, u, v, cfg = _ocean_case(64, 32)
    mesh = object()
    wrapped = []

    def block_or_gathered(fn, grid_, mesh_, k, halo=(), negate=()):
        assert mesh_ is mesh
        wrapped.append((fn, halo))
        return fn

    def keep(u_, v_, *args, mesh=None):
        assert mesh is not None
        return u_, v_

    def no_pressure(div, terrain, grid_, cfg_, p0=None, mesh=None):
        assert mesh is not None
        return torch.zeros_like(div)

    monkeypatch.setattr(local, "block_or_gathered", block_or_gathered)
    monkeypatch.setattr(ocean, "advect", keep)
    monkeypatch.setattr(ocean, "diffusion", keep)
    monkeypatch.setattr(ocean, "pressure_solve", no_pressure)
    monkeypatch.setattr(kpr, "project_stage",
                        lambda *a: pytest.fail("the kernel's dispatch ran"))
    before = kpr.LAUNCHES
    fu, fv, _, _ = ocean.ocean_step(u, v, h, grid, cfg, mesh=mesh)
    assert [fn for fn, _ in wrapped] == [ocean.divergence, ocean.project]
    assert wrapped[1][1] == (2, 3) and kpr.LAUNCHES == before
    wu, wv = ocean.project(u, v, torch.zeros_like(u), h, grid, cfg)
    assert torch.equal(fu, wu) and torch.equal(fv, wv)


def test_kernel_wrapper_refuses_cpu_tensors():
    grid, h, u, v, cfg = _ocean_case(64, 32)
    before = kpr.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kpr.project_stage_cuda(u, v, torch.zeros_like(u), h, grid, cfg)
    assert kpr.LAUNCHES == before


@pytest.mark.parametrize("coords", [GLOBAL, BAND], ids=["global", "band"])
def test_project_tables_are_the_twins_numbers(coords):
    """[pwx | area | pwy] bit for bit as ``project`` computes them, built
    once per grid and device."""
    grid = Grid(96, 48, coords)
    cpu = torch.device("cpu")
    tab = ocean.project_tables(grid, cpu)
    dxr, dyr = grid.pixelsize_rows(cpu)
    H = grid.height
    assert tab.shape == (2 * H + 1,) and tab.dtype == torch.float32
    assert torch.equal(tab[:H], (dxr / 420.0).reshape(-1))
    assert torch.equal(tab[H:2 * H], (dxr * dyr).reshape(-1))
    assert torch.equal(tab[2 * H], dyr / 420.0)
    assert ocean.project_tables(grid, cpu) is tab


def test_project_scalars():
    """1/pressurefactor and 1/PI as float32 reciprocals, 2*PI, and the 8
    directions' unit components in ``project``'s order."""
    cfg = ocean.OceanConfig(pressurefactor=37.0)
    sc = ocean.project_scalars(cfg)
    f = np.float32
    r = f(1 / math.sqrt(2))
    assert sc.dtype == np.float32 and sc.shape == (19,)
    assert sc[0] == f(1) / f(37.0) and sc[1] == f(1) / f(PI)
    assert sc[2] == f(2 * PI)
    np.testing.assert_array_equal(sc[3:11], [1, r, 0, -r, -1, -r, 0, r])
    np.testing.assert_array_equal(sc[11:], [0, r, 1, r, 0, -r, -1, -r])
