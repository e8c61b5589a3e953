"""The single-card advect stage's twin and its per-grid caches, on the CPU.

On the card the advect stage is one launch of csrc/advect.cu's stage form;
its twin, ``ops.ocean.advect_plain``, is the composition of torch ops that
``ocean.advect`` ran around the sampler before, now reading per-grid
tables (trig, wind profile, strip table) built once.  Here the twin is
held bit for bit to that earlier composition, written out below as it
stood (``_composition``), on the tiered and the one-row table, with
Coriolis and under ``exact_quirks``; and every cache is held to the code
that built its values on each call.  ``tests/test_torch_ocean.py`` holds
``ocean.advect`` to the JAX package.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import advect as ka
from demiurge_tpu_torch.kernels import directions as kd
from demiurge_tpu_torch.ops import flow as tf
from demiurge_tpu_torch.ops import ocean

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _case(W, H, quirks, seed=5):
    """A terrain with coastlines and (u, v) fast enough that dx passes the
    strips' rx and dy passes Ry, with polar strips (vmax 10: rx 256, q > 0
    in the strips at the poles)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    u, v = (rng.standard_normal((2, H, W)) * 8.0).astype(np.float32)
    cfg = ocean.OceanConfig(vmax_hint=10.0, exact_quirks=quirks)
    return (Grid(W, H), torch.from_numpy((h - 0.05) * 20),
            torch.from_numpy(u), torch.from_numpy(v), cfg)


# ---------------------------------------------------------------------------
# the composition the twin replaces, as ops/ocean.py wrote it (mesh=None),
# with the sampler's table chosen by ``tiered`` instead of by the device
# ---------------------------------------------------------------------------


def _departure(u, v, grid, cfg):
    lam1d, phi1d = grid.lam_phi(u.device)
    sin_lam = torch.sin(lam1d)
    cos_lam = torch.cos(lam1d)
    sin_phi = torch.sin(phi1d)
    cos_phi = torch.cos(phi1d)
    speed = torch.sqrt(u * u + v * v)
    arclength = 2 * ocean.REF_PI / grid.circumference * speed * cfg.timestep
    px = cos_phi * cos_lam
    py = cos_phi * sin_lam
    pz = sin_phi.expand(grid.shape)
    ex, ey = -sin_lam, cos_lam
    nx = -sin_phi * cos_lam
    ny = -sin_phi * sin_lam
    nz = cos_phi
    cx = u * ex + v * nx
    cy = u * ey + v * ny
    cz = v * nz
    ax = py * cz - pz * cy
    ay = pz * cx - px * cz
    az = px * cy - py * cx
    an = torch.sqrt(ax * ax + ay * ay + az * az)
    safe = torch.clamp(an, min=1e-30)
    ax, ay, az = ax / safe, ay / safe, az / safe
    qx, qy, qz = ocean._rotate(-arclength, ax, ay, az, px, py, pz)
    lam2 = torch.atan2(qy, qx)
    phi2 = torch.asin(torch.clamp(qz, -1.0, 1.0))
    s2, t2 = grid.spheric_to_tex(lam2, phi2)
    return (s2, t2, qx, qy, qz, ax, ay, az, arclength, ex, ey, nx, ny, nz)


def _sample(u, v, s2, t2, grid, Rx, Ry, cfg, tiered):
    H, W = u.shape
    c, r = ocean._row_col(grid, u.device)
    if tiered:
        vmax = ocean.resolved_vmax(cfg)
        ry = ocean.tap_radius_y(grid, cfg)
        radii = ka.strip_radii(grid, vmax, cfg.timestep)
        rxrow = ocean._strip_radius_rows(radii, ka.STRIP, u.device)
        dx = torch.clamp(s2 * W - 0.5 - c, -rxrow, rxrow)
        dy = torch.clamp(t2 * H - 0.5 - r, -ry, ry)
        return ka.advect_sample(u, v, dx, dy, ka.strip_meta(radii, W),
                                ka.STRIP, ry)
    dx = torch.clamp(s2 * W - 0.5 - c, -Rx, Rx)
    dy = torch.clamp(t2 * H - 0.5 - r, -Ry, Ry)
    return ka.advect_sample(u, v, dx, dy, ka.global_meta(Rx), H, Ry)


def _composition(u, v, terrain, grid, cfg, tiered):
    wx, wy = ocean.wind_profile(grid, u.device)
    dep = _departure(u, v, grid, cfg)
    nu, nv = _sample(u, v, dep[0], dep[1], grid, cfg.tap_radius_x,
                     cfg.tap_radius_y, cfg, tiered)
    (_, _, qx, qy, qz, ax, ay, az, arclength, ex, ey, nx, ny, nz) = dep
    cp2 = torch.sqrt(qx * qx + qy * qy)
    inv_cp2 = 1.0 / torch.clamp(cp2, min=1e-30)
    cl2 = qx * inv_cp2
    sl2 = qy * inv_cp2
    e2x, e2y = -sl2, cl2
    n2x = -qz * cl2
    n2y = -qz * sl2
    n2z = cp2
    tx = nu * e2x + nv * n2x
    ty = nu * e2y + nv * n2y
    tz = nv * n2z
    tx, ty, tz = ocean._rotate(arclength, ax, ay, az, tx, ty, tz)
    nu = tx * ex + ty * ey
    nv = tx * nx + ty * ny + tz * nz
    bad = torch.isnan(nu) | torch.isnan(nv)
    nu = torch.where(bad, 0.0, nu)
    nv = torch.where(bad, 0.0, nv)
    cor = 0.0 if cfg.exact_quirks else cfg.coriolis
    if cor != 0.0:
        wz_ = 1.0 / 24.0
        vcx = nu * ex + nv * nx
        vcy = nu * ey + nv * ny
        vcz = nv * nz
        acx = -2 * (-wz_ * vcy)
        acy = -2 * (wz_ * vcx)
        acz = torch.zeros_like(vcz)
        du = acx * ex + acy * ey
        dv = acx * nx + acy * ny + acz * nz
        nu = nu + du * cfg.timestep / 5000 * cor
        nv = nv + dv * cfg.timestep / 5000 * cor
    nu = cfg.dissipation * nu
    nv = cfg.dissipation * nv
    sx = 1.0 + 0.0001 * torch.abs(wx - nu) ** 2
    sy = 1.0 + 0.0001 * torch.abs(wy - nv) ** 2
    drag = 1.0 - 0.4 ** (1.0 / 24.0)
    nu = nu + wx * (1 - sx ** (-2.0 / 24.0)) - nu * drag
    nv = nv + wy * (1 - sy ** (-2.0 / 24.0)) - nv * drag
    land = terrain > 0
    nu = torch.where(land, 0.0, nu)
    nv = torch.where(land, 0.0, nv)
    return nu, nv


@pytest.mark.parametrize("quirks", [False, True],
                         ids=["coriolis", "exact_quirks"])
@pytest.mark.parametrize("tiered", [True, False], ids=["tiered", "one-row"])
@pytest.mark.parametrize("shape", [(128, 64), (256, 128)],
                         ids=["128x64", "256x128"])
def test_twin_equals_the_composition_it_replaces(shape, tiered, quirks,
                                                 monkeypatch):
    """Bit for bit, NaN-free, with the clamps and the polar strips'
    coarse taps in play; the tiered table, which the card takes, by
    patching the choice."""
    grid, h, u, v, cfg = _case(*shape, quirks)
    monkeypatch.setattr(ocean, "sampler_tiered", lambda g, on_card: tiered)
    got = ocean.advect_plain(u, v, h, grid, cfg)
    want = _composition(u, v, h, grid, cfg, tiered)
    meta = ocean.sampler_plan(grid, cfg, tiered, CPU)[0]
    assert (meta[:, 1] > 0).any() == tiered
    for g, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert torch.equal(g, w)
    # the sampler's clamp binds somewhere
    s2, t2 = ocean._departure(u, v, grid, cfg)[:2]
    c, _ = ocean._row_col(grid, CPU)
    assert float((s2 * grid.width - 0.5 - c).abs().max()) \
        > cfg.tap_radius_x


@pytest.mark.parametrize("quirks", [False, True],
                         ids=["coriolis", "exact_quirks"])
def test_advect_on_the_cpu_runs_the_twin(quirks):
    """``ocean.advect`` on CPU tensors is the twin on the one-row table,
    as the earlier composition took it there."""
    grid, h, u, v, cfg = _case(128, 64, quirks)
    got = ocean.advect(u, v, h, grid, cfg)
    want = _composition(u, v, h, grid, cfg, tiered=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ocean.sampler_tiered(grid, True)
    assert not ocean.sampler_tiered(grid, False)
    assert not ocean.sampler_tiered(Grid(128, 60), True)


@pytest.mark.parametrize("shape", [(128, 64), (255, 120)])
def test_stage_tables_equal_the_uncached_values(shape):
    grid = Grid(*shape)
    tab = ocean.stage_tables(grid, CPU)
    lam, phi = grid.lam_phi(CPU)
    wx, wy = ocean.wind_profile(grid, CPU)
    for got, want in ((tab.sin_lam, torch.sin(lam)),
                      (tab.cos_lam, torch.cos(lam)),
                      (tab.sin_phi, torch.sin(phi)),
                      (tab.cos_phi, torch.cos(phi)), (tab.wx, wx),
                      (tab.wy, wy)):
        assert got.shape == want.shape and torch.equal(got, want)
    H, W = grid.shape
    assert tab.flat.shape == (2 * W + 4 * H,) and tab.flat.is_contiguous()
    assert torch.equal(tab.flat, torch.cat(
        [torch.sin(lam).reshape(-1), torch.cos(lam).reshape(-1),
         torch.sin(phi).reshape(-1), torch.cos(phi).reshape(-1),
         wx.reshape(-1), wy.reshape(-1)]))
    assert ocean.stage_tables(grid, CPU) is tab


@pytest.mark.parametrize("vmax", [None, 5.0])
def test_sampler_plan_equals_the_uncached_values(vmax):
    grid = Grid(256, 128)
    cfg = ocean.OceanConfig(vmax_hint=vmax)
    meta, rows, ry, rxrow = ocean.sampler_plan(grid, cfg, True, CPU)
    radii = ka.strip_radii(grid, ocean.resolved_vmax(cfg), cfg.timestep)
    np.testing.assert_array_equal(meta, ka.strip_meta(radii, 256))
    assert rows == ka.STRIP and ry == ocean.tap_radius_y(grid, cfg)
    assert torch.equal(rxrow, ocean._strip_radius_rows(radii, ka.STRIP, CPU))
    assert ocean.sampler_plan(grid, cfg, True, CPU)[3] is rxrow
    meta1, rows1, ry1, rx1 = ocean.sampler_plan(grid, cfg, False, CPU)
    np.testing.assert_array_equal(meta1, ka.global_meta(cfg.tap_radius_x))
    assert (rows1, ry1, rx1) == (128, cfg.tap_radius_y, cfg.tap_radius_x)


@pytest.mark.parametrize("shape", [(128, 64), (2000, 1000)])
def test_cell_area_cache_equals_the_uncached_values(shape):
    grid = Grid(*shape)
    got = tf.cell_area_lower_edge(grid, CPU)
    assert torch.equal(got, tf._cell_area_build(grid, CPU, 1e-5))
    assert tf.cell_area_lower_edge(grid, CPU) is got
    scaled = tf.cell_area_lower_edge(grid, CPU, scale=1.0)
    assert torch.equal(scaled, tf._cell_area_build(grid, CPU, 1.0))


@pytest.mark.parametrize("quirks", [False, True])
def test_stage_scalars_are_the_twins_numbers_in_float32(quirks):
    """Each scalar is the float32 of the number the twin writes, and each
    divisor comes as the float32 reciprocal of its float32 (a torch op on
    the card multiplies by it)."""
    grid = Grid(256, 128, circumference=40000.0)
    cfg = dataclasses.replace(ocean.OceanConfig(), exact_quirks=quirks,
                              dissipation=0.99, timestep=12.0)
    got = ocean.stage_scalars(grid, cfg)
    f = np.float32
    want = [2 * ocean.REF_PI / 40000.0, 12.0, -math.pi,
            f(1) / f(2 * math.pi), -math.pi / 2, f(1) / f(math.pi), 256,
            128, 0.0 if quirks else 1.0, -1 / 24, 1 / 24, f(1) / f(5000),
            0.99, 0.0001, -2 / 24, 1.0 - 0.4 ** (1 / 24)]
    assert got.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_array_equal(got, np.array(want, np.float32))


def test_directions_packed_on_the_cpu_is_the_plain_passes():
    """On CPU tensors the packed form is the direction pass, incoming_mask
    and pack_masks, as flow_filter_device composed them."""
    from demiurge_tpu_torch.kernels import flow as kf

    grid = Grid(128, 64)
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    hb = tf.blur(h + 0.2, grid, 0.5)
    sel = torch.ones_like(hb)
    code, packed = kd.directions_packed(hb, sel, grid)
    want_code = tf.flow_directions(hb, sel, grid)
    _, mouth, _ = tf.incoming_mask(want_code, grid)
    assert torch.equal(code, want_code)
    assert torch.equal(packed, kf.pack_masks(want_code, mouth, grid))
