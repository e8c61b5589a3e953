"""Shallow-water-style ocean currents on the sphere.

Counterpart of ``demiurge_tpu/ops/ocean.py`` (intent mode in full, and
``exact_quirks``).  One outer step is:

  1. advect    — semi-Lagrangian backtrace along great circles with parallel
                 transport of the sampled velocity, zonal wind stress, drag
                 and Coriolis; the sample is the tap sampler of
                 ``kernels.advect``
  2. diffusion — Jacobi sweeps of implicit viscosity (``kernels.jacobi``)
  3. divergence— area-weighted velocity divergence with obstacles and the
                 antipodal sign flip across the poles
  4. pressure  — Poisson solve by Jacobi sweeps from zero
                 (``kernels.jacobi``)
  5. project   — subtract the pressure gradient; coastal free-slip redirect

On CUDA tensors the three solves run on the hand-written kernels, and the
whole single-card advect stage is one launch (``kernels.advect``'s stage
form), as is the single-card projection on an x-periodic grid
(``kernels.project``); on CPU tensors they run on their plain twins
(``advect_plain`` and ``project`` for the stages).
``advect_method="exact"``, and any grid that is not x-periodic, samples by
bilinear gathers instead (``advect_gather``), as the reference does on
either device.  ``pressure_method="cg"`` solves the pressure by
preconditioned CG instead (``ops.pressure_cg``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import host_to_device, use_cuda_kernels
from ..core.topology import sample_bilinear, shift
from ..core.trace import span
from ..kernels import advect as ka
from ..kernels import jacobi as kj
from ..kernels import project as kpr
from .pressure_cg import pressure_solve_cg

PI = math.pi
REF_PI = 3.14159  # the reference's truncated pi literal, used where it does
WZ = 1.0 / 24.0   # planetary rotation (rev/h); omega = (0, 0, WZ)
CORIOLIS_DIV = 5000
STRESS = 0.0001   # wind stress: 1 + STRESS |w - v|^2, to the STRESS_EXP
STRESS_EXP = -2.0 / 24.0
DRAG = 1.0 - 0.4 ** (1.0 / 24.0)

_TABLES: dict = {}  # (grid, device) -> StageTables
_PROJECT_TABLES: dict = {}  # (grid, device) -> project_tables
_PLANS: dict = {}   # (grid, cfg, tiered, device) -> sampler_plan


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    pressurefactor: float = 100.0
    timestep: float = 24.0              # hours
    dissipation: float = 1.0
    diffusion_iters: int = 50
    jacobi_iters: int = 5000
    coriolis: float = 1.0               # reference formula scale; 0.0 = quirk
    exact_quirks: bool = False
    # 'fast' = the hat-weighted tap sampler (kernels.advect): exact bilinear
    # for displacements within the tap radii, clamped beyond
    advect_method: str = "fast"
    tap_radius_x: int = 8
    tap_radius_y: int = 2
    # velocity bound that sizes the per-strip tap radii of the tiered form;
    # None = derived from the wind forcing (vmax_from_wind)
    vmax_hint: Optional[float] = None
    # 'auto', 'xla' and 'pallas' name the reference's Jacobi backends; here
    # all three are the same Jacobi sweep (kernels.jacobi); 'cg' is the
    # preconditioned CG of ops.pressure_cg.
    pressure_method: str = "auto"
    cg_iters: int = 200
    cg_rtol: float = 1e-4


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _rotate(theta, ux, uy, uz, px, py, pz):
    """Axis-angle rotate (px,py,pz) by theta about unit axis u."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    omc = 1.0 - c
    rx = ((c + ux * ux * omc) * px + (ux * uy * omc - uz * s) * py
          + (ux * uz * omc + uy * s) * pz)
    ry = ((uy * ux * omc + uz * s) * px + (c + uy * uy * omc) * py
          + (uy * uz * omc - ux * s) * pz)
    rz = ((uz * ux * omc - uy * s) * px + (uz * uy * omc + ux * s) * py
          + (c + uz * uz * omc) * pz)
    return rx, ry, rz


def wind_profile(grid: Grid, device):
    """Zonal wind forcing profile. Shape (H,1) x2."""
    t = grid.row_t(device)
    phi = 2 * (t - 0.5) * REF_PI
    wx = -10 * torch.cos(phi * 1.5)
    wy = 10 * torch.sin(phi * 1.5)
    wx = torch.where(torch.abs(phi * 1.5) > REF_PI, -wx, wx)
    wy = torch.where(
        (torch.abs(phi) > REF_PI / 3) & (torch.abs(phi) < 3.1459 * 2 / 3),
        -wy, wy)
    wy = torch.where(phi < 0, -wy, wy)
    return wx, wy


class StageTables(NamedTuple):
    """Per-grid tables of the advect stage: sin and cos of the pixel
    centres' longitude (1, W) and latitude (H, 1), the wind profile
    (H, 1), and all six in one flat float32 tensor, the stage kernel's
    table [sin_lam | cos_lam | sin_phi | cos_phi | wx | wy]."""
    sin_lam: torch.Tensor
    cos_lam: torch.Tensor
    sin_phi: torch.Tensor
    cos_phi: torch.Tensor
    wx: torch.Tensor
    wy: torch.Tensor
    flat: torch.Tensor


def stage_tables(grid: Grid, device) -> StageTables:
    """The advect stage's per-grid tables, built once per grid and device
    by the torch ops that ``_departure`` and ``wind_profile`` ran on every
    call."""
    key = (grid, str(device))
    if key not in _TABLES:
        if grid.base is not grid:  # a window: the grid's tables, cut
            parts = tuple(grid.cut(t)
                          for t in stage_tables(grid.base, device)[:6])
        else:
            lam1d, phi1d = grid.lam_phi(device)
            parts = (torch.sin(lam1d), torch.cos(lam1d), torch.sin(phi1d),
                     torch.cos(phi1d), *wind_profile(grid, device))
        flat = torch.cat([t.reshape(-1) for t in parts]).contiguous()
        _TABLES[key] = StageTables(*parts, flat)
    return _TABLES[key]


def vmax_from_wind(timestep: float = 24.0, dissipation: float = 1.0,
                   safety: float = 1.4) -> float:
    """Static bound on |v| from the wind forcing's drag equilibrium: the
    per-step scalar update at the profile's peak |w| = 10*sqrt(2), run to
    its fixpoint, times a safety factor."""
    w = 10.0 * math.sqrt(2.0)
    drag = 1.0 - 0.4 ** (1.0 / 24.0)
    v = 0.0
    for _ in range(500):
        s = 1.0 + 1e-4 * (w - v) ** 2
        v = dissipation * v
        v = v + w * (1.0 - s ** (-2.0 / 24.0)) - v * drag
    return max(safety * v, 0.25)


def resolved_vmax(cfg: OceanConfig) -> float:
    if cfg.vmax_hint is not None:
        return cfg.vmax_hint
    return vmax_from_wind(cfg.timestep, cfg.dissipation)


def tap_radius_y(grid: Grid, cfg: OceanConfig) -> int:
    """y tap radius implied by the velocity bound (hat taps beyond
    ceil(max rows moved) carry zero weight)."""
    arc = 2 * REF_PI / grid.circumference * resolved_vmax(cfg) * cfg.timestep
    dy_pix = arc * grid.height / (grid.phi1 - grid.phi0)
    return max(1, min(int(math.ceil(dy_pix)), cfg.tap_radius_y))


def _row_col(grid: Grid, device):
    """Each pixel's column (1, W) and row (H, 1) as float32 (a window's
    global ones)."""
    c = grid.col_index(device).to(torch.float32)
    r = grid.row_index(device).to(torch.float32)
    return c.reshape(1, -1), r.reshape(-1, 1)


def _strip_radius_rows(radii, strip: int, device) -> torch.Tensor:
    return host_to_device(np.repeat(np.asarray(radii, np.float32), strip),
                          device).reshape(-1, 1)


def sampler_plan(grid: Grid, cfg: OceanConfig, tiered: bool, device):
    """The sampler's table and clamps: (meta, strip_rows, ry, the dx
    clamp), built once per grid, config and device.  Tiered: one (rx, q)
    a 32-row strip from the velocity bound (strip_radii), dx clamped per
    strip to its rx ((H, 1) rows), dy to tap_radius_y.  Otherwise the
    one-row table, dx clamped to Rx and dy to Ry."""
    key = (grid, cfg, tiered, str(device))
    if key not in _PLANS:
        if tiered:
            radii = ka.strip_radii(grid, resolved_vmax(cfg), cfg.timestep)
            _PLANS[key] = (ka.strip_meta(radii, grid.width), ka.STRIP,
                           tap_radius_y(grid, cfg),
                           _strip_radius_rows(radii, ka.STRIP, device))
        else:
            _PLANS[key] = (ka.global_meta(cfg.tap_radius_x), grid.height,
                           cfg.tap_radius_y, cfg.tap_radius_x)
    return _PLANS[key]


def sampler_tiered(grid: Grid, on_card: bool) -> bool:
    """Whether the sampler takes the tiered table: on the card, when H is
    a whole number of 32-row strips."""
    return on_card and grid.height % ka.STRIP == 0


def _advect_sample_fast(u, v, s2, t2, grid: Grid, cfg: OceanConfig):
    """Bilinear fetch of (u, v) at backtraced tex coords (s2, t2) through
    the tap sampler, with ``sampler_plan``'s table and clamps: on the card
    the tiered form where ``sampler_tiered``, otherwise the single-radius
    form (on the card the same kernel with a one-row table)."""
    H, W = u.shape
    tiered = sampler_tiered(grid, use_cuda_kernels(u, v, s2, t2))
    meta, rows, ry, rx = sampler_plan(grid, cfg, tiered, u.device)
    c, r = _row_col(grid, u.device)
    dx = torch.clamp(s2 * W - 0.5 - c, -rx, rx)
    dy = torch.clamp(t2 * H - 0.5 - r, -ry, ry)
    return ka.advect_sample(u, v, dx, dy, meta, rows, ry)


def _departure(u, v, grid: Grid, cfg: OceanConfig):
    """Great-circle backtrace of every pixel: sample coords (s2, t2),
    rotated point q, rotation axis, arclength, and the departure tangent
    basis."""
    tab = stage_tables(grid, u.device)      # (1,W) x2, (H,1) x2
    sin_lam, cos_lam = tab.sin_lam, tab.cos_lam
    sin_phi, cos_phi = tab.sin_phi, tab.cos_phi

    speed = torch.sqrt(u * u + v * v)
    arclength = 2 * REF_PI / grid.circumference * speed * cfg.timestep

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

    # rotation axis = normalize(cross(pos, v_cart)), eps-normalized so that
    # zero velocity gives arclength 0 -> identity
    ax = py * cz - pz * cy
    ay = pz * cx - px * cz
    az = px * cy - py * cx
    an = torch.sqrt(ax * ax + ay * ay + az * az)
    safe = torch.clamp(an, min=1e-30)
    ax, ay, az = ax / safe, ay / safe, az / safe

    qx, qy, qz = _rotate(-arclength, ax, ay, az, px, py, pz)
    lam2 = torch.atan2(qy, qx)
    phi2 = torch.asin(torch.clamp(qz, -1.0, 1.0))
    s2, t2 = grid.spheric_to_tex(lam2, phi2)
    return (s2, t2, qx, qy, qz, ax, ay, az, arclength,
            ex, ey, nx, ny, nz)


def advect_clamped_fraction(u, v, terrain, grid: Grid,
                            cfg: OceanConfig, mesh=None) -> torch.Tensor:
    """Fraction of ocean pixels whose backtraced displacement exceeds the
    tiered tap radii — pixels the sampler's cap would distort.  Under a
    ``mesh`` the fields are this rank's blocks; the two counts are summed
    over the ranks (exact: whole numbers)."""
    H, W = grid.shape
    part = grid
    if mesh is not None:
        from ..dist.local import block_window

        part = block_window(grid, mesh, 0)
    s2, t2 = _departure(u, v, part, cfg)[:2]
    c, r = _row_col(part, u.device)
    dx = s2 * W - 0.5 - c
    dx = torch.remainder(dx + W / 2.0, float(W)) - W / 2.0   # shortest wrap
    dy = t2 * H - 0.5 - r
    radii = ka.strip_radii(grid, resolved_vmax(cfg), cfg.timestep)
    # the last strip is short when H is not a whole number of strips (the
    # reference repeats H // len(radii) rows a strip, which then does not
    # cover H and fails to broadcast)
    rxrow = part.cut(_strip_radius_rows(radii, ka.STRIP, u.device)[:H])
    ry = tap_radius_y(grid, cfg)
    clamped = (torch.abs(dx) > rxrow) | (torch.abs(dy) > ry)
    water = terrain <= 0
    counts = (torch.sum(torch.where(water & clamped, 1.0, 0.0)),
              torch.sum(torch.where(water, 1.0, 0.0)))
    if mesh is not None:
        from ..dist.mesh import all_reduce

        counts = tuple(all_reduce(torch.stack(counts), mesh))
    return counts[0] / torch.clamp(counts[1], min=1.0)


# ---------------------------------------------------------------------------
# the five passes
# ---------------------------------------------------------------------------


def advect(u, v, terrain, grid: Grid, cfg: OceanConfig, mesh=None):
    """Semi-Lagrangian advection + wind forcing.

    One card: the stage as one kernel launch on CUDA tensors, its twin
    ``advect_plain`` on CPU tensors (``kernels.advect.advect_stage``).
    ``mesh``: the fields are this rank's blocks; the departure points, an
    elementwise stage, on the blocks with the blocks' own tables
    (``dist.local``), the sampler on blocks with one halo exchange and one
    global radius (``dist.advect``), the rest elementwise on the blocks.
    ``advect_method="exact"`` or a grid that is not x-periodic:
    ``advect_gather`` (on the gathered fields under a mesh)."""
    if cfg.advect_method != "fast" or not grid.wrap_x:
        if mesh is None:
            return advect_gather(u, v, terrain, grid, cfg)
        from ..dist.mesh import sharded_call

        return sharded_call(advect_gather, mesh)(u, v, terrain, grid, cfg)
    if mesh is None:
        return ka.advect_stage(u, v, terrain, grid, cfg)
    from ..dist import local
    from ..dist.advect import advect_sample_sharded

    dep = local.block_call(_departure, mesh, 0)(u, v, grid, cfg)
    nu, nv = advect_sample_sharded(u, v, dep[0], dep[1], grid, mesh,
                                   Rx=cfg.tap_radius_x, Ry=cfg.tap_radius_y)
    tab = stage_tables(local.block_window(grid, mesh, 0), u.device)
    return _advect_finish(nu, nv, dep, tab.wx, tab.wy, terrain, cfg)


def advect_plain(u, v, terrain, grid: Grid, cfg: OceanConfig):
    """The single-card advect stage as plain torch ops around the sampler:
    the stage kernel's twin."""
    dep = _departure(u, v, grid, cfg)
    nu, nv = _advect_sample_fast(u, v, dep[0], dep[1], grid, cfg)
    tab = stage_tables(grid, u.device)
    return _advect_finish(nu, nv, dep, tab.wx, tab.wy, terrain, cfg)


def advect_gather(u, v, terrain, grid: Grid, cfg: OceanConfig):
    """The advect with the exact sampler: (u, v) fetched by GL_LINEAR +
    GL_CLAMP_TO_EDGE gathers at the backtraced coordinates (clamped at
    the dateline seam, as in the reference), then the same transport and
    forcing as the fast path."""
    dep = _departure(u, v, grid, cfg)
    nu = sample_bilinear(u, dep[0], dep[1])
    nv = sample_bilinear(v, dep[0], dep[1])
    tab = stage_tables(grid, u.device)
    return _advect_finish(nu, nv, dep, tab.wx, tab.wy, terrain, cfg)


def _advect_finish(nu, nv, dep, wx, wy, terrain, cfg: OceanConfig):
    """What follows the sampler: the sampled (nu, nv) transported back to
    the pixel, NaN -> 0, Coriolis, dissipation, wind stress and drag, the
    land mask."""
    (_, _, qx, qy, qz, ax, ay, az, arclength, ex, ey, nx, ny, nz) = dep

    # parallel transport back (rotate the sampled vector by +arclength);
    # the landing-point basis comes from q: cos(phi2) = hypot(qx, qy)
    cp2 = torch.sqrt(qx * qx + qy * qy)
    inv_cp2 = 1.0 / torch.clamp(cp2, min=1e-30)
    cl2 = qx * inv_cp2                               # cos(lam2)
    sl2 = qy * inv_cp2                               # sin(lam2)
    e2x, e2y = -sl2, cl2
    n2x = -qz * cl2
    n2y = -qz * sl2
    n2z = cp2
    tx = nu * e2x + nv * n2x
    ty = nu * e2y + nv * n2y
    tz = nv * n2z
    tx, ty, tz = _rotate(arclength, ax, ay, az, tx, ty, tz)
    nu = tx * ex + ty * ey
    nv = tx * nx + ty * ny + tz * nz

    bad = torch.isnan(nu) | torch.isnan(nv)
    nu = torch.where(bad, 0.0, nu)
    nv = torch.where(bad, 0.0, nv)

    # Coriolis; the reference multiplies it by 0.0 (exact_quirks)
    cor = 0.0 if cfg.exact_quirks else cfg.coriolis
    if cor != 0.0:
        vcx = nu * ex + nv * nx
        vcy = nu * ey + nv * ny
        vcz = nv * nz
        acx = -2 * (-WZ * vcy)
        acy = -2 * (WZ * vcx)
        acz = torch.zeros_like(vcz)
        du = acx * ex + acy * ey
        dv = acx * nx + acy * ny + acz * nz
        nu = nu + du * cfg.timestep / CORIOLIS_DIV * cor
        nv = nv + dv * cfg.timestep / CORIOLIS_DIV * cor

    nu = cfg.dissipation * nu
    nv = cfg.dissipation * nv

    # wind stress + drag
    sx = 1.0 + STRESS * torch.abs(wx - nu) ** 2
    sy = 1.0 + STRESS * torch.abs(wy - nv) ** 2
    nu = nu + wx * (1 - sx ** STRESS_EXP) - nu * DRAG
    nv = nv + wy * (1 - sy ** STRESS_EXP) - nv * DRAG

    # solid cells hold zero velocity (and take no wind forcing)
    land = terrain > 0
    nu = torch.where(land, 0.0, nu)
    nv = torch.where(land, 0.0, nv)
    return nu, nv


@functools.lru_cache(maxsize=None)
def stage_scalars(grid: Grid, cfg: OceanConfig) -> np.ndarray:
    """The stage kernel's scalars (csrc/advect.cu StageScalars), each the
    float32 that torch makes of the Python number ``advect_plain``
    writes; a torch op on the card divides by a scalar as a multiply by
    its float32 reciprocal, so the divisors come as reciprocals.  Built
    once per grid and config; callers must not write to it."""
    f = np.float32
    cor = 0.0 if cfg.exact_quirks else cfg.coriolis
    return np.array(
        [2 * REF_PI / grid.circumference, cfg.timestep, grid.lam0,
         f(1) / f(grid.lam1 - grid.lam0), grid.phi0,
         f(1) / f(grid.phi1 - grid.phi0), grid.width, grid.height, cor,
         -WZ, WZ, f(1) / f(CORIOLIS_DIV), cfg.dissipation, STRESS,
         STRESS_EXP, DRAG], np.float32)


def _pole_flip_mask(dy: int, grid: Grid, device) -> torch.Tensor:
    """Rows whose (0, dy) neighbour crossed a pole -> velocity sign flip."""
    H = grid.height
    mask = torch.zeros((H, 1), dtype=torch.bool, device=device)
    if dy < 0 and grid.wrap_south:
        mask[:-dy] = True
    if dy > 0 and grid.wrap_north:
        mask[H - dy:] = True
    return mask


def _neighbor_vec(u, v, dx, dy, grid: Grid):
    """Velocity of the (dx,dy) neighbour with the pole sign flip."""
    nu = shift(u, dx, dy, grid)
    nv = shift(v, dx, dy, grid)
    if dx == 0 and dy != 0:
        flip = _pole_flip_mask(dy, grid, u.device)
        nu = torch.where(flip, -nu, nu)
        nv = torch.where(flip, -nv, nv)
    return nu, nv


def _quirks_tables(terrain, grid: Grid):
    """What the reference's viscosity sweep reads besides the velocities:
    the per-row weights wx, wy, beta and the four obstacle masks."""
    dxr, dyr = grid.pixelsize_rows(terrain.device)
    wx = (420.0 / dxr) ** 2
    wy = (420.0 / dyr) ** 2
    beta = 2 * (wx + wy) * (1 + 1 / (2 * (wx + wy)))
    return (wx, wy, beta, shift(terrain, 0, 1, grid) > 0,
            shift(terrain, 0, -1, grid) > 0, shift(terrain, 1, 0, grid) > 0,
            shift(terrain, -1, 0, grid) > 0)


def _quirks_sweep(u, v, tables, grid: Grid):
    """One sweep of the reference's viscosity as written, with its quirk:
    the x component of the center velocity is the rhs of both
    components."""
    wx, wy, beta, oN, oS, oE, oW = tables
    nu_, nv_ = _neighbor_vec(u, v, 0, 1, grid)
    su_, sv_ = _neighbor_vec(u, v, 0, -1, grid)
    eu_, ev_ = _neighbor_vec(u, v, 1, 0, grid)
    wu_, wv_ = _neighbor_vec(u, v, -1, 0, grid)
    nu_ = torch.where(oN, u, nu_)
    nv_ = torch.where(oN, v, nv_)
    su_ = torch.where(oS, u, su_)
    sv_ = torch.where(oS, v, sv_)
    eu_ = torch.where(oE, u, eu_)
    ev_ = torch.where(oE, v, ev_)
    wu_ = torch.where(oW, u, wu_)
    wv_ = torch.where(oW, v, wv_)
    newu = ((wu_ + eu_) * wx + (su_ + nu_) * wy + u) / beta
    newv = ((wv_ + ev_) * wx + (sv_ + nv_) * wy + u) / beta
    return newu, newv


def _diffusion_quirks(u, v, terrain, grid: Grid, cfg: OceanConfig):
    """The reference's viscosity sweeps as written (``_quirks_sweep``)."""
    tables = _quirks_tables(terrain, grid)
    for _ in range(cfg.diffusion_iters):
        u, v = _quirks_sweep(u, v, tables, grid)
    return u, v


def diffusion(u, v, terrain, grid: Grid, cfg: OceanConfig, mesh=None):
    """Implicit-viscosity Jacobi sweeps.  Intent mode runs the coefficient
    sweep (the Jacobi kernel on CUDA tensors); ``exact_quirks`` keeps the
    reference's sweep as written, as the reference package does.  Under a
    ``mesh`` (blocks) the halo rounds: intent mode's amortized solver
    (``dist.halo.diffusion_solve_sharded``), ``exact_quirks``' sweep on
    the padded blocks (``dist.halo.diffusion_quirks_sharded``); a grid
    that is not x-periodic on the gathered fields (``sharded_call``)."""
    if mesh is not None:
        from ..dist import halo
        from ..dist.mesh import sharded_call

        if not grid.wrap_x:
            return sharded_call(diffusion, mesh)(u, v, terrain, grid, cfg)
        if cfg.exact_quirks:
            return halo.diffusion_quirks_sharded(u, v, terrain, grid, mesh,
                                                 iters=cfg.diffusion_iters)
        return halo.diffusion_solve_sharded(u, v, terrain, grid, mesh,
                                            iters=cfg.diffusion_iters)
    if cfg.exact_quirks:
        return _diffusion_quirks(u, v, terrain, grid, cfg)
    with span("ocean.viscosity.coefficients"):
        coeffs = kj.diffusion_coefficients(terrain, grid)
    return kj.diffusion_solve(*coeffs, u, v, grid, cfg.diffusion_iters)


def divergence(u, v, terrain, grid: Grid, cfg: OceanConfig):
    """Area-weighted divergence."""
    dxr, dyr = grid.pixelsize_rows(u.device)
    area = dxr * dyr  # (H,1)
    au = u * area * cfg.pressurefactor
    av = v * area * cfg.pressurefactor

    _, vNy = _neighbor_vec(au, av, 0, 1, grid)
    _, vSy = _neighbor_vec(au, av, 0, -1, grid)
    vEx, _ = _neighbor_vec(au, av, 1, 0, grid)
    vWx, _ = _neighbor_vec(au, av, -1, 0, grid)

    vNy = torch.where(shift(terrain, 0, 1, grid) > 0, 0.0, vNy)
    vSy = torch.where(shift(terrain, 0, -1, grid) > 0, 0.0, vSy)
    vEx = torch.where(shift(terrain, 1, 0, grid) > 0, 0.0, vEx)
    vWx = torch.where(shift(terrain, -1, 0, grid) > 0, 0.0, vWx)

    pwx = dxr / 420.0
    pwy = dyr / 420.0
    return 0.5 * ((vEx - vWx) / pwx + (vNy - vSy) / pwy)


def pressure_solve(divw, terrain, grid: Grid, cfg: OceanConfig, p0=None,
                   mesh=None):
    """Jacobi Poisson solve for pressure, from zero unless ``p0`` is
    given (a warm start with the same fixpoint); with
    ``pressure_method="cg"`` and no mesh, the preconditioned CG solve
    (``ops.pressure_cg``).  Under a ``mesh`` (blocks) the amortized
    halo-exchange Jacobi (``dist.halo.pressure_solve_sharded``, from
    ``p0`` where given), for every method, as the reference does; a grid
    that is not x-periodic on the gathered fields (``sharded_call``)."""
    if cfg.pressure_method == "cg" and mesh is None:
        return pressure_solve_cg(divw, terrain, grid, iters=cfg.cg_iters,
                                 rtol=cfg.cg_rtol, p0=p0)
    if cfg.pressure_method not in ("auto", "xla", "pallas", "cg"):
        raise ValueError(f"unknown pressure_method {cfg.pressure_method!r}")
    if mesh is not None:
        from ..dist.halo import pressure_solve_sharded
        from ..dist.mesh import sharded_call

        if grid.wrap_x:
            return pressure_solve_sharded(divw, terrain, grid, mesh,
                                          iters=cfg.jacobi_iters, p0=p0)
        # the Jacobi on the gathered fields, for every method (the
        # reference's CG never runs under a mesh)
        jacobi = dataclasses.replace(cfg, pressure_method="auto")
        return sharded_call(pressure_solve, mesh)(divw, terrain, grid,
                                                  jacobi, p0)
    with span("ocean.pressure.coefficients"):
        coeffs = kj.coefficients(divw, terrain, grid)
    p = torch.zeros_like(divw) if p0 is None else p0
    return kj.pressure_solve(*coeffs, p, grid, cfg.jacobi_iters)


def project(u, v, p, terrain, grid: Grid, cfg: OceanConfig):
    """Subtract the pressure gradient + coastal free-slip redirect."""
    dxr, dyr = grid.pixelsize_rows(u.device)
    pwx = dxr / 420.0
    pwy = dyr / 420.0
    area = dxr * dyr

    oN = shift(terrain, 0, 1, grid) > 0
    oS = shift(terrain, 0, -1, grid) > 0
    oE = shift(terrain, 1, 0, grid) > 0
    oW = shift(terrain, -1, 0, grid) > 0

    pN = torch.where(oN, p, shift(p, 0, 1, grid))
    pS = torch.where(oS, p, shift(p, 0, -1, grid))
    pE = torch.where(oE, p, shift(p, 1, 0, grid))
    pW = torch.where(oW, p, shift(p, -1, 0, grid))

    fu = u - 0.5 * (pE - pW) / pwx / area / cfg.pressurefactor
    fv = v - 0.5 * (pN - pS) / pwy / area / cfg.pressurefactor

    # coastal free-slip redirect toward the nearest open direction of 8
    offsets = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1),
               (1, -1)]
    o_arr = [shift(terrain, dx, dy, grid) > 0 for (dx, dy) in offsets]

    theta = torch.remainder((torch.atan2(fv, fu) / PI + 1) / 2 * 8 + 4, 8.0)
    lower = torch.remainder(torch.floor(theta), 8).to(torch.int32)
    upper = torch.remainder(torch.ceil(theta), 8).to(torch.int32)
    o_lower = torch.zeros_like(o_arr[0])
    o_upper = torch.zeros_like(o_arr[0])
    for i in range(8):
        o_lower = o_lower | ((lower == i) & o_arr[i])
        o_upper = o_upper | ((upper == i) & o_arr[i])
    is_border = o_lower | o_upper

    mag = torch.sqrt(fu * fu + fv * fv)
    best_u, best_v = fu, fv
    difference = torch.full_like(fu, 2 * PI)
    for i, (dx, dy) in enumerate(offsets):
        thetai = float(i)  # the direction's own theta, for this order
        ang = torch.minimum((2 * PI) - torch.abs(thetai - theta),
                            torch.abs(thetai - theta))
        better = (ang < difference) & ~o_arr[i]
        norm = math.sqrt(dx * dx + dy * dy)
        best_u = torch.where(better, dx / norm * mag, best_u)
        best_v = torch.where(better, dy / norm * mag, best_v)
        difference = torch.where(better, ang, difference)

    fu = torch.where(is_border, best_u, fu)
    fv = torch.where(is_border, best_v, fv)

    land = terrain > 0
    fu = torch.where(land, 0.0, fu)
    fv = torch.where(land, 0.0, fv)
    return fu, fv


def project_tables(grid: Grid, device) -> torch.Tensor:
    """The projection kernel's per-grid table [pwx (H) | area (H) | pwy],
    built once per grid and device by the torch ops that ``project`` runs
    on every call."""
    key = (grid, str(device))
    if key not in _PROJECT_TABLES:
        dxr, dyr = grid.pixelsize_rows(device)
        pwx = dxr / 420.0
        pwy = dyr / 420.0
        area = dxr * dyr
        _PROJECT_TABLES[key] = torch.cat(
            [pwx.reshape(-1), area.reshape(-1), pwy.reshape(1)]).contiguous()
    return _PROJECT_TABLES[key]


@functools.lru_cache(maxsize=None)
def project_scalars(cfg: OceanConfig) -> np.ndarray:
    """The projection kernel's scalars (csrc/project.cu ProjectScalars),
    each the float32 that torch makes of the Python number ``project``
    writes, the divisors as float32 reciprocals (as ``stage_scalars``):
    1/pressurefactor, 1/PI, 2*PI, then dx/norm and dy/norm of the 8
    directions.  Built once per config; callers must not write to it."""
    f = np.float32
    offsets = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1),
               (1, -1)]                                # project's, its order
    norms = [math.sqrt(dx * dx + dy * dy) for dx, dy in offsets]
    return np.array([f(1) / f(cfg.pressurefactor), f(1) / f(PI), 2 * PI,
                     *(dx / n for (dx, _), n in zip(offsets, norms)),
                     *(dy / n for (_, dy), n in zip(offsets, norms))],
                    np.float32)


def ocean_step(u, v, terrain, grid: Grid, cfg: OceanConfig = OceanConfig(),
               mesh=None):
    """One full outer step. Returns (u, v, p, div).

    One card: the projection is ``kernels.project.project_stage``, one
    launch on CUDA tensors of an x-periodic grid, else ``project``.
    ``mesh``: the fields are this rank's blocks; the sampler and the two
    iterative solvers run their block forms (``dist.advect``,
    ``dist.halo``), divergence and projection (``project``) on the blocks
    with a 1-ring halo (``dist.local``; the velocity halo negated beyond a
    pole), or on the gathered fields (``sharded_call``) on a grid that is
    not x-periodic.  Spans (``core.trace``): ``ocean`` around the step,
    ``ocean.advect``, ``ocean.viscosity``, ``ocean.divergence``,
    ``ocean.pressure`` and ``ocean.project`` around its stages, and on
    one card ``ocean.viscosity.coefficients`` and
    ``ocean.pressure.coefficients`` around the solves' coefficient
    builds."""
    with span("ocean"):
        if mesh is None:
            div_fn, project_fn = divergence, kpr.project_stage
        else:
            from ..dist.local import block_or_gathered

            div_fn = block_or_gathered(divergence, grid, mesh, 1,
                                       halo=(0, 1, 2), negate=(0, 1))
            project_fn = block_or_gathered(project, grid, mesh, 1,
                                           halo=(2, 3))
        with span("ocean.advect"):
            u, v = advect(u, v, terrain, grid, cfg, mesh=mesh)
        with span("ocean.viscosity"):
            u, v = diffusion(u, v, terrain, grid, cfg, mesh=mesh)
        with span("ocean.divergence"):
            div = div_fn(u, v, terrain, grid, cfg)
        with span("ocean.pressure"):
            p = pressure_solve(div, terrain, grid, cfg, mesh=mesh)
        with span("ocean.project"):
            u, v = project_fn(u, v, p, terrain, grid, cfg)
    return u, v, p, div


def init_ocean(grid: Grid, device):
    """v = 0."""
    z = torch.zeros(grid.shape, dtype=torch.float32, device=device)
    return z, z.clone()
