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

On CUDA tensors the three solves run on the hand-written kernels; on CPU
tensors on their plain twins.  Not ported yet (they raise):
``pressure_method="cg"`` and ``advect_method="exact"`` (the gather
sampler, also what a grid that is not x-periodic would use).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import host_to_device, use_cuda_kernels
from ..core.topology import shift
from ..kernels import advect as ka
from ..kernels import jacobi as kj

PI = math.pi
REF_PI = 3.14159  # the reference's truncated pi literal, used where it does


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
    # all three are the same Jacobi sweep (kernels.jacobi).  'cg' is not
    # ported yet.
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
    c = torch.arange(grid.width, dtype=torch.float32, device=device)
    r = torch.arange(grid.height, dtype=torch.float32, device=device)
    return c.reshape(1, -1), r.reshape(-1, 1)


def _strip_radius_rows(radii, strip: int, device) -> torch.Tensor:
    return host_to_device(np.repeat(np.asarray(radii, np.float32), strip),
                          device).reshape(-1, 1)


def _advect_sample_fast(u, v, s2, t2, grid: Grid, Rx: int, Ry: int,
                        cfg: Optional[OceanConfig] = None):
    """Bilinear fetch of (u, v) at backtraced tex coords (s2, t2) through
    the tap sampler.

    On the card, when H is a whole number of 32-row strips, the tiered
    form: dx clamped per strip to its radius (strip_radii of the velocity
    bound), dy to tap_radius_y.  Otherwise the single-radius form, dx to Rx
    and dy to Ry (on the card, the same kernel with a one-row table)."""
    H, W = u.shape
    c, r = _row_col(grid, u.device)
    if use_cuda_kernels(u, v, s2, t2) and H % ka.STRIP == 0:
        vmax = resolved_vmax(cfg) if cfg is not None else 1.0
        ts = cfg.timestep if cfg is not None else 24.0
        ry = tap_radius_y(grid, cfg) if cfg is not None else Ry
        radii = ka.strip_radii(grid, vmax, ts)
        rxrow = _strip_radius_rows(radii, ka.STRIP, u.device)
        dx = torch.clamp(s2 * W - 0.5 - c, -rxrow, rxrow)
        dy = torch.clamp(t2 * H - 0.5 - r, -ry, ry)
        return ka.advect_sample(u, v, dx, dy, ka.strip_meta(radii, W),
                                ka.STRIP, ry)
    dx = torch.clamp(s2 * W - 0.5 - c, -Rx, Rx)
    dy = torch.clamp(t2 * H - 0.5 - r, -Ry, Ry)
    return ka.advect_sample(u, v, dx, dy, ka.global_meta(Rx), H, Ry)


def _departure(u, v, grid: Grid, cfg: OceanConfig):
    """Great-circle backtrace of every pixel: sample coords (s2, t2),
    rotated point q, rotation axis, arclength, and the departure tangent
    basis."""
    lam1d, phi1d = grid.lam_phi(u.device)     # (1,W), (H,1)
    sin_lam = torch.sin(lam1d)
    cos_lam = torch.cos(lam1d)
    sin_phi = torch.sin(phi1d)
    cos_phi = torch.cos(phi1d)

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
                            cfg: OceanConfig) -> torch.Tensor:
    """Fraction of ocean pixels whose backtraced displacement exceeds the
    tiered tap radii — pixels the sampler's cap would distort."""
    H, W = grid.shape
    s2, t2 = _departure(u, v, grid, cfg)[:2]
    c, r = _row_col(grid, u.device)
    dx = s2 * W - 0.5 - c
    dx = torch.remainder(dx + W / 2.0, float(W)) - W / 2.0   # shortest wrap
    dy = t2 * H - 0.5 - r
    radii = ka.strip_radii(grid, resolved_vmax(cfg), cfg.timestep)
    rxrow = _strip_radius_rows(radii, H // len(radii), u.device)
    ry = tap_radius_y(grid, cfg)
    clamped = (torch.abs(dx) > rxrow) | (torch.abs(dy) > ry)
    water = terrain <= 0
    return (torch.sum(torch.where(water & clamped, 1.0, 0.0))
            / torch.clamp(torch.sum(torch.where(water, 1.0, 0.0)), min=1.0))


# ---------------------------------------------------------------------------
# the five passes
# ---------------------------------------------------------------------------


def advect(u, v, terrain, grid: Grid, cfg: OceanConfig, mesh=None):
    """Semi-Lagrangian advection + wind forcing.

    ``mesh``: the fields are this rank's blocks; the departure points run
    on the gathered fields (``sharded_call``), the sampler on blocks with
    one halo exchange and one global radius (``dist.advect``), the rest
    elementwise on the blocks."""
    if cfg.advect_method != "fast" or not grid.wrap_x:
        raise NotImplementedError(
            "the gather sampler (advect_method='exact', or a grid that is "
            "not x-periodic) is not ported yet")
    wx, wy = wind_profile(grid, u.device)
    if mesh is None:
        dep = _departure(u, v, grid, cfg)
        nu, nv = _advect_sample_fast(u, v, dep[0], dep[1], grid,
                                     cfg.tap_radius_x, cfg.tap_radius_y,
                                     cfg=cfg)
    else:
        from ..dist.advect import advect_sample_sharded
        from ..dist.mesh import local_part, sharded_call

        dep = sharded_call(_departure, mesh)(u, v, grid, cfg)
        nu, nv = advect_sample_sharded(u, v, dep[0], dep[1], grid, mesh,
                                       Rx=cfg.tap_radius_x,
                                       Ry=cfg.tap_radius_y)
        wx, wy = (local_part(w, grid.shape, mesh) for w in (wx, wy))
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
        wz_ = 1.0 / 24.0  # planetary rotation (rev/h); omega = (0, 0, wz)
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

    # wind stress + drag
    sx = 1.0 + 0.0001 * torch.abs(wx - nu) ** 2
    sy = 1.0 + 0.0001 * torch.abs(wy - nv) ** 2
    drag = 1.0 - 0.4 ** (1.0 / 24.0)
    nu = nu + wx * (1 - sx ** (-2.0 / 24.0)) - nu * drag
    nv = nv + wy * (1 - sy ** (-2.0 / 24.0)) - nv * drag

    # solid cells hold zero velocity (and take no wind forcing)
    land = terrain > 0
    nu = torch.where(land, 0.0, nu)
    nv = torch.where(land, 0.0, nv)
    return nu, nv


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


def _diffusion_quirks(u, v, terrain, grid: Grid, cfg: OceanConfig):
    """The reference's viscosity sweep as written, with its quirk: the x
    component of the center velocity is the rhs of both components."""
    dxr, dyr = grid.pixelsize_rows(u.device)
    wx = (420.0 / dxr) ** 2
    wy = (420.0 / dyr) ** 2
    beta = 2 * (wx + wy) * (1 + 1 / (2 * (wx + wy)))
    oN = shift(terrain, 0, 1, grid) > 0
    oS = shift(terrain, 0, -1, grid) > 0
    oE = shift(terrain, 1, 0, grid) > 0
    oW = shift(terrain, -1, 0, grid) > 0
    for _ in range(cfg.diffusion_iters):
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
        u, v = newu, newv
    return u, v


def diffusion(u, v, terrain, grid: Grid, cfg: OceanConfig, mesh=None):
    """Implicit-viscosity Jacobi sweeps.  Intent mode runs the coefficient
    sweep (the Jacobi kernel on CUDA tensors); ``exact_quirks`` keeps the
    reference's sweep as written, as the reference package does.  Under a
    ``mesh`` (blocks) intent mode runs the amortized halo-exchange solver
    (``dist.halo.diffusion_solve_sharded``)."""
    if mesh is not None:
        from ..dist.halo import diffusion_solve_sharded
        from ..dist.mesh import sharded_call

        if not cfg.exact_quirks and grid.wrap_x:
            return diffusion_solve_sharded(u, v, terrain, grid, mesh,
                                           iters=cfg.diffusion_iters)
        return sharded_call(diffusion, mesh)(u, v, terrain, grid, cfg)
    if cfg.exact_quirks:
        return _diffusion_quirks(u, v, terrain, grid, cfg)
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
    given (a warm start with the same fixpoint).  Under a ``mesh``
    (blocks), from zero, the amortized halo-exchange solver
    (``dist.halo.pressure_solve_sharded``)."""
    if cfg.pressure_method == "cg":
        raise NotImplementedError("pressure_method='cg' is not ported yet")
    if cfg.pressure_method not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown pressure_method {cfg.pressure_method!r}")
    if mesh is not None:
        from ..dist.halo import pressure_solve_sharded
        from ..dist.mesh import sharded_call

        if grid.wrap_x and p0 is None:
            return pressure_solve_sharded(divw, terrain, grid, mesh,
                                          iters=cfg.jacobi_iters)
        return sharded_call(pressure_solve, mesh)(divw, terrain, grid, cfg,
                                                  p0)
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


def ocean_step(u, v, terrain, grid: Grid, cfg: OceanConfig = OceanConfig(),
               mesh=None):
    """One full outer step. Returns (u, v, p, div).

    ``mesh``: the fields are this rank's blocks; the sampler and the two
    iterative solvers run their block forms (``dist.advect``,
    ``dist.halo``), divergence and projection run on the gathered fields
    (``sharded_call``)."""
    if mesh is None:
        div_fn, project_fn = divergence, project
    else:
        from ..dist.mesh import sharded_call

        div_fn = sharded_call(divergence, mesh)
        project_fn = sharded_call(project, mesh)
    u, v = advect(u, v, terrain, grid, cfg, mesh=mesh)
    u, v = diffusion(u, v, terrain, grid, cfg, mesh=mesh)
    div = div_fn(u, v, terrain, grid, cfg)
    p = pressure_solve(div, terrain, grid, cfg, mesh=mesh)
    u, v = project_fn(u, v, p, terrain, grid, cfg)
    return u, v, p, div


def init_ocean(grid: Grid, device):
    """v = 0."""
    z = torch.zeros(grid.shape, dtype=torch.float32, device=device)
    return z, z.clone()
