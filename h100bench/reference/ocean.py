"""Plain reference of one ocean step (``ocean`` configuration), plain
PyTorch on any device and in any float dtype.

One outer step, as the reference ocean model states it (intent mode,
Coriolis on):

  1. advect    -- semi-Lagrangian backtrace of every pixel along its great
                  circle, (u, v) sampled bilinearly at the departure point
                  (x periodic, rows clamped at the edge), the displacement
                  clamped to the sampler's tap radii; the sample carried
                  back by parallel transport; Coriolis, dissipation, wind
                  stress and drag; zero on land;
  2. diffusion -- ``diffusion_iters`` Jacobi sweeps of implicit viscosity,
                  obstacles folded onto the centre, the velocity's sign
                  flipped across a pole;
  3. divergence-- area-weighted, with obstacles;
  4. pressure  -- ``jacobi_iters`` Jacobi sweeps of the Poisson equation
                  from zero, Neumann walls;
  5. project   -- subtract the pressure gradient, redirect coastal flow to
                  the nearest open direction of eight, zero on land.

The sampler's radii: on the card the program samples with per-strip x
radii of 32-row strips sized from the wind's velocity bound, where H is a
whole number of strips;
elsewhere with one radius (8 columns, 2 rows).  A strip whose radius
exceeds 16 (near a pole) samples exactly within 6 columns and on a lattice
of stride 8 beyond.  The reference computes each sample in closed form
(the lerp of the two bracketing taps), not as the program's tap sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import sphere as S

REF_PI = 3.14159  # the model's truncated pi, where it uses one
WZ = 1.0 / 24.0
CORIOLIS_DIV = 5000
STRESS = 0.0001
STRESS_EXP = -2.0 / 24.0
DRAG = 1.0 - 0.4 ** (1.0 / 24.0)
STRIP, RF, STRIDE = 32, 6, 8


# ---------------------------------------------------------------------------
# the sampler's radii
# ---------------------------------------------------------------------------


def vmax_from_wind(timestep: float) -> float:
    """The bound on |v| from the wind's drag equilibrium, times 1.4."""
    w = 10.0 * math.sqrt(2.0)
    v = 0.0
    for _ in range(500):
        s = 1.0 + 1e-4 * (w - v) ** 2
        v = v + w * (1.0 - s ** (-2.0 / 24.0)) - v * DRAG
    return max(1.4 * v, 0.25)


def strip_radii(H: int, W: int, vmax: float, timestep: float) -> list:
    arc = 2 * REF_PI / S.CIRCUMFERENCE * vmax * timestep
    phi = (np.arange(H) + 0.5) / H * (S.PHI1 - S.PHI0) + S.PHI0
    need = arc / (2 * math.pi / W) / np.maximum(np.cos(phi), 1e-9)
    out = []
    for s0 in range(0, H, STRIP):
        n = int(math.ceil(need[s0:s0 + STRIP].max()))
        out.append(next((t for t in (2, 4, 8, 16) if n <= t), 256))
    return out


def sampler_plan(H: int, W: int, cfg: dict, tiered: bool, device):
    """(rx (H, 1) float32 x clamp per row, q (H, 1) coarse half-count per
    row, 0 = exact taps, ry the y clamp)."""
    if not tiered:
        rx = np.full(H, cfg["tap_radius_x"], np.float32)
        return (torch.from_numpy(rx).reshape(-1, 1).to(device),
                torch.zeros((H, 1), dtype=torch.int64, device=device),
                cfg["tap_radius_y"])
    vmax = vmax_from_wind(cfg["timestep"])
    radii = strip_radii(H, W, vmax, cfg["timestep"])
    q = [min((r + STRIDE - 1) // STRIDE, W // 16) if r > 16 else 0
         for r in radii]
    arc = 2 * REF_PI / S.CIRCUMFERENCE * vmax * cfg["timestep"]
    ry = max(1, min(int(math.ceil(arc * H / (S.PHI1 - S.PHI0))),
                    cfg["tap_radius_y"]))
    rx = np.repeat(np.asarray(radii, np.float32), STRIP)
    return (torch.from_numpy(rx).reshape(-1, 1).to(device),
            torch.from_numpy(np.repeat(np.asarray(q, np.int64), STRIP)
                             ).reshape(-1, 1).to(device), ry)


def sample(u, v, dx, dy, q):
    """(u, v) at each pixel's displacement (dx, dy) in pixels: the lerp of
    the bracketing rows (clamped to the edge) and columns (periodic); in
    a polar strip (q > 0) beyond RF columns, of the bracketing points of
    the stride-8 lattice."""
    H, W = u.shape
    r = torch.arange(H, device=u.device).reshape(-1, 1)
    c = torch.arange(W, device=u.device).reshape(1, -1)
    y0 = torch.floor(dy)
    fy = dy - y0
    r0 = torch.clamp(r + y0.to(torch.int64), 0, H - 1)
    r1 = torch.clamp(r + y0.to(torch.int64) + 1, 0, H - 1)
    coarse = (q > 0) & (torch.abs(dx) > float(RF))
    step = torch.where(coarse, float(STRIDE), 1.0).to(dx.dtype)
    x0 = torch.floor(dx / step) * step
    fx = (dx - x0) / step
    c0 = torch.remainder(c + x0.to(torch.int64), W)
    c1 = torch.remainder(c0 + step.to(torch.int64), W)
    out = []
    for f in (u, v):
        top = f[r0, c0] * (1 - fx) + f[r0, c1] * fx
        bot = f[r1, c0] * (1 - fx) + f[r1, c1] * fx
        out.append(top * (1 - fy) + bot * fy)
    return out


# ---------------------------------------------------------------------------
# the five passes
# ---------------------------------------------------------------------------


def _rotate(theta, ux, uy, uz, px, py, pz):
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


def wind_profile(H: int, device):
    phi = 2 * (S.row_t(H, device) - 0.5) * REF_PI
    wx = -10 * torch.cos(phi * 1.5)
    wy = 10 * torch.sin(phi * 1.5)
    wx = torch.where(torch.abs(phi * 1.5) > REF_PI, -wx, wx)
    wy = torch.where(
        (torch.abs(phi) > REF_PI / 3) & (torch.abs(phi) < 3.1459 * 2 / 3),
        -wy, wy)
    wy = torch.where(phi < 0, -wy, wy)
    return wx, wy


def advect(u, v, terrain, cfg: dict):
    H, W = u.shape
    tiered = u.is_cuda and H % STRIP == 0
    dt = u.dtype
    lam, phi = S.col_lam(W, u.device), S.row_phi(H, u.device)
    sin_lam, cos_lam = torch.sin(lam).to(dt), torch.cos(lam).to(dt)
    sin_phi, cos_phi = torch.sin(phi).to(dt), torch.cos(phi).to(dt)
    timestep = cfg["timestep"]

    # the departure point: rotate the pixel by -arclength about
    # normalize(pos x velocity)
    speed = torch.sqrt(u * u + v * v)
    arclength = 2 * REF_PI / S.CIRCUMFERENCE * speed * timestep
    px = cos_phi * cos_lam
    py = cos_phi * sin_lam
    pz = sin_phi.expand(H, W)
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
    an = torch.clamp(torch.sqrt(ax * ax + ay * ay + az * az), min=1e-30)
    ax, ay, az = ax / an, ay / an, az / an
    qx, qy, qz = _rotate(-arclength, ax, ay, az, px, py, pz)
    lam2 = torch.atan2(qy, qx)
    phi2 = torch.asin(torch.clamp(qz, -1.0, 1.0))
    s2 = (lam2 - S.LAM0) / (S.LAM1 - S.LAM0)
    t2 = (phi2 - S.PHI0) / (S.PHI1 - S.PHI0)

    rx, q, ry = sampler_plan(H, W, cfg, tiered, u.device)
    c = torch.arange(W, dtype=torch.float32, device=u.device).reshape(1, -1)
    r = torch.arange(H, dtype=torch.float32, device=u.device).reshape(-1, 1)
    rx = rx.to(dt)
    dxp = torch.clamp(s2 * W - 0.5 - c.to(dt), -rx, rx)
    dyp = torch.clamp(t2 * H - 0.5 - r.to(dt), -ry, ry)
    nu, nv = sample(u, v, dxp, dyp, q)

    # carry the sample back: the landing point's basis, rotated by
    # +arclength
    cp2 = torch.sqrt(qx * qx + qy * qy)
    inv = 1.0 / torch.clamp(cp2, min=1e-30)
    cl2, sl2 = qx * inv, qy * inv
    tx = nu * -sl2 + nv * (-qz * cl2)
    ty = nu * cl2 + nv * (-qz * sl2)
    tz = nv * cp2
    tx, ty, tz = _rotate(arclength, ax, ay, az, tx, ty, tz)
    nu = tx * ex + ty * ey
    nv = tx * nx + ty * ny + tz * nz
    bad = torch.isnan(nu) | torch.isnan(nv)
    nu = torch.where(bad, 0.0, nu)
    nv = torch.where(bad, 0.0, nv)

    cor = cfg["coriolis"]
    if cor != 0.0:
        vcx = nu * ex + nv * nx
        vcy = nu * ey + nv * ny
        acx = -2 * (-WZ * vcy)
        acy = -2 * (WZ * vcx)
        du = acx * ex + acy * ey
        dv = acx * nx + acy * ny
        nu = nu + du * timestep / CORIOLIS_DIV * cor
        nv = nv + dv * timestep / CORIOLIS_DIV * cor
    nu = cfg["dissipation"] * nu
    nv = cfg["dissipation"] * nv

    wx, wy = (w.to(dt) for w in wind_profile(H, u.device))
    sx = 1.0 + STRESS * torch.abs(wx - nu) ** 2
    sy = 1.0 + STRESS * torch.abs(wy - nv) ** 2
    nu = nu + wx * (1 - sx ** STRESS_EXP) - nu * DRAG
    nv = nv + wy * (1 - sy ** STRESS_EXP) - nv * DRAG
    land = terrain > 0
    return torch.where(land, 0.0, nu), torch.where(land, 0.0, nv)


def _obstacles(terrain):
    return [(S.shift(terrain, dx, dy) > 0).to(terrain.dtype)
            for dx, dy in ((0, 1), (0, -1), (1, 0), (-1, 0))]


def _sweeps(coeffs, b, f, iters: int, pole_sign: float):
    """``iters`` 5-point Jacobi sweeps f' = cN fN + cS fS + cE fE + cW fW
    + cC f (+ b); with ``pole_sign`` -1 the pole neighbours change sign
    (a velocity)."""
    cN, cS, cE, cW, cC = coeffs
    H = f.shape[-2]
    north = torch.zeros((H, 1), dtype=torch.bool, device=f.device)
    south = torch.zeros_like(north)
    north[H - 1] = True
    south[0] = True
    for _ in range(iters):
        fN = S.shift(f, 0, 1)
        fS = S.shift(f, 0, -1)
        if pole_sign < 0:
            fN = torch.where(north, -fN, fN)
            fS = torch.where(south, -fS, fS)
        out = (cN * fN + cS * fS + cE * S.shift(f, 1, 0)
               + cW * S.shift(f, -1, 0) + cC * f)
        f = out + b if b is not None else out
    return f


def diffusion(u, v, terrain, iters: int):
    H, W = u.shape
    dxr, dyr = (t.to(u.dtype) for t in S.pixel_size(H, W, u.device))
    wx = ((420.0 / dxr) ** 2).expand(H, W)
    wy = ((420.0 / dyr) ** 2 * torch.ones_like(dxr)).expand(H, W)
    beta = 2 * (wx + wy) * (1 + 1 / (2 * (wx + wy)))
    oN, oS, oE, oW = _obstacles(terrain)
    coeffs = ((1 - oN) * wy / beta, (1 - oS) * wy / beta,
              (1 - oE) * wx / beta, (1 - oW) * wx / beta,
              (1 + (oN + oS) * wy + (oE + oW) * wx) / beta)
    uv = _sweeps(coeffs, None, torch.stack([u, v]), iters, -1.0)
    return uv[0], uv[1]


def _neighbor_vec(u, v, dx, dy):
    nu = S.shift(u, dx, dy)
    nv = S.shift(v, dx, dy)
    if dx == 0 and dy != 0:
        H = u.shape[-2]
        flip = torch.zeros((H, 1), dtype=torch.bool, device=u.device)
        flip[0 if dy < 0 else H - 1] = True
        nu = torch.where(flip, -nu, nu)
        nv = torch.where(flip, -nv, nv)
    return nu, nv


def divergence(u, v, terrain, cfg: dict):
    H, W = u.shape
    dxr, dyr = (t.to(u.dtype) for t in S.pixel_size(H, W, u.device))
    area = dxr * dyr
    au = u * area * cfg["pressurefactor"]
    av = v * area * cfg["pressurefactor"]
    _, vNy = _neighbor_vec(au, av, 0, 1)
    _, vSy = _neighbor_vec(au, av, 0, -1)
    vEx, _ = _neighbor_vec(au, av, 1, 0)
    vWx, _ = _neighbor_vec(au, av, -1, 0)
    vNy = torch.where(S.shift(terrain, 0, 1) > 0, 0.0, vNy)
    vSy = torch.where(S.shift(terrain, 0, -1) > 0, 0.0, vSy)
    vEx = torch.where(S.shift(terrain, 1, 0) > 0, 0.0, vEx)
    vWx = torch.where(S.shift(terrain, -1, 0) > 0, 0.0, vWx)
    return 0.5 * ((vEx - vWx) / (dxr / 420.0) + (vNy - vSy) / (dyr / 420.0))


def pressure(div, terrain, iters: int):
    H, W = div.shape
    dxr, dyr = (t.to(div.dtype) for t in S.pixel_size(H, W, div.device))
    pw2x = ((dxr / 420.0) ** 2).expand(H, W)
    pw2y = ((dyr / 420.0) ** 2 * torch.ones_like(dxr)).expand(H, W)
    beta = 2 * (1 / pw2x + 1 / pw2y)
    oN, oS, oE, oW = _obstacles(terrain)
    sea = (terrain <= 0).to(div.dtype)
    cx = 1.0 / pw2x / beta
    cy = 1.0 / pw2y / beta
    coeffs = ((1 - oN) * cy * sea, (1 - oS) * cy * sea, (1 - oE) * cx * sea,
              (1 - oW) * cx * sea,
              (oN * cy + oS * cy + oE * cx + oW * cx) * sea)
    b = -div / beta * sea
    return _sweeps(coeffs, b, torch.zeros_like(div), iters, 1.0)


def project(u, v, p, terrain, cfg: dict):
    H, W = u.shape
    dxr, dyr = (t.to(u.dtype) for t in S.pixel_size(H, W, u.device))
    pwx, pwy = dxr / 420.0, dyr / 420.0
    area = dxr * dyr
    oN = S.shift(terrain, 0, 1) > 0
    oS = S.shift(terrain, 0, -1) > 0
    oE = S.shift(terrain, 1, 0) > 0
    oW = S.shift(terrain, -1, 0) > 0
    pN = torch.where(oN, p, S.shift(p, 0, 1))
    pS = torch.where(oS, p, S.shift(p, 0, -1))
    pE = torch.where(oE, p, S.shift(p, 1, 0))
    pW = torch.where(oW, p, S.shift(p, -1, 0))
    fu = u - 0.5 * (pE - pW) / pwx / area / cfg["pressurefactor"]
    fv = v - 0.5 * (pN - pS) / pwy / area / cfg["pressurefactor"]

    # coastal free slip: toward the nearest open direction of eight
    offsets = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1),
               (1, -1)]
    o_arr = [S.shift(terrain, dx, dy) > 0 for dx, dy in offsets]
    theta = torch.remainder((torch.atan2(fv, fu) / S.PI + 1) / 2 * 8 + 4,
                            8.0)
    lower = torch.remainder(torch.floor(theta), 8).to(torch.int32)
    upper = torch.remainder(torch.ceil(theta), 8).to(torch.int32)
    is_border = torch.zeros_like(o_arr[0])
    for i in range(8):
        is_border = is_border | (((lower == i) | (upper == i)) & o_arr[i])
    mag = torch.sqrt(fu * fu + fv * fv)
    best_u, best_v = fu, fv
    difference = torch.full_like(fu, 2 * S.PI)
    for i, (dx, dy) in enumerate(offsets):
        ang = torch.minimum((2 * S.PI) - torch.abs(float(i) - theta),
                            torch.abs(float(i) - theta))
        better = (ang < difference) & ~o_arr[i]
        norm = math.sqrt(dx * dx + dy * dy)
        best_u = torch.where(better, dx / norm * mag, best_u)
        best_v = torch.where(better, dy / norm * mag, best_v)
        difference = torch.where(better, ang, difference)
    fu = torch.where(is_border, best_u, fu)
    fv = torch.where(is_border, best_v, fv)
    land = terrain > 0
    return torch.where(land, 0.0, fu), torch.where(land, 0.0, fv)


def ocean_step(u, v, terrain, cfg: dict):
    """One outer step: (u, v, p)."""
    u, v = advect(u, v, terrain, cfg)
    u, v = diffusion(u, v, terrain, cfg["diffusion_iters"])
    div = divergence(u, v, terrain, cfg)
    p = pressure(div, terrain, cfg["jacobi_iters"])
    u, v = project(u, v, p, terrain, cfg)
    return u, v, p


# ---------------------------------------------------------------------------
# the configuration's interface to the harness
# ---------------------------------------------------------------------------


def init(cfg: dict, terrain):
    z = torch.zeros_like(terrain)
    return {"u": z, "v": z.clone()}


def step(cfg: dict, state: dict, terrain, index: int) -> dict:
    """The state after step ``index`` (1-based) from ``state``, the state
    after step ``index - 1``."""
    u, v, p = ocean_step(state["u"], state["v"], terrain, cfg["ocean"])
    return {"u": u, "v": v, "p": p}
