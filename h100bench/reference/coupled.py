"""Plain reference of one coupled step (``coupled`` configuration): the
climate, the ocean and the landscape, plain PyTorch on any device and in
any float dtype.

A step reads the terrain h and advances

  1. the surface temperature T by ``climate_substeps`` explicit substeps
     of the energy balance: absorbed shortwave (1 - albedo) * QDay(phi, M)
     by row, outgoing longwave 210 * 0.93 * (T + 273.15)^4 / 273.4^4, and
     transport D * lap(T), lap the spherical 9-point Laplacian's
     x + y sum, whose straight taps cancel: 2 (left + right) - 8 T with
     left/right the sum of the north and south rows at the nearest
     column 1/cos(phi) pixels away; times dt / C, C the land or ocean
     heat capacity;
  2. the ocean currents by one outer step (``reference/ocean.py``);
  3. the landscape: the heights pre-blurred (a separable spherical
     13-tap Gaussian), a D8 direction per pixel (the aspect of the Sobel
     gradient quantized to an octant with a hashed tie break, else the
     steepest descent; 0 in the ocean, 5 a sink), the upstream area A of
     every pixel over the drainage forest and whether its path reaches a
     river mouth; the flow map A^exponent where it does, -1 elsewhere;
     then one stream-power erosion pass against the uplift.

The area and the reachability are computed by pointer doubling over the
downstream pointers, not by the program's relaxation: the same sums, in
another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import ocean as ocean_ref
from . import sphere as S

# -- climate ------------------------------------------------------------------

S0, ECC = 1365.0, 0.017
GAMMA = 23.44 / 180.0 * math.pi
OMEGA2 = 77.05 / 180.0 * math.pi
DT_YEAR = 3.154e7 / 15000          # seconds a substep
OLR_COEF = float(np.float32(210.0 * 0.93 / 273.4 ** 4))


def qday(phi, M):
    """Daily-mean insolation; the equation of centre as the model writes
    it (its ``2e`` term is a constant)."""
    A = M + (2 * ECC - ECC ** 3 / 4 * torch.sin(M)
             + 5.0 / 4 * ECC ** 2 * torch.sin(2 * M)
             + 13.0 / 12 * ECC ** 3 * torch.sin(3 * M))
    delt = torch.asin(math.sin(GAMMA) * torch.sin(A - OMEGA2))
    polar = torch.where(torch.sign(phi) == torch.sign(delt), math.pi, 0.0)
    interior = torch.abs(phi) <= math.pi / 2 - torch.abs(delt)
    arg = torch.clamp(-torch.tan(phi) * torch.tan(delt), -1.0, 1.0)
    h = torch.where(interior, torch.acos(arg), polar)
    return S0 * (1 + 2 * ECC * torch.cos(A)) / math.pi * (
        h * torch.sin(phi) * torch.sin(delt)
        + torch.cos(phi) * torch.cos(delt) * torch.sin(h))


def climate(T, terrain, first: int, substeps: int, albedo: float = 0.30,
            diffusivity: float = 0.55e6):
    H, W = T.shape
    dt = T.dtype
    i0 = torch.full((), float(first), dtype=torch.float32, device=T.device)
    k = torch.arange(substeps, dtype=torch.float32, device=T.device)
    M = (2.0 * math.pi / 15000) * (i0 + k)
    phi = S.row_phi(H, T.device).reshape(1, -1)
    asr = ((1.0 - albedo) * qday(phi, M.reshape(-1, 1))).to(dt)
    C = (1e7 + torch.where(terrain > 0, 1e7 * 0.5, 4 * 1.5 * 1e7)).to(dt)
    cinv = DT_YEAR / C
    ic = S.inv_cos_rows(H)
    kneg = np.floor(np.float32(0.5) - ic).astype(np.int64)
    kpos = np.floor(np.float32(0.5) + ic).astype(np.int64)
    dy = np.float32(S.row_spacing(H))
    D = float(np.float32(diffusivity) / (np.float32(4.0) * dy * dy))
    for s in range(substeps):
        N = S.shift(T, 0, 1) + S.shift(T, 0, -1)
        lap = 2.0 * (S.roll_rows(N, kneg) + S.roll_rows(N, kpos)) - 8.0 * T
        Tk = T + 273.15
        T2 = Tk * Tk
        T = T + (asr[s].reshape(-1, 1) - OLR_COEF * (T2 * T2) + D * lap) \
            * cinv
    return T


# -- flow ---------------------------------------------------------------------

_OFFSETS = (1.411764705882353, 3.2941176470588234, 5.176470588235294)
_W0 = 0.1964825501511404
_WEIGHTS = (0.2969069646728344, 0.09447039785044732, 0.010381362401148057)


def sigma_list(radius: float) -> list:
    """The blur's per-iteration radii: the variance (radius / 4)^2 / 2
    split into squares."""
    radius = radius / 2.0
    R = radius * radius / 2.0
    out, i, inc = [], 1.0, 0.5
    if R < 3:
        k = 1.0 / math.sqrt(55.0 / R) if R > 0 else 0.0
        if k == 0.0:
            return []
        inc = i = k
    while R >= i * i:
        R -= i * i
        out.append(i)
        i += inc
    if R > 0.0:
        out.append(math.sqrt(R))
    return sorted(out)


def blur(f, radius: float):
    """Per radius a vertical 13-tap pass (rows lerped through the poles),
    then a horizontal one (per-row column offsets stretched by
    1/cos|phi|, periodic)."""
    H, W = f.shape
    t = (np.arange(H, dtype=np.float32) + np.float32(0.5)) / np.float32(H)
    pf = np.cos(np.abs(t * np.float32(S.PHI1 - S.PHI0) + np.float32(S.PHI0)))
    for r in sigma_list(radius):
        out = f * _W0
        for off, w in zip(_OFFSETS, _WEIGHTS):
            for sign in (1.0, -1.0):
                oy = sign * off * r
                k = math.floor(oy)
                fr = oy - k
                tap = S.shift(f, 0, k)
                if fr != 0.0:
                    tap = tap * (1.0 - fr) + S.shift(f, 0, k + 1) * fr
                out = out + tap * w
        f = out
        out = f * _W0
        for off, w in zip(_OFFSETS, _WEIGHTS):
            for sign in (1.0, -1.0):
                dx = np.float32(sign * off * r) / pf
                k = np.floor(dx).astype(np.int64)
                fr = torch.from_numpy((dx - k).astype(np.float32)).reshape(
                    -1, 1).to(f.device, f.dtype)
                r0 = S.roll_rows(f, k)
                tap = r0 * (1.0 - fr) + torch.roll(r0, -1, dims=-1) * fr
                out = out + tap * w
        f = out
    return f


def _fma(x, a: float, b: float):
    """float32 x * a + b rounded once (exact in float64 for these x)."""
    a, b = float(np.float32(a)), float(np.float32(b))
    return (x.to(torch.float64) * a + b).to(torch.float32)


def tie_break(H: int, W: int, device):
    """The hashed value noise at the lattice points (2c + 1, 2r + 1)."""
    c = torch.arange(W, dtype=torch.float32, device=device)
    r = torch.arange(H, dtype=torch.float32, device=device)
    px = (2 * c + 1).reshape(1, -1).expand(H, W)
    py = (2 * r + 1).reshape(-1, 1).expand(H, W)

    def fract(x):
        return x - torch.floor(x)

    px = 50.0 * fract(_fma(px, 0.3183099, 0.71))
    py = 50.0 * fract(_fma(py, 0.3183099, 0.113))
    return (-1.0 + 2.0 * fract(px * py * (px + py))) * 0.5 + 0.5


def directions(hb, sel):
    """D8 codes (int32): 0 ocean or unselected, 5 sink, else the keypad
    code of the downstream neighbour.  On the pole-clamped grid whose
    corner latitudes are pulled in by 1e-3."""
    H, W = hb.shape
    a = hb
    p0, p1 = S.PHI0 + 1e-3, S.PHI1 - 1e-3
    dxr, dyr = (t.to(a.dtype) for t in S.pixel_size(H, W, a.device, p0, p1))
    nb = {d: S.shift(a, d[0], d[1], poles=False) for d in S.SCAN}
    # the Sobel gradient, x negated as the model has it
    A_, B_, C_ = nb[(-1, -1)], nb[(0, -1)], nb[(1, -1)]
    D_, F_ = nb[(-1, 0)], nb[(1, 0)]
    G_, H_, I_ = nb[(-1, 1)], nb[(0, 1)], nb[(1, 1)]
    gx = (-(C_ + 2 * F_ + I_) + (A_ + 2 * D_ + G_)) / (8 * dxr)
    gy = ((G_ + 2 * H_ + I_) - (A_ + 2 * B_ + C_)) / (8 * dyr)
    aspect = math.pi - torch.atan2(gy, -gx)
    lower = torch.floor(aspect / (2 * math.pi) * 8) / 8 * (2 * math.pi)
    upper = torch.ceil(aspect / (2 * math.pi) * 8) / 8 * (2 * math.pi)
    prob = torch.abs(aspect - lower) / math.pi * 4
    asp = torch.where(tie_break(H, W, a.device).to(a.dtype) < prob, upper,
                      lower)
    dirx = torch.round(torch.cos(asp)).to(torch.int32)
    diry = -torch.round(torch.sin(asp)).to(torch.int32)
    code = 5 + dirx + 3 * diry

    ns = {d: S.shift(sel, d[0], d[1], poles=False) for d in S.SCAN}
    a2 = torch.full_like(a, math.inf)
    s2 = torch.ones_like(a)
    for d in S.SCAN:
        m = (dirx == d[0]) & (diry == d[1])
        a2 = torch.where(m, nb[d], a2)
        s2 = torch.where(m, ns[d], s2)
    aspect_code = torch.where((a2 <= 0.0) | (s2 == 0.0), 5, code)
    best_code = torch.full_like(code, 5)
    best_a, best_s = a, torch.ones_like(a)
    for d in S.SCAN:
        better = nb[d] < best_a
        best_code = torch.where(better, 5 + d[0] + 3 * d[1], best_code)
        best_s = torch.where(better, ns[d], best_s)
        best_a = torch.where(better, nb[d], best_a)
    scan_code = torch.where((best_a <= 0.0) | (best_s == 0.0), 5, best_code)
    code = torch.where(a2 < a, aspect_code, scan_code)
    return torch.where((a > 0.0) & (sel != 0.0), code, 0).to(torch.int32)


def downstream(code):
    """Flat index of each pixel's downstream neighbour, -1 for none: a
    sink, the ocean, or a target row beyond the grid (no pole crossing;
    x periodic)."""
    H, W = code.shape
    r = torch.arange(H, device=code.device).reshape(-1, 1)
    c = torch.arange(W, device=code.device).reshape(1, -1)
    parent = torch.full((H, W), -1, dtype=torch.int64, device=code.device)
    for k, (dx, dy) in S.OFFSET.items():
        if k == 5:
            continue
        nr = r + dy
        ok = (code == k) & (nr >= 0) & (nr < H)
        parent = torch.where(ok, nr * W + torch.remainder(c + dx, W), parent)
    return parent.reshape(-1)


def mouths(code):
    """Interesting pixels with an ocean (code 0) neighbour, the neighbours
    taken across the poles."""
    m = torch.zeros(code.shape, dtype=torch.bool, device=code.device)
    for dx, dy in S.SCAN:
        m = m | (S.shift(code, dx, dy) == 0)
    return m & (code > 0)


def upstream_sum(parent, area):
    """area[p] plus the area of every pixel whose downstream path reaches
    p, by pointer doubling: after round k, A sums the pixels within 2^k - 1
    steps upstream, ptr is the 2^k-th ancestor where ``alive``."""
    N = parent.shape[0]
    A = area
    alive = parent >= 0
    ptr = torch.where(alive, parent, 0)
    for _ in range(max(1, math.ceil(math.log2(max(N, 2))))):
        add = torch.zeros(N + 1, dtype=A.dtype, device=A.device)
        add.index_add_(0, torch.where(alive, ptr, N),
                       torch.where(alive, A, 0.0))
        A = A + add[:N]
        nxt = alive & alive[ptr]
        ptr = torch.where(nxt, ptr[ptr], ptr)
        alive = nxt
        if not bool(alive.any()):
            break
    return A


def reaches(parent, mark):
    """Whether a pixel's downstream path (itself included) holds a marked
    pixel, by pointer doubling."""
    N = parent.shape[0]
    alive = parent >= 0
    ptr = torch.where(alive, parent, torch.arange(N, device=parent.device))
    vis = mark
    for _ in range(max(1, math.ceil(math.log2(max(N, 2))))):
        vis = vis | vis[ptr]
        ptr = ptr[ptr]
    return vis


def cell_area(H: int, W: int, device, dtype, scale: float = 1e-5):
    """The pixel area with the latitude of the row's lower edge."""
    y = torch.arange(H, dtype=torch.float32, device=device).reshape(-1, 1) / H
    geoy = y * (S.PHI1 - S.PHI0) + S.PHI0
    pwx = S.CIRCUMFERENCE * (S.LAM1 - S.LAM0) / (2 * math.pi) / W
    pwy = S.CIRCUMFERENCE * (S.PHI1 - S.PHI0) / (2 * math.pi) / H
    area = pwy * pwx * torch.clamp(torch.cos(geoy), min=0.0) * scale
    return area.expand(H, W).to(dtype)


def flow(h, sel, exponent: float, preblur: float):
    """(flow map, A): A^exponent where the path reaches a mouth, else -1."""
    code = directions(blur(h, preblur), sel)
    parent = downstream(code)
    H, W = h.shape
    A = upstream_sum(parent, cell_area(H, W, h.device, h.dtype).reshape(-1))
    vis = reaches(parent, mouths(code).reshape(-1))
    A, vis = A.reshape(H, W), vis.reshape(H, W)
    return torch.where(vis, torch.pow(A, exponent), -1.0), A


# -- erosion ------------------------------------------------------------------


def erosion(h, fm, uplift, factor: float, slope_exponent: float):
    """The steepest slope to the 8 neighbours, the 30-degree cap and the
    stream-power incision against the uplift, on land."""
    H, W = h.shape
    dxr, dyr = (t.to(h.dtype) for t in S.pixel_size(H, W, h.device))
    maxslope = torch.zeros_like(h)
    dist = torch.sqrt(dxr * dxr + dyr * dyr) * torch.ones_like(h)
    for dx, dy in S.SCAN:
        ndist = torch.sqrt((dxr * dx) ** 2 + (dyr * dy) ** 2) \
            * torch.ones_like(h)
        s = (h - S.shift(h, dx, dy)) / ndist
        better = s > maxslope
        maxslope = torch.where(better, s, maxslope)
        dist = torch.where(better, ndist, dist)
    slope = math.tan(math.pi / 2 / 3)
    hdiff = slope * dist - maxslope * dist
    eros = factor * 4.0 * fm * torch.pow(maxslope, slope_exponent) \
        / (0.1 ** slope_exponent) * 0.1
    hnew = h + torch.minimum(hdiff, torch.clamp(uplift - eros, min=0.0))
    return torch.where(h <= 0, h, hnew)


# -- the configuration's interface to the harness ----------------------------


def init(cfg: dict, terrain):
    z = torch.zeros_like(terrain)
    return {"height": torch.where(terrain <= 0, terrain, terrain / 50),
            "u": z, "v": z.clone(),
            "temperature": torch.full_like(terrain, 50.0)}


def step(cfg: dict, state: dict, terrain, index: int) -> dict:
    """The state after step ``index`` (1-based) from ``state``, the state
    after step ``index - 1``; the uplift is worked out from the terrain."""
    c = cfg["coupled"]
    h = state["height"]
    uplift = torch.clamp(terrain, min=0.0) / 50
    n = c["climate_substeps"]
    T = climate(state["temperature"], h, (index - 1) * n, n)
    u, v, _ = ocean_ref.ocean_step(state["u"], state["v"], h, cfg["ocean"])
    fm, A = flow(h, torch.ones_like(h), c["flow_exponent"],
                 c["flow_preblur"])
    h = erosion(h, fm, uplift, c["erosion_factor"],
                c["erosion_slope_exponent"])
    return {"height": h, "u": u, "v": v, "temperature": T, "flow_acc": A}
