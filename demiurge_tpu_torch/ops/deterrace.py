"""DeTerrace: remove terracing (quantized steps) from DEMs.

Counterpart of ``demiurge_tpu/ops/deterrace.py`` (the reference's
DeTerrace filter, src/filter/DeTerrace.cpp):

1. for each of 8 directions a log-step sweep (jump-flood style, radii 2^i
   up then down; DeTerrace.cpp:479-531) finds per pixel the id of the
   nearest pixel of another height in a directional cone, without the
   pole wrap (``directional_pid``); ids are int64 flat indices;
2. per pixel, up to 16 neighbour points (each direction's first and
   second hits), the terrace step and curvature, the curvature
   corrections, the dedup, and a thin-plate-spline fit (r^2 log r^2 plus
   an affine part) evaluated at the pixel, clamped to [h, h + step] with
   sea level kept (``deterrace_heights``).  The 19x19 systems are solved
   batched in chunks of ``CHUNK`` pixels by LU without error checks; a
   system with an exactly zero pivot gives NaN, which falls back to
   h + step/2 (the reference relies on its solve returning NaN there,
   which its LU does for most such systems, inf for some);
3. the distance to the nearest step (``distance_field``) drives 10
   iterations of x/y edge-preserving pseudo-gaussian smoothing with taps
   +-1, 2, 3, 5, 8 (``directional_smooth``).

Where a direction finds no pixel of another height, the reference C++
reads out of bounds in its fixed-stride curvature loop
(DeTerrace.cpp:189-199); the reference package, and this port, mask the
invalid entries of the opposite-direction groups instead.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.grid import Grid, rdiv
from ..core.topology import shift

PI = math.pi

#: pixels per batched TPS solve (the reference's chunk; bounds the
#: (CHUNK, 16, 16) dedup mask and the (CHUNK, 19, 19) systems)
CHUNK = 16384
_TPS_EPS = 1e-6

#: (primary, secondary) per sweep (DeTerrace.cpp:128-135)
_SWEEPS = [
    ((1, 1), (1, 0)),     # rightdown
    ((0, 1), (1, 1)),     # downright
    ((-1, 1), (0, 1)),    # downleft
    ((-1, 0), (-1, 1)),   # leftdown
    ((-1, -1), (-1, 0)),  # leftup
    ((0, -1), (-1, -1)),  # upleft
    ((1, -1), (0, -1)),   # upright
    ((1, 0), (1, -1)),    # rightup
]

#: point-list order (DeTerrace.cpp:168): pairs of opposite directions
_DIR_ORDER = ["rightdown", "leftup", "downright", "upleft",
              "downleft", "upright", "leftdown", "rightup"]
_SWEEP_NAMES = ["rightdown", "downright", "downleft", "leftdown",
                "leftup", "upleft", "upright", "rightup"]


def _pid_shift(pid, dx, dy, grid: Grid):
    """A field shifted by (dx, dy) with the poles clamped
    (offset_no_globe_wrap)."""
    return shift(pid, dx, dy, grid, pole_wrap=False)


def _geodist_pid(pid, grid: Grid):
    """geodistance(st, pidToCoord(pid)) in x-pixel units
    (Shader.h:345-355)."""
    H, W = grid.shape
    r = torch.arange(H, device=pid.device).reshape(-1, 1)
    c = torch.arange(W, device=pid.device).reshape(1, -1)
    s1 = (c + 0.5) / W
    t1 = (r + 0.5) / H
    pc = torch.remainder(pid, W)
    pr = pid // W
    s2 = (pc.to(torch.float32) + 0.5) / W
    t2 = (pr.to(torch.float32) + 0.5) / H
    l1, f1 = grid.tex_to_spheric(s1, t1)
    l2, f2 = grid.tex_to_spheric(s2, t2)
    inner = (torch.sin(torch.abs(f2 - f1) / 2) ** 2
             + torch.cos(f1) * torch.cos(f2) * torch.sin((l1 - l2) / 2) ** 2)
    ds = 2 * torch.asin(torch.sqrt(torch.clamp(inner, 0.0, 1.0)))
    return ds / (grid.lam1 - grid.lam0) * W


def _log_radii(grid: Grid) -> list:
    """The sweep's radii: 2^0 .. 2^a, then back down to 2^0."""
    a = int(math.ceil(math.log2(max(grid.shape)))) - 3
    return [2 ** i for i in list(range(a + 1)) + list(range(a, -1, -1))]


def directional_pid(height, grid: Grid, primary, secondary):
    """One directional nearest-other-height sweep (get(),
    DeTerrace.cpp:479-531).  Returns an int64 id field."""
    H, W = grid.shape
    eps = 1e-5
    idx = torch.arange(H * W, device=height.device).reshape(H, W)

    # init: step one primary if the height differs
    hp = _pid_shift(height, primary[0], primary[1], grid)
    pid = torch.where(torch.abs(hp - height) < eps, idx,
                      _pid_shift(idx, primary[0], primary[1], grid))
    h_flat = height.reshape(-1)

    for r in _log_radii(grid):
        min_d = torch.where(pid != idx, _geodist_pid(pid, grid), -1.0)
        for (ox, oy) in (secondary, primary):
            dx, dy = int(ox * r), int(oy * r)
            new_pid = _pid_shift(pid, dx, dy, grid)
            off_idx = _pid_shift(idx, dx, dy, grid)
            nd = _geodist_pid(new_pid, grid)
            take = ((h_flat[new_pid] != height) & (new_pid != off_idx)
                    & ((min_d < 0) | (nd < min_d)))
            min_d = torch.where(take, nd, min_d)
            pid = torch.where(take, new_pid, pid)
    return pid


def all_pids(height, grid: Grid) -> dict:
    """{sweep name: directional_pid} over the 8 sweeps."""
    return {name: directional_pid(height, grid, primary, secondary)
            for name, (primary, secondary) in zip(_SWEEP_NAMES, _SWEEPS)}


def _tovec(pid_i, pid_id, minheight, h_flat, grid: Grid):
    """tovec (DeTerrace.cpp:152-161): displacement and height of the
    target."""
    H, W = grid.shape
    xi = torch.remainder(pid_i, W)
    yi = pid_i // W
    xt = torch.remainder(pid_id, W)
    yt = pid_id // W
    dx = (xt - xi).to(torch.float32)
    if grid.wrap_x:
        dx = torch.where(torch.abs(dx) > W / 2,
                         -torch.sign(dx) * (W - torch.abs(dx)), dx)
    dy = (yt - yi).to(torch.float32)
    ycoord = yi.to(torch.float32) / H
    factor = ycoord * (grid.phi1 - grid.phi0) + grid.phi0
    z = torch.maximum(h_flat[pid_id], minheight)
    return dx * torch.cos(factor), dy, z


@dataclasses.dataclass(frozen=True)
class DeTerraceConfig:
    smooth_iters: int = 10


def _candidates(height, grid: Grid, pids):
    """The 16 candidate points of every pixel with the curvature
    corrections applied: (px, py, pz, valid), each (N, 16), and h, step
    (N,)."""
    H, W = grid.shape
    N = H * W
    h = height.reshape(-1)
    i_idx = torch.arange(N, device=height.device)

    pxs, pys, pzs, valid = [], [], [], []
    for name in _DIR_ORDER:
        lu = pids[name].reshape(-1)
        lu2 = lu[lu]
        x1, y1, z1 = _tovec(i_idx, lu, h, h, grid)
        x2, y2, z2 = _tovec(i_idx, lu2, h[lu], h, grid)
        pxs += [x1, x2]
        pys += [y1, y2]
        pzs += [z1, z2]
        valid += [i_idx != lu, i_idx != lu2]
    px = torch.stack(pxs, -1)
    py = torch.stack(pys, -1)
    pz = torch.stack(pzs, -1)
    val_m = torch.stack(valid, -1)

    # step size: min positive |z - h| over valid points (175-181)
    dzh = torch.abs(pz - h[:, None])
    step = torch.amin(torch.where((dzh > 0) & val_m, dzh, math.inf), -1)
    step = torch.where(torch.isfinite(step), step, 0.0)

    # curvature over 4 groups of (B, A, C, D) = (dir.lu, dir.lu2, opp.lu,
    # opp.lu2) (187-199), partially valid groups masked
    curv = torch.zeros(N, dtype=torch.float32, device=height.device)
    groups = [(4 * g, 4 * g + 1, 4 * g + 2, 4 * g + 3) for g in range(4)]
    for B, A, C, D in groups:
        Ay, By = pz[:, A], pz[:, B]
        Cy, Dy = pz[:, C], pz[:, D]
        Ay_adj = torch.where(Ay == By, Ay + torch.where(Ay > h, step, -step),
                             Ay)
        gv = val_m[:, B] & val_m[:, A]
        curv = curv + torch.where(gv, torch.where(Ay_adj > By, 1.0, -1.0),
                                  0.0)
        Dy_adj = torch.where(Cy == Dy, Dy + torch.where(Dy > h, step, -step),
                             Dy)
        gv2 = val_m[:, C] & val_m[:, D]
        curv = curv + torch.where(gv2, torch.where(Dy_adj > Cy, 1.0, -1.0),
                                  0.0)

    # corrections (201-222)
    delta = step * torch.abs(curv) / 8 * 0.5
    for B, A, C, D in groups:
        A_eq = pz[:, A] == pz[:, B]
        up = (pz[:, A] > h) & (curv > 0)
        dn = (pz[:, A] <= h) & (curv < 0)
        adj = torch.where(A_eq & up, delta,
                          torch.where(A_eq & dn, -delta, 0.0))
        pz[:, A] = pz[:, A] + torch.where(val_m[:, A], adj, 0.0)
        D_eq = pz[:, C] == pz[:, D]
        upD = (pz[:, C] > h) & (curv > 0)
        dnD = (pz[:, C] <= h) & (curv < 0)
        adjD = torch.where(D_eq & upD, delta,
                           torch.where(D_eq & dnD, -delta, 0.0))
        pz[:, D] = pz[:, D] + torch.where(val_m[:, D], adjD, 0.0)

    # drop self references (x == 0 and y == 0)
    val_m = val_m & ~((px == 0) & (py == 0))
    return px, py, pz, val_m, h, step


def _dedup(cpx, cpy, cpz, cvm):
    """Drop duplicates by (x, y), keeping the min-z of each group
    (DeTerrace.cpp:224-231)."""
    K = cpx.shape[1]
    same_xy = ((cpx[:, :, None] == cpx[:, None, :])
               & (cpy[:, :, None] == cpy[:, None, :]))
    both = cvm[:, :, None] & cvm[:, None, :]
    zi = cpz[:, :, None]
    zj = cpz[:, None, :]
    ii = torch.arange(K, device=cpx.device)[:, None]
    jj = torch.arange(K, device=cpx.device)[None, :]
    beats_me = same_xy & both & ((zj < zi) | ((zj == zi) & (jj < ii)))
    return cvm & ~torch.any(beats_me, -1)


def _tps_system(cpx, cpy, cpz, cvm):
    """The thin-plate-spline systems (A (C, 19, 19), b (C, 19)) of a chunk
    of pixels (DeTerrace.cpp:237-313): fixed size 19, the rows and columns
    of invalid points replaced by identity."""
    C, K = cpx.shape
    M = K + 3
    dev = cpx.device
    dx2 = ((cpx[:, :, None] - cpx[:, None, :]) ** 2
           + (cpy[:, :, None] - cpy[:, None, :]) ** 2)
    rbf = dx2 * torch.log(dx2 + _TPS_EPS)
    A = torch.zeros((C, M, M), dtype=torch.float32, device=dev)
    A[:, :K, :K] = rbf
    A[:, :K, K] = 1.0
    A[:, K, :K] = 1.0
    A[:, :K, K + 1] = cpx
    A[:, K + 1, :K] = cpx
    A[:, :K, K + 2] = cpy
    A[:, K + 2, :K] = cpy
    diag = torch.arange(M, device=dev)
    A[:, diag, diag] = 0.0

    vm = torch.cat([cvm, torch.ones((C, 3), dtype=torch.bool, device=dev)],
                   -1)
    A = torch.where(vm[:, :, None] & vm[:, None, :], A, 0.0)
    A[:, diag, diag] += torch.where(vm, 0.0, 1.0)
    b = torch.cat([torch.where(cvm, cpz, 0.0),
                   torch.zeros((C, 3), dtype=torch.float32, device=dev)], -1)
    return A, b


def _tps_solve(A, b):
    """The batched LU solve.  A system with an exactly zero pivot is
    singular and gives NaN (so the caller's fallback applies), whatever
    the LU library would make of the division by zero."""
    x, info = torch.linalg.solve_ex(A, b[..., None], check_errors=False)
    return torch.where((info > 0)[:, None], math.nan, x[..., 0])


def _tps_value(x, cpx, cpy, cvm):
    """The spline at the pixel (0, 0): the constant term plus each valid
    point's r^2 log r^2 term.  The terms are summed in point order, as
    the reference's reduction does: near-singular systems give terms of
    ~1e6 that cancel, so the order decides the value."""
    K = cpx.shape[1]
    r2 = cpx * cpx + cpy * cpy
    terms = torch.where(cvm, x[:, :K] * r2 * torch.log(r2 + _TPS_EPS), 0.0)
    total = terms[:, 0]
    for k in range(1, K):
        total = total + terms[:, k]
    return x[:, K] + total


def _tps_chunk(cpx, cpy, cpz, cvm):
    """A chunk's spline values at its pixels (DeTerrace.cpp:224-316)."""
    cvm = _dedup(cpx, cpy, cpz, cvm)
    A, b = _tps_system(cpx, cpy, cpz, cvm)
    return _tps_value(_tps_solve(A, b), cpx, cpy, cvm)


def _clamp_heights(val, h, step):
    """Fallback and clamps (DeTerrace.cpp:327-334): NaN -> h + step/2,
    then [h, h + step], below sea level at most -eps, above it at least
    0."""
    val = torch.where(torch.isnan(val), h + step / 2, val)
    val = torch.minimum(torch.maximum(val, h), h + step)
    return torch.where(h < 0, torch.clamp(val, max=-_TPS_EPS),
                       torch.clamp(val, min=0.0))


def deterrace_heights(height, grid: Grid, pids):
    """Step 2: the per-pixel TPS fit, batched (DeTerrace.cpp:144-337).

    pids: dict name -> (H, W) int64 from ``directional_pid``.  Returns the
    new heightfield (before the smoothing)."""
    px, py, pz, val_m, h, step = _candidates(height, grid, pids)
    N = h.shape[0]
    val = torch.cat([_tps_chunk(px[i:i + CHUNK], py[i:i + CHUNK],
                                pz[i:i + CHUNK], val_m[i:i + CHUNK])
                     for i in range(0, N, CHUNK)])

    return _clamp_heights(val, h, step).reshape(grid.shape)


def distance_field(grid: Grid, pids):
    """The distance map (updateDistance, DeTerrace.cpp:564-600)."""
    dist = None
    for name in _SWEEP_NAMES:
        d = _geodist_pid(pids[name], grid)
        if dist is None:
            dist = torch.full_like(d, 1e21)
        dist = torch.where(d > 0, torch.minimum(d, dist), dist)
    return dist


# float32 sqrt(2 pi), as the reference's jnp.sqrt of the constant rounds it
_SQRT_2PI = float(np.sqrt(np.float32(2 * PI)))


def _pg(r: float, sigma):
    """The pseudo-gaussian weight of tap distance r at width sigma."""
    return (1.0 / (sigma * _SQRT_2PI)
            * torch.exp(rdiv(-0.5 * r * r, sigma * sigma)))


def directional_smooth(new_h, old_h, dist, grid: Grid, iters: int = 10):
    """Edge-preserving directional pseudo-gaussian
    (DeTerrace.cpp:389-467)."""
    d = torch.pow(dist / 5.0, 1.5)

    def one_pass(cur, axis):
        weight = _pg(0.0, d)
        val = cur * weight
        for k in (1, 2, 3, 5, 8):
            w = _pg(float(k), d)
            for sgn in (1, -1):
                o = (sgn * k, 0) if axis == 0 else (0, sgn * k)
                oldT = shift(old_h, o[0], o[1], grid)
                newT = shift(cur, o[0], o[1], grid)
                edge = torch.abs(oldT - old_h) > 1e-6
                val = val + torch.where(edge, 5 * w * cur, w * newT)
                weight = weight + torch.where(edge, 5 * w, w)
        return val / weight

    h = new_h
    for _ in range(iters):
        h = one_pass(h, 0)
        h = one_pass(h, 1)
    return h


def deterrace(height, grid: Grid, cfg: DeTerraceConfig = DeTerraceConfig()):
    """The full DeTerrace pipeline."""
    pids = all_pids(height, grid)
    new_h = deterrace_heights(height, grid, pids)
    dist = distance_field(grid, pids)
    return directional_smooth(new_h, height, dist, grid, cfg.smooth_iters)
