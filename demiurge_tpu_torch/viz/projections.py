"""Cartographic projections (inverse transforms) and the canvas pipeline.

Counterpart of ``demiurge_tpu/viz/projections.py`` (the reference's
src/projections/).  Rendering is an *inverse* projection: each screen pixel
maps to the projection plane, then to (lambda, phi) through the
projection's ``inverse(x, y) -> (lam, phi, oob)``, through the oblique
rotation, and to texture coords, with out-of-bounds discard
(Canvas.cpp:188-291).  The whole screen is one batch of torch ops on the
field's device, and the resample at the end is a gather
(``core.topology.sample_nearest`` / ``sample_bilinear``).

Float32 throughout, rounded as the reference rounds it.  The reference
jits the whole screen (``project_field``), and XLA turns a division by a
constant into a product with the constant's float32 reciprocal; a single
point (``inverse_point``, the globe's mouse position) it evaluates op by
op, where a division is a true one.  ``_div`` does each: a product with
the reciprocal on a batch, a true division on a 0-d tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.grid import Grid
from ..core.topology import sample_bilinear, sample_nearest

PI = math.pi


def _div(a, c: float):
    """``a / c`` for a Python number ``c``: the product with the float32
    reciprocal on a batch (the jitted reference's rounding, and torch's own
    on the card), a true division on a 0-d tensor or a Python number (the
    reference's op-by-op single point)."""
    if not isinstance(a, torch.Tensor):
        return a / c
    if a.dim() == 0:
        return a / torch.full_like(a, c)
    return a * float(np.float32(1.0) / np.float32(c))


# ---------------------------------------------------------------------------
# inverse transforms (x, y in projection plane -> lambda, phi, out-of-bounds)
# ---------------------------------------------------------------------------


def _equirectangular(x, y):
    """Equiretangular.cpp:12-31 — identity."""
    oob = (torch.abs(x) > PI) | (torch.abs(y) > PI / 2)
    return x, y, oob


def _mollweide(x, y):
    """Mollweide.cpp:12-36."""
    theta = torch.asin(torch.clamp(_div(y, math.sqrt(2)), -1.0, 1.0))
    phi = torch.asin(torch.clamp(
        _div(2 * theta + torch.sin(2 * theta), PI), -1.0, 1.0))
    lam = PI * x / (2 * math.sqrt(2) * torch.cos(theta))
    oob = (torch.abs(y) > math.sqrt(2)) | (torch.abs(lam) > PI)
    return lam, phi, oob


def _hammer(x, y):
    """Hammer.cpp:11-34."""
    z2 = 1 - (0.25 * x) ** 2 - (0.5 * y) ** 2
    z = torch.sqrt(torch.clamp(z2, min=0.0))
    phi = torch.asin(torch.clamp(y * z, -1.0, 1.0))
    lam = 2 * torch.atan(z * x / (2 * (2 * z * z - 1)))
    oob = x * x + 4 * y * y > 8
    return lam, phi, oob


_ROBINSON_PHI = [
    0.0, 80.29654191024038, 4.4182059926979615, -9.482454267304215,
    -2.273688885131101, 5.7531702276094645, 9.123630935057466,
    8.03779851994844, 4.225229524360806, -0.5536195511397848,
    -4.935999809442544, -8.000253639940851, -9.191625360964318,
    -8.228077452618464, -5.017647716143937, 0.4056148595412977,
    7.928403995625608, 17.39105788291159,
]
_ROBINSON_X = [
    1.0000121679737832, -0.00019002309314508636, -2.49324010104246e-06,
    -4.555004740308677e-06, 2.8379397871980405e-07, -9.488976528680172e-09,
    1.6197731015047832e-10, -1.357953005850529e-12, 4.453521631460094e-15,
]


def _robinson(x, y):
    """Robinson.cpp:12-61 — polynomial fits phi(y) and x(phi)."""
    t = torch.ones_like(y)
    phi = torch.full_like(y, _ROBINSON_PHI[0])
    for c in _ROBINSON_PHI[1:]:
        t = _div(t * torch.abs(y), 1.3523)
        phi = phi + c * t
    u = torch.ones_like(phi)
    lam_den = torch.full_like(phi, _ROBINSON_X[0])
    for c in _ROBINSON_X[1:]:
        u = u * torch.abs(phi)
        lam_den = lam_den + c * u
    lam = _div(x, 0.8487) / lam_den
    phi = _div(torch.sign(y) * phi, 180) * PI
    oob = (torch.abs(lam) > PI) | (torch.abs(y) > 1.3523)
    return lam, phi, oob


def _sinusoidal(x, y):
    """Sinusoidal.cpp:12-35."""
    phi = y
    lam = x / torch.cos(phi)
    oob = (lam < -3.14159) | (lam > 3.14159) | (torch.abs(y) > PI / 2)
    return lam, phi, oob


def _goode(x, y):
    """GoodeHomolosine.cpp:12-63."""
    phi0 = y
    lam0 = x / torch.cos(phi0)
    k = 1.19321014759578607280098010649700264274
    k2 = 0.930871
    cx = x * k * k2
    cy0 = y * k
    cy = ((torch.abs(cy0) - 0.711 * k) * k2 + 0.711 * k) * torch.sign(cy0)
    theta = torch.asin(torch.clamp(_div(cy * 2, PI), -1.0, 1.0))
    lam_m = 2 * math.sqrt(2) * cx / (2 * math.sqrt(2) * torch.cos(theta))
    phi_m = torch.asin(torch.clamp(
        _div(2 * theta + torch.sin(2 * theta), PI), -1.0, 1.0))
    hi = torch.abs(phi0) > 0.711
    lam = torch.where(hi, lam_m, lam0)
    phi = torch.where(hi, phi_m, phi0)
    oob = (lam < -3.14159) | (lam > 3.14159) | (torch.abs(cy) > PI / 2)
    return lam, phi, oob


def _eckert_iv(x, y):
    """EckertIV.cpp:13-45."""
    theta = torch.asin(torch.clamp(
        _div(y * math.sqrt(4 + PI), 2 * math.sqrt(PI)), -1.0, 1.0))
    phi = torch.asin(torch.clamp(_div(
        theta + torch.sin(theta) * torch.cos(theta) + 2 * torch.sin(theta),
        2 + PI / 2), -1.0, 1.0))
    lam = x * math.sqrt(4 * PI + PI * PI) / (2 * (1 + torch.cos(theta)))
    oob = (torch.abs(y) > 2 * math.sqrt(PI / (4 + PI))) | (torch.abs(lam) > PI)
    return lam, phi, oob


def _mercator(x, y):
    """Mercator.cpp:12-30 — phi = 2 atan(e^y) - pi/2."""
    phi = 2 * torch.atan(torch.exp(y)) - PI / 2
    lam = x
    oob = torch.abs(lam) > PI
    return lam, phi, oob


def _orthographic(x, y):
    """The standard orthographic inverse over the visible hemisphere
    (x^2 + y^2 <= 1): c = asin(rho), phi = asin(y sin(c) / rho),
    lam = atan2(x sin(c), rho cos(c)).  The reference's first, overwritten
    estimates are not computed."""
    r2 = x * x + y * y
    rho = torch.sqrt(torch.clamp(r2, min=1e-12))
    c = torch.asin(torch.clamp(rho, 0.0, 1.0))
    phi = torch.asin(torch.clamp(torch.where(rho > 0, y * torch.sin(c) / rho,
                                             0.0), -1.0, 1.0))
    lam = torch.atan2(x * torch.sin(c), rho * torch.cos(c))
    oob = r2 > 1.0
    return lam, phi, oob


@dataclasses.dataclass(frozen=True)
class Projection:
    name: str
    inverse: callable
    scale: Tuple[float, float]
    limits: Tuple[float, float]
    interruptible: bool = False


PROJECTIONS = {
    "equirectangular": Projection("equirectangular", _equirectangular,
                                  (PI, PI), (1.0, 0.5)),
    "mollweide": Projection("mollweide", _mollweide,
                            (2 * math.sqrt(2), 2 * math.sqrt(2)), (1.0, 0.5),
                            True),
    "hammer": Projection("hammer", _hammer,
                         (math.sqrt(8), 2 * math.sqrt(2)), (1.0, 0.5), True),
    "robinson": Projection("robinson", _robinson, (1.0, 1.0),
                           (PI * 0.8487, 1.3523)),
    "sinusoidal": Projection("sinusoidal", _sinusoidal, (PI, PI), (1.0, 0.5),
                             True),
    "goode": Projection("goode", _goode, (PI, PI), (1.0, 0.5), True),
    "eckert4": Projection(
        "eckert4", _eckert_iv,
        (2 * PI * 2 / math.sqrt(4 * PI + PI * PI),
         4 * math.sqrt(PI / (4 + PI))), (1.0, 0.5), True),
    "mercator": Projection("mercator", _mercator, (PI, PI), (1.0, 0.5)),
    "orthographic": Projection("orthographic", _orthographic,
                               (1.2, 1.2), (1.0, 1.0)),
    # aspect-true flat view of the raw texture (img.cpp:14-148) — its own
    # screen->tex mapping (perspective-projected quad), see _img_screen_to_tex
    "img": Projection("img", None, (1.0, 1.0), (1.0, 1.0)),
}


# ---------------------------------------------------------------------------
# img flat view (img.cpp:14-148)
# ---------------------------------------------------------------------------

#: camera constants of the img canvas (img.cpp:38-43)
_IMG_FOVY = math.radians(60.0)
_IMG_TANFOV = math.tan(_IMG_FOVY * 0.5)


def _img_screen_to_tex(params: "CanvasParams", grid: Grid, nx, ny):
    """The raw-texture quad view: an aspect-true quad (half-extents
    (W/H, 1)) at distance ``params.zoom`` from a 60-degree-FOV perspective
    camera, panned by ``params.offset`` clamped to the quad (img.cpp:14-43,
    71-107).  nx/ny are y-up NDC coords (tensors, or Python numbers for one
    point, as the reference's mouse inverse passes them).  Texture t=0 maps
    to the TOP of the quad (img.cpp:23-28), as in the reference."""
    aspect = grid.width / grid.height
    d = params.zoom
    px = min(max(params.offset[0], -aspect), aspect)   # pan clamp (72-79)
    py = min(max(params.offset[1], -1.0), 1.0)
    qx = nx * _IMG_TANFOV * params.window_aspect * d - px
    qy = ny * _IMG_TANFOV * d - py
    s = _div(qx + aspect, 2 * aspect)
    t = _div(1.0 - qy, 2.0)
    oob = (s < 0) | (s > 1) | (t < 0) | (t > 1)
    return s, t, oob


# ---------------------------------------------------------------------------
# canvas pipeline (Canvas.cpp:188-291)
# ---------------------------------------------------------------------------


def rotation_matrix_euler(theta: float, phi: float, rho: float) -> np.ndarray:
    """globeRotation — Canvas.cpp:286-291: Rz(theta) @ Ry(phi) @ Rx(rho),
    float32."""
    ct, st = math.cos(theta), math.sin(theta)
    cp, sp = math.cos(phi), math.sin(phi)
    cr, sr = math.cos(rho), math.sin(rho)
    Rz = np.array([[ct, -st, 0], [st, ct, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return (Rz @ Ry @ Rx).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CanvasParams:
    projection: str = "equirectangular"
    zoom: float = 1.0
    offset: Tuple[float, float] = (0.0, 0.0)   # xyoffset
    window_aspect: float = 1.0
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # theta, phi, rho
    #: interrupted projections (Canvas.cpp:220-260): per-hemisphere lobe
    #: boundaries + central meridians in degrees:
    #: (north_bounds, north_centers, south_bounds, south_centers), where
    #: bounds has one more entry than centers.  None = uninterrupted.
    interruptions: Optional[Tuple[Tuple[float, ...], Tuple[float, ...],
                                  Tuple[float, ...], Tuple[float, ...]]] = None
    #: orthographic globe rotation state (delta_theta, delta_phi) — the
    #: reference Orthographic canvas's Rz(theta)*Rx(phi) drag rotation
    #: (Orthographic.cpp:71-96).  None = use the generic path.
    ortho_state: Optional[Tuple[float, float]] = None


# ---------------------------------------------------------------------------
# orthographic globe canvas (Orthographic.cpp) — sphere pick + drag rotate
# ---------------------------------------------------------------------------


def _ortho_globe_screen_to_tex(params: CanvasParams, grid: Grid, x, y):
    """The reference orthographic projection shader
    (Orthographic.cpp:122-169): sphere pick (x, y, sqrt(1-r^2)) rotated by
    Rz(delta_theta) @ Rx(delta_phi), then mapped to tex coords with the
    theta-pi offset normalization.  x/y are plane coords (already scaled by
    zoom and aspect), float32 tensors."""
    dt, dp = params.ortho_state
    r = torch.sqrt(x * x + y * y)
    z = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    cdt, sdt = math.cos(dt), math.sin(dt)
    cdp, sdp = math.cos(dp), math.sin(dp)
    # Rx(dp): (x, c y - s z, s y + c z); then Rz(dt)
    ry = cdp * y - sdp * z
    rz = sdp * y + cdp * z
    cx = cdt * x - sdt * ry
    cy = sdt * x + cdt * ry
    phi = torch.asin(torch.clamp(rz, -1.0, 1.0))      # -asin(-coord.z)
    theta = torch.atan2(cy, cx)
    t = _div(phi - grid.phi0, grid.phi1 - grid.phi0)
    s = _div(torch.remainder(theta, 2 * PI) - grid.lam0 - PI,
             grid.lam1 - grid.lam0)
    oob = (r > 1.0) | (t < 0) | (t > 1) | (s < 0) | (s > 1)
    return s, t, oob


def _f32(v: float) -> torch.Tensor:
    """A 0-d float32 tensor on the CPU: one point, as the reference's
    ``jnp.float32`` scalars."""
    return torch.tensor(v, dtype=torch.float32)


def orthographic_mouse_pos(params: CanvasParams, grid: Grid,
                           sx: float, sy: float):
    """Screen point -> tex coords on the globe (Orthographic.cpp:98-120's
    mousePos, using the shader's y-up convention).  Returns (s, t) or None
    beyond the sphere rim."""
    x = 2.0 * (sx - 0.5) * params.zoom
    y = 2.0 * (sy - 0.5) / params.window_aspect * params.zoom
    s, t, oob = _ortho_globe_screen_to_tex(params, grid, _f32(x), _f32(y))
    if bool(oob):
        return None
    return float(s), float(t)


def orthographic_drag(params: CanvasParams, grid: Grid,
                      p0: Tuple[float, float],
                      p1: Tuple[float, float]) -> CanvasParams:
    """Drag-to-rotate (Orthographic.cpp:71-96): the tex-coord displacement
    between the screen points maps to rotation deltas —
    delta_phi += dt * (phi1 - phi0), delta_theta -= ds * (lam1 - lam0),
    delta_phi clamped to [0, pi].  Returns the updated params."""
    if params.ortho_state is None:
        params = dataclasses.replace(params, ortho_state=(0.0, math.pi / 2))
    a = orthographic_mouse_pos(params, grid, *p1)
    b = orthographic_mouse_pos(params, grid, *p0)
    if a is None or b is None:
        return params
    ds = a[0] - b[0]
    dt_ = a[1] - b[1]
    theta, phi = params.ortho_state
    phi += dt_ * (grid.phi1 - grid.phi0)
    theta -= ds * (grid.lam1 - grid.lam0)
    phi = min(max(phi, 0.0), math.pi)
    return dataclasses.replace(params, ortho_state=(theta, phi))


def screen_to_tex(params: CanvasParams, grid: Grid, out_w: int, out_h: int,
                  device="cuda"):
    """Map every output pixel to terrain tex coords on ``device``.

    Returns (s, t, oob) tensors of shape (out_h, out_w).  Follows
    Canvas.cpp:210-283: screen -> plane -> inverseshader -> globeRotation ->
    cornerCoords normalization.  Row 0 = bottom (t=0), like the GL canvas.
    """
    proj = PROJECTIONS[params.projection]
    sx = _div(torch.arange(out_w, dtype=torch.float32, device=device) + 0.5,
              out_w)
    sy = _div(torch.arange(out_h, dtype=torch.float32, device=device) + 0.5,
              out_h)
    stx, sty = torch.meshgrid(sx, sy, indexing="xy")

    if params.projection == "img":
        return _img_screen_to_tex(params, grid, 2.0 * (stx - 0.5),
                                  2.0 * (sty - 0.5))
    if params.projection == "orthographic" and params.ortho_state is not None:
        x = 2.0 * (stx - 0.5) * params.zoom
        y = _div(2.0 * (sty - 0.5), params.window_aspect) * params.zoom
        return _ortho_globe_screen_to_tex(params, grid, x, y)

    x = 2.0 * (stx - 0.5) * params.zoom + params.offset[0]
    y = (_div(2.0 * (sty - 0.5), params.window_aspect) * params.zoom
         + params.offset[1])
    x = x * proj.scale[0]
    y = y * proj.scale[1]

    # interrupted lobes (Canvas.cpp:220-260): remap x into the containing
    # lobe before the inverse, remap lambda back after.  The reference's
    # 'offset' uniform only ever takes value 0 (its =1 assignment is under
    # an unreachable condition, Canvas.cpp:231/239 — reproduced).
    interrupted = params.interruptions is not None and proj.interruptible
    if interrupted:
        sx_scale = proj.scale[0]
        xs = _div(x, sx_scale)
        nb, nc, sb, sc = params.interruptions
        start_i = torch.full_like(x, -1.0)
        stop_i = torch.full_like(x, 1.0)
        for bounds, centers, is_north in ((nb, nc, True), (sb, sc, False)):
            hemi = (y < 0) if is_north else (y > 0)
            for i in range(len(centers)):
                lo, hi, ce = bounds[i] / 180, bounds[i + 1] / 180, \
                    centers[i] / 180
                cond = hemi & (xs > lo) & (xs < hi)
                left = xs < ce
                start_i = torch.where(cond & left, lo,
                                      torch.where(cond & ~left, ce, start_i))
                stop_i = torch.where(cond & left, ce,
                                     torch.where(cond & ~left, hi, stop_i))
        x = (x - start_i * sx_scale) / (stop_i * sx_scale
                                        - start_i * sx_scale) * sx_scale

    lam, phi, oob = proj.inverse(x, y)
    if interrupted:
        lam = _div(lam, PI) * (stop_i * PI - start_i * PI) + start_i * PI
    oob = oob | (lam < -PI) | (lam > PI) | (phi < -PI / 2) | (phi > PI / 2)

    R = [[float(v) for v in row] for row in
         rotation_matrix_euler(*params.rotation)]
    cx = torch.cos(phi) * torch.cos(lam)
    cy = torch.cos(phi) * torch.sin(lam)
    cz = torch.sin(phi)
    rx = R[0][0] * cx + R[0][1] * cy + R[0][2] * cz
    ry = R[1][0] * cx + R[1][1] * cy + R[1][2] * cz
    rz = R[2][0] * cx + R[2][1] * cy + R[2][2] * cz
    phi = torch.asin(torch.clamp(rz, -1.0, 1.0))
    lam = torch.atan2(ry, rx)

    t = _div(phi - grid.phi0, grid.phi1 - grid.phi0)
    s = _div(lam - grid.lam0, grid.lam1 - grid.lam0)
    oob = oob | (t < 0) | (t > 1) | (s < 0) | (s > 1)
    return s, t, oob


def project_field(field: torch.Tensor, params: CanvasParams, grid: Grid,
                  out_w: int = 800, out_h: int = 400, bilinear: bool = False):
    """Resample a (..., H, W) field through the canvas projection, on the
    field's device.

    Returns (image (..., out_h, out_w), oob mask (out_h, out_w)).
    Out-of-bounds pixels are 0 (the GL fragment shader discards them;
    callers mask with oob).  Leading axes (channels) share one gather.
    """
    s, t, oob = screen_to_tex(params, grid, out_w, out_h, field.device)
    sample = sample_bilinear if bilinear else sample_nearest
    img = sample(field, s, t)
    return torch.where(oob, 0.0, img), oob


def inverse_point(params: CanvasParams, grid: Grid, sx: float, sy: float):
    """CPU mouse->texture inverse (Canvas.cpp:145-186): one screen point ->
    (s, t) tex coords or None if out of bounds."""
    proj = PROJECTIONS[params.projection]
    if params.projection == "img":
        s, t, oob = _img_screen_to_tex(params, grid, 2.0 * (sx - 0.5),
                                       2.0 * (sy - 0.5))
        return None if bool(oob) else (float(s), float(t))
    x = 2.0 * (sx - 0.5) * params.zoom + params.offset[0]
    y = 2.0 * (sy - 0.5) / params.window_aspect * params.zoom + params.offset[1]
    x *= proj.scale[0]
    y *= proj.scale[1]
    lam, phi, oob = proj.inverse(_f32(x), _f32(y))
    if bool(oob) or abs(float(lam)) > PI or abs(float(phi)) > PI / 2:
        return None
    R = rotation_matrix_euler(*params.rotation)
    c = np.array([math.cos(float(phi)) * math.cos(float(lam)),
                  math.cos(float(phi)) * math.sin(float(lam)),
                  math.sin(float(phi))], np.float32)
    r = R @ c
    phi2 = math.asin(max(-1.0, min(1.0, float(r[2]))))
    lam2 = math.atan2(float(r[1]), float(r[0]))
    t = (phi2 - grid.phi0) / (grid.phi1 - grid.phi0)
    s = (lam2 - grid.lam0) / (grid.lam1 - grid.lam0)
    if not (0 <= s <= 1 and 0 <= t <= 1):
        return None
    return (s, t)
