"""Composable appearance/render layers (terrain -> RGBA).

Counterpart of ``demiurge_tpu/viz/appearance.py`` (the reference's
src/appearance/): each layer is a function image -> image
(alpha-composited), chained in user order (AppearanceWindow.cpp:115-121,
Project.cpp:349-369).  The gradient editor's 100x1 LUT textures
(GradientMenu.cpp:40-52) become small LUT tensors sampled with GL_LINEAR
semantics.  Every layer runs on the height field's device.

Layers: ElevationMap (land/ocean gradients, ElevationMap.cpp:11-43),
Hillshade incl. 4-azimuth multidirectional (Hillshade.cpp:10-76),
SlopeMap/AspectMap (SlopeMap.cpp:8-40, AspectMap.cpp:8-36), Graticules
(Shader.h:231-257), BrushOutline, SelectionOutline, UnselectedDim and
VectorField arrows (VectorField.cpp:9-148).

The reference evaluates the chain op by op, so a division by a Python
number is a true float32 division there; ``_div`` keeps it one on the
card too (torch divides a CUDA tensor by a host number as a product with
its reciprocal).
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import host_to_device
from ..core.stencils import get_aspect, get_slope

PI = math.pi


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` rounded once, on any device."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _f32(v: float, device) -> torch.Tensor:
    """A Python number as a 0-d float32 tensor (the reference's weakly
    typed scalar under a jnp function)."""
    return torch.full((), v, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# gradient LUTs (GradientMenu.cpp / imgui_color_gradient)
# ---------------------------------------------------------------------------

#: land presets — ElevationMap.cpp:80-108
LAND_PRESETS = {
    "grayscale": [127, 127, 127, 255, 255, 255],
    "atlas": [172, 208, 165, 148, 191, 139, 168, 198, 143, 189, 204, 150,
              209, 215, 171, 225, 228, 181, 239, 235, 192, 232, 225, 182,
              222, 214, 163, 211, 202, 157, 202, 185, 130, 195, 167, 107,
              185, 152, 90, 170, 135, 83, 172, 154, 124, 186, 174, 154,
              202, 195, 184, 224, 222, 216, 245, 244, 242],
    "green-yellow-red": [31, 70, 41, 111, 165, 67, 243, 236, 34, 246, 145,
                         29, 212, 50, 37],
    "tropic": [1, 64, 76, 47, 93, 49, 95, 124, 21, 176, 159, 28, 254, 229,
               151],
    "contrast": [2, 46, 6, 0, 154, 0, 46, 199, 0, 162, 227, 39, 246, 253,
                 82, 215, 180, 46, 177, 95, 22, 121, 5, 0, 237, 224, 216],
    "terrain": [8, 9, 5, 51, 51, 33, 32, 60, 40, 40, 86, 57, 55, 116, 76,
                113, 165, 100, 160, 184, 110, 217, 207, 120, 211, 185, 104,
                190, 148, 78, 186, 122, 59, 213, 127, 63],
    "heat": [254, 243, 191, 255, 213, 150, 255, 173, 117, 254, 120, 84,
             255, 62, 61, 248, 42, 52, 217, 23, 46, 165, 0, 34],
}

#: ocean presets — ElevationMap.cpp:112-135
OCEAN_PRESETS = {
    "grayscale": [0, 0, 0, 127, 127, 127],
    "atlas": [113, 171, 215, 121, 178, 222, 132, 185, 227, 141, 193, 234,
              150, 201, 240, 161, 210, 247, 172, 219, 251, 185, 227, 255,
              198, 236, 255, 216, 242, 254],
    "blue": [44, 27, 77, 40, 85, 139, 123, 141, 220, 198, 192, 243, 254,
             254, 255],
    "sand": [0, 7, 76, 51, 95, 152, 108, 142, 147, 182, 195, 145, 254, 254,
             253],
    "deep": [0, 0, 0, 22, 59, 94, 84, 126, 191, 138, 161, 202, 253, 253,
             254],
    "heat": [23, 29, 248, 42, 86, 254, 65, 134, 252, 86, 176, 255, 114,
             212, 255, 153, 235, 255, 189, 249, 255, 235, 255, 255],
}


def gradient_lut(colors: Sequence[int], n: int = 100) -> np.ndarray:
    """Evenly-spaced RGB marks -> (n, 4) float LUT in [0,1] with linear
    interpolation (GradientMenu.cpp:33-52; alpha = 1)."""
    marks = np.array(colors, np.float32).reshape(-1, 3) / 255.0
    m = len(marks)
    pos = np.linspace(0.0, 1.0, m) if m > 1 else np.array([0.0])
    xs = np.arange(n, dtype=np.float32) / n
    out = np.empty((n, 4), np.float32)
    for c in range(3):
        out[:, c] = np.interp(xs, pos, marks[:, c])
    out[:, 3] = 1.0
    return out


def sample_lut(lut, x: torch.Tensor) -> torch.Tensor:
    """GL_LINEAR sample of an (n, 4) LUT at coordinate x in [0,1]
    (CLAMP_TO_EDGE, pixel centers at (i+0.5)/n); on x's device."""
    if not isinstance(lut, torch.Tensor):
        lut = host_to_device(np.asarray(lut, np.float32), x.device)
    n = lut.shape[0]
    pos = torch.clamp(x * n - 0.5, 0.0, n - 1.0)
    i0 = torch.floor(pos).to(torch.int32)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = (pos - i0)[..., None]
    return lut[i0.long()] * (1 - f) + lut[i1.long()] * f


def _composite(img, k):
    """fc = fc*(1-k.a) + k*k.a (the reference's alpha blend)."""
    a = k[..., 3:4]
    return img * (1 - a) + k * a


def _rgba(color, device) -> torch.Tensor:
    return host_to_device(np.asarray(color, np.float32), device)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ElevationMap:
    """ElevationMap.cpp:22-43: land/ocean gradient lookup by height/scale."""

    land: str = "grayscale"
    ocean: str = "grayscale"
    scale: float = 10.0

    def __call__(self, img, height, grid: Grid):
        lut_land = gradient_lut(LAND_PRESETS[self.land])
        lut_ocean = gradient_lut(OCEAN_PRESETS[self.ocean])
        h = _div(height, self.scale)
        k_land = sample_lut(lut_land, h)
        k_ocean = sample_lut(lut_ocean, 1 + h)
        k = torch.where((h > 0)[..., None], k_land, k_ocean)
        return _composite(img, k)


@dataclasses.dataclass(frozen=True)
class Hillshade:
    """Hillshade.cpp:10-76 (incl. multidirectional variant)."""

    z_factor: float = 50.0
    altitude: float = 45.0   # degrees
    azimuth: float = 315.0   # degrees
    multidirectional: bool = False
    gradient: Tuple[int, ...] = (0, 0, 0, 255, 255, 255)

    def __call__(self, img, height, grid: Grid):
        lut = gradient_lut(list(self.gradient))
        zenith = _f32((90.0 - self.altitude) / 180.0 * PI, height.device)
        azimuth = self.azimuth / 180.0 * PI
        slope = get_slope(height, grid, self.z_factor)
        aspect = get_aspect(height, grid)
        cos_zenith, sin_zenith = torch.cos(zenith), torch.sin(zenith)

        def shade(az):
            return (cos_zenith * torch.cos(slope)
                    + sin_zenith * torch.sin(slope)
                    * torch.cos(-az + PI / 2 - aspect))

        if self.multidirectional:
            offs = [-67.5, -22.5, 22.5, 67.5]
            hs = 0.0
            for o in offs:
                w = math.sin(azimuth + o * PI / 180.0) ** 2
                hs = hs + shade(azimuth + o * PI / 180.0) * w
            hillshade = hs * 0.5
        else:
            hillshade = shade(azimuth)
        return _composite(img, sample_lut(lut, hillshade))


@dataclasses.dataclass(frozen=True)
class SlopeMap:
    """SlopeMap.cpp:8-40: gradient LUT over slope/(pi/2)."""

    z_factor: float = 1.0
    gradient: Tuple[int, ...] = (255, 255, 255, 255, 0, 0)

    def __call__(self, img, height, grid: Grid):
        lut = gradient_lut(list(self.gradient))
        slope = _div(get_slope(height, grid, self.z_factor), PI) * 2
        return _composite(img, sample_lut(lut, slope))


@dataclasses.dataclass(frozen=True)
class AspectMap:
    """AspectMap.cpp:8-36: gradient LUT over aspect/(2 pi)."""

    gradient: Tuple[int, ...] = (255, 0, 0, 0, 255, 0, 0, 0, 255, 255, 0, 0)

    def __call__(self, img, height, grid: Grid):
        lut = gradient_lut(list(self.gradient))
        aspect = _div(get_aspect(height, grid), 2 * PI)
        return _composite(img, sample_lut(lut, aspect))


@dataclasses.dataclass(frozen=True)
class Graticules:
    """Shader.h:231-257: anti-aliased lat/lon lines every `interval` deg.

    The reference anti-aliases in screen space with dFdx/dFdy; on the raw
    grid the per-pixel degree step is the footprint.
    """

    interval: float = 30.0
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 0.5)

    def __call__(self, img, height, grid: Grid):
        dev = height.device
        lam, phi = grid.lam_phi(dev)
        lam_deg = (_div(lam, PI) * 180).expand(grid.shape)
        phi_deg = (_div(phi, PI) * 180).expand(grid.shape)
        dxd = (grid.lam1 - grid.lam0) / PI * 180 / grid.width
        dyd = (grid.phi1 - grid.phi0) / PI * 180 / grid.height
        color = _rgba(self.color, dev)

        out = img
        for vals, diff in ((lam_deg, 1.2 * dxd), (phi_deg, 1.2 * dyd)):
            absdiff = torch.remainder(torch.abs(vals), self.interval)
            r = torch.minimum(absdiff, self.interval - absdiff)
            w = torch.clamp(1 - _div(r, diff), 0.0, 1.0) * color[3]
            out = out * (1 - w[..., None]) + color * w[..., None]
        return out


@dataclasses.dataclass(frozen=True)
class BrushOutline:
    """Shader.h:216-228: anti-aliased geodesic circle around the brush.

    ``center`` is the brush position in texture coords (s, t); ``size`` the
    brush radius in x-pixel units (the reference's geodistance scaling).
    The reference anti-aliases with the screen-space footprint
    2*|(dFdx r, dFdy r)|; on the raw grid the footprint is the per-pixel
    geodistance gradient."""

    center: Tuple[float, float] = (0.5, 0.5)
    size: float = 30.0

    def __call__(self, img, height, grid: Grid):
        dev = height.device
        H, W = grid.shape
        s = _div(torch.arange(W, dtype=torch.float32, device=dev)
                 .reshape(1, -1) + 0.5, W).expand(grid.shape)
        t = _div(torch.arange(H, dtype=torch.float32, device=dev)
                 .reshape(-1, 1) + 0.5, H).expand(grid.shape)
        r = grid.geodistance_tex((s, t), self.center)
        # footprint: 2*length((dr/dx, dr/dy)) via one-pixel differences
        drx = torch.abs(torch.roll(r, -1, 1) - r)
        dry = torch.abs(torch.roll(r, -1, 0) - r)
        delta = 2.0 * torch.sqrt(drx * drx + dry * dry)
        on = (r < self.size) & (r > self.size - delta)
        w = torch.abs(r - (self.size - 0.5 * delta)) / torch.clamp(
            0.5 * delta, min=1e-9)
        white = _rgba([1.0, 1.0, 1.0, 0.0], dev)
        mixed = img * w[..., None] + white * (1.0 - w)[..., None]
        return torch.where(on[..., None], mixed, img)


@dataclasses.dataclass(frozen=True)
class SelectionOutline:
    """Shader.h:259-275: marching-ants selection boundary.

    A pixel is outlined where the binary selection differs between its x
    or y neighbors; the dash pattern is the reference's
    ``round(mod(px/8 - py/8 + t, 1))`` in grid-pixel coordinates, animated
    by ``time``."""

    sel: object = None          # (H, W) selection field
    time: float = 0.0

    def __call__(self, img, height, grid: Grid):
        sel = self.sel
        assert sel is not None, "SelectionOutline needs the selection field"
        b = sel != 0.0
        ex = torch.roll(b, -1, 1) != torch.roll(b, 1, 1)
        ey = torch.roll(b, -1, 0) != torch.roll(b, 1, 0)
        on = ex | ey
        H, W = grid.shape
        px = torch.arange(W, dtype=torch.float32, device=sel.device)
        py = torch.arange(H, dtype=torch.float32, device=sel.device)
        test = torch.round(torch.remainder(
            _div(px.reshape(1, -1), 8) - _div(py.reshape(-1, 1), 8)
            + self.time, 1.0))
        test = test.expand(grid.shape)
        ants = torch.stack([test, test, test, torch.zeros_like(test)], -1)
        return torch.where(on[..., None], ants, img)


@dataclasses.dataclass(frozen=True)
class UnselectedDim:
    """FreeSelection.cpp:182-188: darken unselected pixels by 25% while a
    selection tool is active (the live lasso preview)."""

    sel: object = None          # (H, W) in-progress selection (scratch1)

    def __call__(self, img, height, grid: Grid):
        overlay = (1.0 - torch.clamp(self.sel, 0.0, 1.0)) * 0.25
        return img * (1.0 - overlay)[..., None]


@dataclasses.dataclass(frozen=True)
class VectorField:
    """VectorField.cpp:9-148: arrow glyphs for a velocity field.

    Renders a grid of rotated arrow sprites; arrow direction from the local
    velocity, length scaled by |v| / vmax.
    """

    spacing: int = 16       # pixels between arrows
    color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    scale: Optional[float] = None  # None = normalize to max speed

    def __call__(self, img, uv, grid: Grid):
        u, v = uv
        dev = u.device
        H, W = grid.shape
        sp = self.spacing
        rad = sp / 2.0
        # cell-local coordinates centered on each arrow cell
        r = torch.arange(H, device=dev).reshape(-1, 1)
        c = torch.arange(W, device=dev).reshape(1, -1)
        ly = (r % sp) - rad + 0.5
        lx = (c % sp) - rad + 0.5
        # velocity at the arrow center (subsampled)
        cr = torch.clamp((r // sp) * sp + sp // 2, 0, H - 1)
        cc = torch.clamp((c // sp) * sp + sp // 2, 0, W - 1)
        uc = u[cr, cc]
        vc = v[cr, cc]
        speed = torch.sqrt(uc * uc + vc * vc)
        if self.scale is not None:
            value = torch.clamp(_div(speed, self.scale), 0.0, 1.0)
        else:
            vmax = torch.max(torch.sqrt(u * u + v * v)) + 1e-12
            value = torch.clamp(speed / vmax, 0.0, 1.0)
        theta = torch.atan2(uc, vc)  # arrow points along velocity
        # rotate local coords by -theta (getRotatedCoordinate)
        ct, st = torch.cos(theta), torch.sin(theta)
        rx = ct * lx - st * ly
        ry = st * lx + ct * ly
        # inArrow (VectorField.cpp body/head test)
        body = (torch.abs(rx) < rad * 0.075 * torch.sqrt(value)) & (
            torch.abs(ry) < (rad - 1) * value - (rad - 1) * 0.3)
        head = ((ry < (rad - 1) * value)
                & (ry > (rad - 1) * value - (rad - 1) * 0.3)
                & (torch.abs(ry - (rad - 1) * value) * torch.sqrt(value)
                   > torch.abs(rx)))
        black = (body | head) & (value > 0.05)
        color = _rgba(self.color, dev)
        w = black[..., None] * color[3]
        return img * (1 - w) + color * w


def render(height: torch.Tensor, grid: Grid, layers: Sequence = None,
           uv=None) -> torch.Tensor:
    """Apply the appearance chain -> (H, W, 4) RGBA in [0,1], on the
    height's device.

    Default chain: ElevationMap + Hillshade (the reference's default
    terrain look)."""
    if layers is None:
        layers = [ElevationMap(), Hillshade(z_factor=50.0)]
    img = torch.zeros(grid.shape + (4,), dtype=torch.float32,
                      device=height.device)
    for layer in layers:
        if isinstance(layer, VectorField):
            img = layer(img, uv, grid)
        else:
            img = layer(img, height, grid)
    return torch.clamp(img, 0.0, 1.0)


def to_png(img, path: str):
    """Write an (H, W, 4) [0,1] image to PNG (row 0 = south -> flip for
    conventional image orientation).  The reference's own encoder: the
    channels are truncated to 8 bits, not rounded."""
    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) \
        else np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.ones_like(arr)], -1)
    arr = (np.clip(arr[::-1], 0, 1) * 255).astype(np.uint8)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
