"""Seamless spherical gradient noise (simplex fBm on the unit sphere).

Counterpart of ``demiurge_tpu/ops/noise.py``: the Ashima 3D simplex noise
with analytic gradient evaluated on the unit sphere, the seven fBm
variants (default, ridged, billowy, iq, swiss, jordan, plateaus;
GradientNoise.cpp:184-435) and ``gradient_noise``, the filter that blends
the fBm into the terrain.

Seed handling follows the reference package exactly: the three offsets come
from JAX's ``jax.random.uniform(jax.random.PRNGKey(seed), (3,), float32,
0, 10000)``, reimplemented here in numpy (threefry2x32 with JAX's
partitionable counter layout, and JAX's mantissa-fill float conversion), so
``--seed 7`` gives both packages the same planet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.grid import Grid, rdiv
from .blend import blend

PI = math.pi


# ---------------------------------------------------------------------------
# Ashima 3D simplex noise with analytic gradient
# ---------------------------------------------------------------------------


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 1.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _dot(a, b):
    return torch.sum(a * b, -1)


def snoise_grad(v: torch.Tensor):
    """3D simplex noise + analytic gradient.

    v: (..., 3) float32. Returns (value (...,), gradient (..., 3)).
    """
    Cx, Cy = 1.0 / 6.0, 1.0 / 3.0
    Dy, Dz, Dw = 0.5, 1.0, 2.0

    i = torch.floor(v + torch.sum(v * Cy, -1, keepdim=True))
    x0 = v - i + torch.sum(i * Cx, -1, keepdim=True)

    g = (x0[..., [0, 1, 2]] >= x0[..., [1, 2, 0]]).to(v.dtype)
    l = 1.0 - g
    lzxy = l[..., [2, 0, 1]]
    i1 = torch.minimum(g, lzxy)
    i2 = torch.maximum(g, lzxy)

    x1 = x0 - i1 + Cx
    x2 = x0 - i2 + Cy
    x3 = x0 - Dy

    i = _mod289(i)
    iz, iy, ix = i[..., 2], i[..., 1], i[..., 0]

    def four(a0, a1, a2):
        # vec4(0, i1.c, i2.c, 1) for component c
        return torch.stack([torch.zeros_like(a0), a1, a2,
                            torch.ones_like(a0)], -1)

    p = _permute(
        _permute(
            _permute(iz[..., None] + four(iz, i1[..., 2], i2[..., 2]))
            + iy[..., None]
            + four(iy, i1[..., 1], i2[..., 1])
        )
        + ix[..., None]
        + four(ix, i1[..., 0], i2[..., 0])
    )

    n_ = 0.142857142857
    ns_x = n_ * Dw - 0.0
    ns_y = n_ * Dy - Dz
    ns_z = n_ * Dz - 0.0

    j = p - 49.0 * torch.floor(p * ns_z * ns_z)
    x_ = torch.floor(j * ns_z)
    y_ = torch.floor(j - 7.0 * x_)

    x = x_ * ns_x + ns_y
    y = y_ * ns_x + ns_y
    h = 1.0 - torch.abs(x) - torch.abs(y)

    b0 = torch.cat([x[..., 0:2], y[..., 0:2]], -1)
    b1 = torch.cat([x[..., 2:4], y[..., 2:4]], -1)

    s0 = torch.floor(b0) * 2.0 + 1.0
    s1 = torch.floor(b1) * 2.0 + 1.0
    sh = -(h <= 0.0).to(v.dtype)

    a0 = b0[..., [0, 2, 1, 3]] + s0[..., [0, 2, 1, 3]] * sh[..., [0, 0, 1, 1]]
    a1 = b1[..., [0, 2, 1, 3]] + s1[..., [0, 2, 1, 3]] * sh[..., [2, 2, 3, 3]]

    p0 = torch.stack([a0[..., 0], a0[..., 1], h[..., 0]], -1)
    p1 = torch.stack([a0[..., 2], a0[..., 3], h[..., 1]], -1)
    p2 = torch.stack([a1[..., 0], a1[..., 1], h[..., 2]], -1)
    p3 = torch.stack([a1[..., 2], a1[..., 3], h[..., 3]], -1)

    norm = _taylor_inv_sqrt(torch.stack(
        [_dot(p0, p0), _dot(p1, p1), _dot(p2, p2), _dot(p3, p3)], -1))
    p0 = p0 * norm[..., 0:1]
    p1 = p1 * norm[..., 1:2]
    p2 = p2 * norm[..., 2:3]
    p3 = p3 * norm[..., 3:4]

    m = torch.clamp(0.6 - torch.stack(
        [_dot(x0, x0), _dot(x1, x1), _dot(x2, x2), _dot(x3, x3)], -1),
        min=0.0)
    m2 = m * m
    m4 = m2 * m2
    pdotx = torch.stack(
        [_dot(p0, x0), _dot(p1, x1), _dot(p2, x2), _dot(p3, x3)], -1)

    temp = m2 * m * pdotx
    gradient = -8.0 * (
        temp[..., 0:1] * x0
        + temp[..., 1:2] * x1
        + temp[..., 2:3] * x2
        + temp[..., 3:4] * x3
    )
    gradient = gradient + (
        m4[..., 0:1] * p0 + m4[..., 1:2] * p1 + m4[..., 2:3] * p2
        + m4[..., 3:4] * p3
    )
    gradient = gradient * 42.0

    value = 42.0 * torch.sum(m4 * pdotx, -1)
    return value, gradient


# ---------------------------------------------------------------------------
# seed offsets: JAX's threefry-based uniform draw, in numpy
# ---------------------------------------------------------------------------


def _rotl32(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on uint32 arrays."""
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    a = x1 + ks[0]
    b = x2 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            a = a + b
            b = _rotl32(b, r)
            b = a ^ b
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _uniform_f32(seed: int, n: int, lo: float, hi: float) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(seed), (n,), float32, lo, hi)``."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside the int32 range")
    k1 = np.uint32(0)                      # high word of the int32 seed
    k2 = np.uint32(seed & 0xFFFFFFFF)
    counts = np.arange(n, dtype=np.uint32)
    b1, b2 = _threefry2x32(k1, k2, np.zeros(n, np.uint32), counts)
    bits = b1 ^ b2
    fbits = (bits >> np.uint32(32 - 23)) | np.float32(1.0).view(np.uint32)
    floats = fbits.view(np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return np.maximum(lo32, floats * (hi32 - lo32) + lo32).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NoiseParams:
    """GradientNoiseMenu parameters."""

    mode: str = "default"
    seed: int = 0
    scale: float = 5.0
    octaves: int = 8
    lacunarity: float = 2.0
    persistence: float = 0.5
    warp: float = 0.0
    min: float = 0.0      # lower_limit
    max: float = 1.0      # higher_limit


def seed_offset_from(seed: int) -> np.ndarray:
    """3 offsets in [0, 10000) from an integer seed, equal bit for bit to
    the reference package's draw."""
    return _uniform_f32(seed, 3, 0.0, 10000.0)


# ---------------------------------------------------------------------------
# fBm
# ---------------------------------------------------------------------------


def _norm3(p):
    return torch.sqrt(torch.sum(p * p, -1, keepdim=True))


def _radial(tmp, p):
    """Radial component of tmp along p."""
    return (torch.sum(tmp * p, -1, keepdim=True)
            / torch.sum(p * p, -1, keepdim=True) * p)


def _rotate(p, theta, u):
    """Axis-angle rotation of (...,3) vectors about a possibly non-unit u."""
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    omc = 1.0 - c
    ux, uy, uz = u[..., 0:1], u[..., 1:2], u[..., 2:3]
    px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    rx = ((c + ux * ux * omc) * px + (ux * uy * omc - uz * s) * py
          + (ux * uz * omc + uy * s) * pz)
    ry = ((uy * ux * omc + uz * s) * px + (c + uy * uy * omc) * py
          + (uy * uz * omc - ux * s) * pz)
    rz = ((uz * ux * omc - uy * s) * px + (uz * uy * omc + ux * s) * py
          + (c + uz * uz * omc) * pz)
    return torch.cat([rx, ry, rz], -1)


def _warp(p, warp_factor, seed_off=None):
    """The shared domain warp: rotate p about (p + tangential gradient)
    / |..|^2 by warp*0.1*|grad|, the gradient taken at p + seed_off."""
    _, tmp = snoise_grad(p if seed_off is None else p + seed_off)
    tmp = tmp - _radial(tmp, p)
    u = p + tmp
    u = u / torch.sum(u * u, -1, keepdim=True)
    theta = warp_factor * 0.1 * _norm3(tmp).squeeze(-1)
    return _rotate(p, theta, u)


def sphere_points(grid: Grid, device) -> torch.Tensor:
    """(H, W, 3) unit sphere points of all pixel centers."""
    lam, phi = grid.lam_phi(device)
    x = torch.cos(phi) * torch.cos(lam)
    y = torch.cos(phi) * torch.sin(lam)
    z = torch.sin(phi) * torch.ones_like(lam)
    return torch.stack([x.expand(grid.shape), y.expand(grid.shape),
                        z.expand(grid.shape)], -1)


def _cross(a, b):
    """a x b over the last axis, each component a product difference
    rounded as written (``torch.linalg.cross`` contracts them into fmas
    on the CPU, where the reference's op-by-op form does not)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _unit_axis(u):
    """u / |u|^2, the reference's rotation axis scaling."""
    return u / torch.sum(u * u, -1, keepdim=True)


def fbm(grid: Grid, params: NoiseParams, device, seed_offset=None
        ) -> torch.Tensor:
    """Evaluate the configured fBm over the whole grid -> (H, W) noise
    mapped into [min, max].  Each mode keeps the reference's types: the
    octave amplitude and total are Python floats except where the
    reference makes them per-pixel tensors (iq, swiss, and jordan's
    damped amplitude)."""
    if seed_offset is None:
        seed_offset = seed_offset_from(params.seed)
    seed_offset = torch.as_tensor(np.asarray(seed_offset, np.float32),
                                  device=device)
    p = sphere_points(grid, device)
    lo, hi = params.min, params.max
    n_oct = params.octaves
    lac, per = params.lacunarity, params.persistence

    def zeros():
        return torch.zeros(grid.shape, dtype=torch.float32, device=device)

    if params.mode == "default":
        p = p * params.scale
        p = _warp(p, params.warp)
        fc = zeros()
        amp, total = 1.0, 0.0
        for i in range(n_oct):
            v, _ = snoise_grad(p + seed_offset * (i + 1))
            fc = fc + v * amp
            p = p * lac
            total += amp
            amp *= per
        fc = fc / total
        return (fc + 1) * 0.5 * (hi - lo) + lo

    if params.mode in ("ridged", "billowy"):
        ridged = params.mode == "ridged"
        p = p * params.scale
        fc = zeros()
        amp, total = 1.0, 0.0
        for _ in range(n_oct):
            v, _ = snoise_grad(p + seed_offset)
            fc = fc + ((1 - torch.abs(v)) if ridged else torch.abs(v)) * amp
            p = p * lac
            total += amp
            amp *= per
        return fc / total * (hi - lo) + lo

    if params.mode == "iq":
        p = p * params.scale
        fc = zeros()
        dsum = torch.zeros_like(p)
        amp = 1.0
        total = zeros()
        for _ in range(n_oct):
            v, tmp = snoise_grad(p + seed_offset)
            dsum = dsum + (tmp - _radial(tmp, p))
            d2 = torch.sum(dsum * dsum, -1)
            fc = fc + v * amp / (1.0 + d2)
            p = p * lac
            total = total + rdiv(amp, 1.0 + d2)
            amp *= per
        fc = fc / total
        return (fc + 1) * 0.5 * (hi - lo) + lo

    if params.mode == "swiss":
        freq = params.scale
        p = _warp(p, params.warp)
        fc = zeros()
        dsum = torch.zeros_like(p)
        amp = torch.ones(grid.shape, dtype=torch.float32, device=device)
        total = zeros()
        for _ in range(n_oct):
            u = _unit_axis(p + _cross(p, dsum))
            theta = 2 * 0.1 * _norm3(dsum).squeeze(-1)
            p_ = _rotate(p, theta, u)
            v, tmp = snoise_grad(freq * p_ + seed_offset)
            dsum = dsum + (tmp - _radial(tmp, p)) * (-v[..., None]) \
                * amp[..., None]
            fc = fc + (1 - torch.abs(v)) * amp
            freq *= lac
            total = total + amp
            # smoothstep(-1, 1, fc*fc)
            tt = torch.clamp((fc * fc + 1) / 2, 0.0, 1.0)
            amp = amp * per * (tt * tt * (3 - 2 * tt))
        return fc / total * (hi - lo) + lo

    if params.mode == "jordan":
        freq = params.scale
        p = _warp(p, params.warp, seed_offset)
        v, tmp = snoise_grad(freq * p + seed_offset)
        amp = 1.0
        total = amp
        fc = v * v * amp
        tmp = tmp * v[..., None]
        tang = tmp - _radial(tmp, p)
        dsum_warp = 0.4 * tang
        dsum_damp = 1.0 * tang
        damped_amp = torch.full(grid.shape, amp * per, dtype=torch.float32,
                                device=device)
        for _ in range(1, n_oct):
            u = _unit_axis(p + _cross(p, dsum_warp))
            theta = 2 * 0.1 * _norm3(dsum_warp).squeeze(-1)
            p_ = _rotate(p, theta, u)
            v, tmp = snoise_grad(freq * p_ + seed_offset)
            fc = fc + damped_amp * v * v
            tmp = tmp * v[..., None]
            tang = tmp - _radial(tmp, p)
            dsum_warp = dsum_warp + 0.35 * tang
            dsum_damp = dsum_damp + 0.8 * tang
            freq *= lac
            total += amp
            amp *= per
            d2 = torch.sum(dsum_damp * dsum_damp, -1)
            damped_amp = amp * (1 - 1.0 / (1 + d2))
        return fc / total * (hi - lo) + lo

    if params.mode == "plateaus":
        freq = params.scale
        p = _warp(p, params.warp)
        fc = zeros()
        amp, total = 1.0, 0.0
        for i in range(n_oct):
            v, tmp = snoise_grad(freq * p + seed_offset * (i + 1))
            dsum = (tmp - _radial(tmp, p)) \
                * ((1 - torch.abs(v)) * v * 2)[..., None]
            u = _unit_axis(p + _cross(p, dsum))
            theta = 2 * 0.1 * _norm3(dsum).squeeze(-1)
            p_ = _rotate(p, theta, u)
            v, tmp = snoise_grad(freq * p_ + seed_offset * (i + 1))
            fc = fc + v * amp / (1 + torch.abs(fc) * torch.abs(fc) * 5)
            freq *= lac
            total += amp
            amp *= per
        fc = fc / total
        return (fc + 1) * 0.5 * (hi - lo) + lo

    raise ValueError(f"unknown noise mode {params.mode!r}")


def gradient_noise(height, sel, grid: Grid, params: NoiseParams,
                   blend_mode: str = "replace"):
    """The whole GradientNoise filter: the fBm blended into the terrain
    through the selection (GradientNoise.cpp:453-455)."""
    return blend(height, fbm(grid, params, height.device), sel, blend_mode)
