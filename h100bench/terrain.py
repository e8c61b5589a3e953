"""The seeded terrain that every cell starts from: the coupled CLI's fBm
recipe (simplex noise on the unit sphere, summed over octaves, mapped into
[min, max]), computed on the device in row blocks.

A copy of the recipe, so that the benchmark, not the program, makes the
input that both the program and the plain reference receive.  The three
seed offsets come from the Threefry-2x32 hash of the seed, as a 64-bit
PRNG key (high and low words), so any seed up to 2**63 makes a planet.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _rotl32(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k1, k2, x1, x2):
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


def seed_offsets(seed: int) -> np.ndarray:
    """Three offsets in [0, 10000), float32, from the seed."""
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed {seed} outside [0, 2**63)")
    with np.errstate(over="ignore"):
        b1, b2 = _threefry2x32(np.uint32(seed >> 32),
                               np.uint32(seed & 0xFFFFFFFF),
                               np.zeros(3, np.uint32),
                               np.arange(3, dtype=np.uint32))
    bits = b1 ^ b2
    fbits = (bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = fbits.view(np.float32) - np.float32(1.0)
    return (floats * np.float32(10000.0)).astype(np.float32)


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 1.0) * x)


def snoise(v: torch.Tensor) -> torch.Tensor:
    """Ashima 3D simplex noise of (..., 3) points."""
    Cx, Cy = 1.0 / 6.0, 1.0 / 3.0
    i = torch.floor(v + torch.sum(v * Cy, -1, keepdim=True))
    x0 = v - i + torch.sum(i * Cx, -1, keepdim=True)
    g = (x0[..., [0, 1, 2]] >= x0[..., [1, 2, 0]]).to(v.dtype)
    lzxy = (1.0 - g)[..., [2, 0, 1]]
    i1 = torch.minimum(g, lzxy)
    i2 = torch.maximum(g, lzxy)
    x1 = x0 - i1 + Cx
    x2 = x0 - i2 + Cy
    x3 = x0 - 0.5
    i = _mod289(i)

    def four(c):
        a = i[..., c]
        return a[..., None] + torch.stack(
            [torch.zeros_like(a), i1[..., c], i2[..., c], torch.ones_like(a)],
            -1)

    p = _permute(_permute(_permute(four(2)) + four(1)) + four(0))
    ns_x, ns_y, ns_z = 0.142857142857 * 2.0, 0.142857142857 * 0.5 - 1.0, \
        0.142857142857
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
    ps = [torch.stack([a0[..., 0], a0[..., 1], h[..., 0]], -1),
          torch.stack([a0[..., 2], a0[..., 3], h[..., 1]], -1),
          torch.stack([a1[..., 0], a1[..., 1], h[..., 2]], -1),
          torch.stack([a1[..., 2], a1[..., 3], h[..., 3]], -1)]
    xs = [x0, x1, x2, x3]
    norm = 1.79284291400159 - 0.85373472095314 * torch.stack(
        [torch.sum(q * q, -1) for q in ps], -1)
    m = torch.clamp(0.6 - torch.stack([torch.sum(q * q, -1) for q in xs], -1),
                    min=0.0)
    m2 = m * m
    pdotx = torch.stack([torch.sum(q * norm[..., k:k + 1] * xq, -1)
                         for k, (q, xq) in enumerate(zip(ps, xs))], -1)
    return 42.0 * torch.sum(m2 * m2 * pdotx, -1)


ROWS = 256  # rows a block: the noise's temporaries stay small at any width


def fbm(width: int, height: int, params: dict, seed: int, device
        ) -> torch.Tensor:
    """(height, width) float32 fBm of ``params`` (octaves, scale,
    lacunarity, persistence, min, max) at the pixel centres."""
    off = torch.from_numpy(seed_offsets(seed)).to(device)
    out = torch.empty((height, width), dtype=torch.float32, device=device)
    lam = ((torch.arange(width, dtype=torch.float32, device=device) + 0.5)
           / width * (2 * math.pi) - math.pi).reshape(1, -1)
    lo, hi = params["min"], params["max"]
    for r0 in range(0, height, ROWS):
        r = torch.arange(r0, min(r0 + ROWS, height), dtype=torch.float32,
                         device=device)
        phi = ((r + 0.5) / height * math.pi - math.pi / 2).reshape(-1, 1)
        p = torch.stack([(torch.cos(phi) * torch.cos(lam)),
                         (torch.cos(phi) * torch.sin(lam)),
                         (torch.sin(phi) * torch.ones_like(lam))], -1)
        p = p * params["scale"]
        fc = torch.zeros(p.shape[:2], dtype=torch.float32, device=device)
        amp, total = 1.0, 0.0
        for i in range(params["octaves"]):
            fc = fc + snoise(p + off * (i + 1)) * amp
            p = p * params["lacunarity"]
            total += amp
            amp *= params["persistence"]
        out[r0:r0 + len(r)] = (fc / total + 1) * 0.5 * (hi - lo) + lo
    return out
