"""Semi-Lagrangian tap sampler of the ocean advect.

Counterpart of ``demiurge_tpu/pallas_kernels/advect.py``.  The sampler
fetches (u, v) at a per-pixel displacement (dx, dy), given in pixels and
already clamped by the caller, as a sum of hat-weighted integer taps: x
periodic, y clamped to the edge rows.  The rows come in strips of
``strip_rows``, each with its own ``(rx, q)`` from a small table
(``strip_meta``): a strip with q = 0 taps exactly over |kx| <= rx; a polar
strip (q > 0) taps exactly over |kx| <= RF and, where |dx| > RF, on the
stride-``STRIDE`` lattice out to STRIDE*q.  One table row covering every
row (``global_meta``) gives the single-radius form.

``advect_sample`` launches the CUDA kernel (``csrc/advect.cu``) for CUDA
tensors and runs the plain twin ``advect_sample_tiered_plain`` — the literal
tap sum — for CPU tensors.  ``advect_stage`` is the whole single-card
advect stage of ``ops.ocean`` (backtrace, clamp, tap sum, transport back,
forcing, land mask) in one launch of the same kernel's stage form; its
twin ``advect_stage_plain`` is ``ops.ocean.advect_plain``, the torch ops
around the sampler.  ``LAUNCHES`` counts kernel launches of both forms;
``LAUNCHES_ONE_ROW`` counts those of them with a one-row table, the
single-radius form that replaces the reference's ``advect_sample_pallas``;
``LAUNCHES_STAGE`` counts the stage form's, ``LAUNCHES_STAGE_ONE_ROW``
those of them with a one-row table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.platform import check_kernel_inputs, use_cuda_kernels

STRIP = 32     # rows per strip of the tiered form
MAX_STRIPS = 256  # strips the kernel's by-value table holds
RF = 6         # exact-tap radius inside a polar strip
STRIDE = 8     # lattice stride of a polar strip's coarse taps

LAUNCHES = 0
LAUNCHES_ONE_ROW = 0
LAUNCHES_STAGE = 0
LAUNCHES_STAGE_ONE_ROW = 0


def strip_radii(grid, vmax: float, timestep: float, strip: int = STRIP,
                rx_cap: int = 256) -> list:
    """Per-strip x-tap radii, south to north: the backtrace moves at most
    vmax*dt of arclength, stretched 1/cos(phi) into columns, snapped up to
    2, 4, 8 or 16 — or ``rx_cap`` near the poles."""
    H, W = grid.shape
    arc = 2 * 3.14159 / grid.circumference * vmax * timestep  # radians
    r = np.arange(H, dtype=np.float64)
    phi = (r + 0.5) / H * (grid.phi1 - grid.phi0) + grid.phi0
    need = arc / (2 * math.pi / W) / np.maximum(np.cos(phi), 1e-9)
    radii = []
    for s0 in range(0, H, strip):
        n = int(math.ceil(need[s0:s0 + strip].max()))
        radii.append(next((t for t in (2, 4, 8, 16) if n <= t), rx_cap))
    return radii


def strip_meta(radii, width: int) -> np.ndarray:
    """(len(radii), 2) int32 table of (rx, q): q = 0 for a strip of exact
    taps; for a polar strip (rx > 16) the coarse lattice half-count
    q = ceil(rx / STRIDE), capped at W // 16."""
    meta = np.zeros((len(radii), 2), np.int32)
    for i, r in enumerate(radii):
        q = min((r + STRIDE - 1) // STRIDE, width // 16) if r > 16 else 0
        meta[i] = (r, q)
    return meta


def global_meta(rx: int) -> np.ndarray:
    """The table of the single-radius form: one strip, exact taps to rx."""
    return np.array([[rx, 0]], np.int32)


def _check_meta(meta: np.ndarray, strip_rows: int, H: int) -> np.ndarray:
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    if meta.ndim != 2 or meta.shape[1] != 2 or meta.shape[0] * strip_rows != H:
        raise ValueError(f"meta {meta.shape} x {strip_rows} rows does not "
                         f"cover {H} rows")
    if meta.shape[0] > MAX_STRIPS:
        raise ValueError(f"{meta.shape[0]} strips, at most {MAX_STRIPS}")
    return meta


def advect_sample_tiered_plain(u, v, dx, dy, meta, strip_rows: int, Ry: int):
    """The literal tap sum over every strip's (rx, q) taps, in the TPU
    kernel's order (ky ascending, fine taps then coarse taps)."""
    H, W = u.shape
    meta = _check_meta(meta, strip_rows, H)
    uv = torch.stack([u, v])
    out = torch.empty_like(uv)
    for s, (rx, q) in enumerate(meta.tolist()):
        r0, r1 = s * strip_rows, (s + 1) * strip_rows
        dxs, dys = dx[r0:r1], dy[r0:r1]
        fine_r = RF if q > 0 else rx
        fine = torch.abs(dxs) <= float(fine_r)
        rows = torch.arange(r0, r1, device=u.device)
        acc = torch.zeros_like(uv[:, r0:r1])
        for ky in range(-Ry, Ry + 1):
            wy = torch.clamp(1.0 - torch.abs(dys - ky), min=0.0)
            tap_rows = uv[:, torch.clamp(rows + ky, 0, H - 1)]
            for kx in range(-fine_r, fine_r + 1):
                w = wy * torch.clamp(1.0 - torch.abs(dxs - kx), min=0.0)
                w = torch.where(fine, w, 0.0)
                acc = acc + w * torch.roll(tap_rows, -kx, dims=-1)
            for t in range(2 * q + 1):
                kx = (t - q) * STRIDE
                w = wy * torch.clamp(1.0 - torch.abs(dxs - kx) / STRIDE,
                                     min=0.0)
                w = torch.where(fine, 0.0, w)
                acc = acc + w * torch.roll(tap_rows, -kx, dims=-1)
        out[:, r0:r1] = acc
    return out[0], out[1]


def advect_sample_cuda(u, v, dx, dy, meta, strip_rows: int, Ry: int):
    """The closed-form sampler on the card: one thread per pixel, one
    launch on the current stream, no synchronisation."""
    global LAUNCHES, LAUNCHES_ONE_ROW
    check_kernel_inputs(("u", "v", "dx", "dy"), (u, v, dx, dy),
                        shape=tuple(u.shape))
    H, W = u.shape
    meta = _check_meta(meta, strip_rows, H)
    from . import build

    ou, ov = torch.empty_like(u), torch.empty_like(v)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    # the table travels by value in the launch: no copy, no synchronisation
    err = build.library().demiurge_advect_sample(
        u.data_ptr(), v.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        meta.ctypes.data, meta.shape[0], strip_rows, ou.data_ptr(),
        ov.data_ptr(), H, W, Ry, RF, STRIDE, stream)
    build.check(err, "demiurge_advect_sample")
    LAUNCHES += 1
    LAUNCHES_ONE_ROW += int(meta.shape[0] == 1)
    return ou, ov


def advect_sample(u, v, dx, dy, meta, strip_rows: int, Ry: int):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if use_cuda_kernels(u, v, dx, dy):
        return advect_sample_cuda(u, v, dx, dy, meta, strip_rows, Ry)
    return advect_sample_tiered_plain(u, v, dx, dy, meta, strip_rows, Ry)


def advect_stage_plain(u, v, terrain, grid, cfg):
    """The stage's twin: ``ops.ocean.advect_plain``, torch ops around the
    sampler."""
    from ..ops.ocean import advect_plain

    return advect_plain(u, v, terrain, grid, cfg)


def advect_stage_cuda(u, v, terrain, grid, cfg):
    """The whole single-card advect stage on the card: one launch on the
    current stream, no synchronisation.  The table is the tiered one where
    H is a whole number of strips, else the one-row one, as the twin takes
    them on the card."""
    global LAUNCHES, LAUNCHES_ONE_ROW, LAUNCHES_STAGE, LAUNCHES_STAGE_ONE_ROW
    from ..ops import ocean

    check_kernel_inputs(("u", "v", "terrain"), (u, v, terrain),
                        shape=grid.shape)
    if not grid.wrap_x:
        raise NotImplementedError("the advect stage needs an x-periodic grid")
    H, W = grid.shape
    meta, rows, ry, _ = ocean.sampler_plan(
        grid, cfg, ocean.sampler_tiered(grid, True), u.device)
    meta = _check_meta(meta, rows, H)
    tables = ocean.stage_tables(grid, u.device).flat
    scalars = ocean.stage_scalars(grid, cfg)
    from . import build

    ou, ov = torch.empty_like(u), torch.empty_like(v)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = build.library().demiurge_advect_stage(
        u.data_ptr(), v.data_ptr(), terrain.data_ptr(), tables.data_ptr(),
        meta.ctypes.data, meta.shape[0], rows, scalars.ctypes.data,
        scalars.size, ou.data_ptr(), ov.data_ptr(), H, W, ry, RF, STRIDE,
        stream)
    build.check(err, "demiurge_advect_stage")
    LAUNCHES += 1
    LAUNCHES_ONE_ROW += int(meta.shape[0] == 1)
    LAUNCHES_STAGE += 1
    LAUNCHES_STAGE_ONE_ROW += int(meta.shape[0] == 1)
    return ou, ov


def advect_stage(u, v, terrain, grid, cfg):
    """The stage kernel for CUDA tensors, its twin for CPU tensors."""
    if use_cuda_kernels(u, v, terrain):
        return advect_stage_cuda(u, v, terrain, grid, cfg)
    return advect_stage_plain(u, v, terrain, grid, cfg)
