"""Time the ocean's projection kernel (``kernels.project``) against its
twin ``ops.ocean.project``, over block shapes, on the card.

    python -m demiurge_tpu_torch.tools.project_race [--size 8192x4096]
        [--size 2048x1024] [--tiles 2x128,1x256] [--reps 50] [--seed 7]

At each ``--size`` (default the coupled CLI's 8192x4096 and the ocean
CLI's 2048x1024) makes the CLI's terrain (fBm, seed ``--seed``), one
ocean step from rest, then the next step's stages up to the projection
(advect, viscosity, divergence, pressure at the coupled depths: 200 and
50 sweeps), whose (u, v, p) are the inputs.  For each block shape (rows x
columns of pixels; default the module's ``TILE``) the kernel is held to
the twin bit for bit and timed on the device over ``--reps`` calls queued
behind a sleep kernel (``tools.timing.device_ms``); the twin, whose host
time per call outlasts the sleep, by CUDA events around a tenth as many
calls after a warm-up call.  Two bounds at 3.35 TB/s: the stage's 24 bytes
a pixel (u, v, p and the terrain read once, u and v written once), and
what these inputs need, 12 bytes a land pixel (its terrain read, its
zeros written: its u, v and p do not matter).

Prints one JSON line a size: the card, the grid, the land share, both
bounds, the twin's ms, and each block shape's ms and share of each
bound.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet, 700 W
BYTES_PER_PIXEL = 24
BYTES_PER_LAND_PIXEL = 12


def bound_ms(width: int, height: int, land: float = 0.0) -> float:
    """The stage's least time on the card, its bytes at the memory rate:
    24 a pixel, 12 a land pixel (``land`` the land share)."""
    per_pixel = BYTES_PER_PIXEL * (1 - land) + BYTES_PER_LAND_PIXEL * land
    return per_pixel * width * height / HBM_BYTES_PER_S * 1e3


def stage_inputs(grid, seed: int, dev):
    """(u, v, p, terrain, cfg) as the projection of a step after one from
    rest sees them."""
    from ..api import cli
    from ..ops import ocean

    terrain = cli._terrain(grid, seed, dev)
    cfg = ocean.OceanConfig(jacobi_iters=200, diffusion_iters=50)
    u, v = ocean.init_ocean(grid, dev)
    u, v, _, _ = ocean.ocean_step(u, v, terrain, grid, cfg)
    u, v = ocean.advect(u, v, terrain, grid, cfg)
    u, v = ocean.diffusion(u, v, terrain, grid, cfg)
    div = ocean.divergence(u, v, terrain, grid, cfg)
    p = ocean.pressure_solve(div, terrain, grid, cfg)
    return u, v, p, terrain, cfg


def race(width: int, height: int, tiles, reps: int, seed: int) -> dict:
    """The kernel at each block shape against the twin at one size;
    raises if a shape's result differs from the twin's by a bit."""
    import torch

    from ..core.grid import Grid
    from ..kernels import project as kpr
    from ..ops import ocean
    from .timing import device_ms

    dev = torch.device("cuda")
    grid = Grid(width, height)
    u, v, p, terrain, cfg = stage_inputs(grid, seed, dev)
    want = ocean.project(u, v, p, terrain, grid, cfg)
    ocean.project(u, v, p, terrain, grid, cfg)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    n = max(reps // 10, 1)
    start.record()
    for _ in range(n):
        ocean.project(u, v, p, terrain, grid, cfg)
    end.record()
    end.synchronize()
    twin_ms = start.elapsed_time(end) / n
    land = float((terrain > 0).float().mean())
    bound, need = bound_ms(width, height), bound_ms(width, height, land)
    out = {"grid": f"{width}x{height}", "land": round(land, 4),
           "bound_ms": round(bound, 5), "need_ms": round(need, 5),
           "twin_ms": round(twin_ms, 5), "tiles": {}}
    for tile in tiles:
        got = kpr.project_stage_cuda(u, v, p, terrain, grid, cfg, tile)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"block {tile} differs from the twin at "
                               f"{width}x{height}")
        ms = device_ms(lambda: kpr.project_stage_cuda(
            u, v, p, terrain, grid, cfg, tile), reps)
        out["tiles"][f"{tile[0]}x{tile[1]}"] = {
            "ms": round(ms, 5), "bound_pct": round(100 * bound / ms, 2),
            "need_pct": round(100 * need / ms, 2)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", action="append", default=None,
                   help="WxH, repeatable (default 8192x4096 and 2048x1024)")
    p.add_argument("--tiles", default=None,
                   help="comma-separated THxTW (default the module's TILE)")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    from ..kernels import build
    from ..kernels import project as kpr

    build.build()
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    tiles = ([tuple(int(x) for x in t.split("x"))
              for t in args.tiles.split(",")] if args.tiles
             else [kpr.TILE])
    for size in args.size or ["8192x4096", "2048x1024"]:
        width, height = (int(x) for x in size.split("x"))
        print(json.dumps({"card": card, **race(width, height, tiles,
                                                args.reps, args.seed)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
