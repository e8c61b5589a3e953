"""Command-line runner of the port.

  python -m demiurge_tpu_torch.api.cli ocean     # BASELINE config 3:
                                                 # 2048x1024 + Coriolis

Flags: --width/--height/--steps override the config size, --seed the
terrain's fBm seed, --jacobi the pressure sweeps, --save out.npz,
--log metrics.jsonl, --device (default ``cuda``; ``--device cpu`` runs the
kernels' plain twins).  The reference's other four commands (erosion,
tectonic-erosion, climate, coupled) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _build_parser():
    p = argparse.ArgumentParser(prog="demiurge_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, w, h, steps):
        sp.add_argument("--width", type=int, default=w)
        sp.add_argument("--height", type=int, default=h)
        sp.add_argument("--steps", type=int, default=steps)
        sp.add_argument("--seed", type=int, default=7)
        sp.add_argument("--save", type=str, default=None)
        sp.add_argument("--log", type=str, default=None)
        sp.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")

    sp = sub.add_parser("ocean", help="ocean currents + Coriolis (BASELINE 3)")
    common(sp, 2048, 1024, 50)
    sp.add_argument("--jacobi", type=int, default=1000)
    return p


def _terrain(grid, seed, device):
    from ..ops.noise import NoiseParams, fbm

    return fbm(grid, NoiseParams(octaves=8, scale=2.0, min=-4.0, max=6.0,
                                 seed=seed), device)


def _finish(args, grid, height, logger):
    if args.save:
        np.savez_compressed(args.save, terrain=height.cpu().numpy(),
                            coords=np.asarray(grid.coords),
                            circumference=grid.circumference)
        print(f"saved {args.save}", file=sys.stderr)
    logger.close()


def main(argv=None):
    args = _build_parser().parse_args(argv)

    from ..core.grid import Grid
    from ..utils import metrics as M

    # no fallback: without a card the default device fails at the first
    # tensor it creates
    device = torch.device(args.device)
    grid = Grid(args.width, args.height)
    logger = M.StepLogger(grid, path=args.log)

    if args.cmd == "ocean":
        from ..ops import ocean

        h = _terrain(grid, args.seed, device)
        cfg = ocean.OceanConfig(jacobi_iters=args.jacobi, coriolis=1.0)
        u, v = ocean.init_ocean(grid, device)
        for i in range(args.steps):
            u, v, p, d = ocean.ocean_step(u, v, h, grid, cfg)
            logger.log(i, div_norm=M.divergence_norm(u, v, h, grid, cfg),
                       vmax=torch.sqrt(u * u + v * v).max(),
                       advect_clamped=ocean.advect_clamped_fraction(
                           u, v, h, grid, cfg))
        # the reference saves the terrain here, not the currents
        _finish(args, grid, h, logger)


if __name__ == "__main__":
    main()
