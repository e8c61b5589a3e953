"""Command-line runner of the port.

  python -m demiurge_tpu_torch.api.cli ocean     # BASELINE config 3:
                                                 # 2048x1024 + Coriolis
  python -m demiurge_tpu_torch.api.cli climate   # config 4: 4096x2048,
                                                 # 15000 substeps (1 year)
  python -m demiurge_tpu_torch.api.cli coupled   # config 5: 8192x4096

Flags: --width/--height/--steps override the config size (for ``climate``
the steps are substeps, run in dispatches of 250), --seed the terrain's
fBm seed, --jacobi the ocean command's pressure sweeps, --save out.npz,
--log metrics.jsonl, --device (default ``cuda``; ``--device cpu`` runs the
kernels' plain twins).  --checkpoint/--resume, --mesh and --png are not
ported yet and are refused.  The reference's erosion and tectonic-erosion
commands are not ported yet.  ``main`` returns the last state (``coupled``)
or fields.
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
        for flag, queue in _NOT_PORTED.items():
            sp.add_argument(flag, nargs="?", const=True, default=None,
                            help=f"not ported yet ({queue}); refused")

    sp = sub.add_parser("ocean", help="ocean currents + Coriolis (BASELINE 3)")
    common(sp, 2048, 1024, 50)
    sp.add_argument("--jacobi", type=int, default=1000)
    common(sub.add_parser("climate", help="seasonal climate (BASELINE 4)"),
           4096, 2048, 15000)
    common(sub.add_parser("coupled", help="coupled pipeline (BASELINE 5)"),
           8192, 4096, 10)
    return p


# reference flags the port refuses, with the ROADMAP queue-1 item that
# ports them
_NOT_PORTED = {"--checkpoint": "checkpoints, ROADMAP queue 1 item 8",
               "--checkpoint-every": "checkpoints, ROADMAP queue 1 item 8",
               "--resume": "checkpoints, ROADMAP queue 1 item 8",
               "--mesh": "the sharded paths, ROADMAP queue 1 item 9",
               "--png": "the PNG render, ROADMAP queue 1 item 8"}


def _refuse_unported(parser, args) -> None:
    for flag, queue in _NOT_PORTED.items():
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported yet ({queue})")


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
    parser = _build_parser()
    args = parser.parse_args(argv)
    _refuse_unported(parser, args)

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
        return {"u": u, "v": v, "terrain": h}

    if args.cmd == "climate":
        from ..ops import temperature

        h = _terrain(grid, args.seed, device)
        T = temperature.init_temperature(grid, device)
        i0 = 0.0
        done = step = 0
        while done < args.steps:
            k = min(_CLIMATE_DISPATCH, args.steps - done)
            T, i0 = temperature.temperature_step(T, h, i0, grid, substeps=k)
            done += k
            step += 1
            logger.log(step, substeps=done,
                       mean_T=M.mean_temperature(T, grid))
        # the reference saves the temperature under the name "terrain"
        _finish(args, grid, T, logger)
        return {"temperature": T, "terrain": h, "t_index": i0}

    if args.cmd == "coupled":
        from ..model import CoupledConfig, coupled_step, init_coupled
        from ..ops import ocean

        state = init_coupled(_terrain(grid, args.seed, device), grid)
        cfg = CoupledConfig()
        for i in range(args.steps):
            state = coupled_step(state, grid, cfg)
            logger.log(i, mass=M.mass(state.height, grid),
                       mean_T=M.mean_temperature(state.temperature, grid),
                       advect_clamped=ocean.advect_clamped_fraction(
                           state.u, state.v, state.height, grid,
                           cfg.ocean))
        _finish(args, grid, state.height, logger)
        return state


_CLIMATE_DISPATCH = 250  # substeps per temperature_step call, as the
#                          reference CLI dispatches them


if __name__ == "__main__":
    main()
