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
kernels' plain twins), --mesh NYxNX (the fields split over NY*NX
processes, started by torchrun, ``--nproc-per-node NY*NX``; NCCL on
``cuda``, gloo on ``cpu``).  --checkpoint/--resume and --png are not
ported yet and are refused.  The reference's erosion and tectonic-erosion
commands are not ported yet.

At the end the CLI prints one JSON line to stdout, the kernel launches of
the run.  Under a mesh, rank 0 logs and saves the gathered fields.
``main`` returns the last state (``coupled``, this rank's blocks under a
mesh) or fields.
"""

from __future__ import annotations

import argparse
import json
import os
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
        sp.add_argument("--mesh", type=str, default=None,
                        help="NYxNX domain decomposition (under torchrun)")
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
               "--png": "the PNG render, ROADMAP queue 1 item 8"}


def _refuse_unported(parser, args) -> None:
    for flag, queue in _NOT_PORTED.items():
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported yet ({queue})")


def _terrain(grid, seed, device):
    from ..ops.noise import NoiseParams, fbm

    return fbm(grid, NoiseParams(octaves=8, scale=2.0, min=-4.0, max=6.0,
                                 seed=seed), device)


class _Layout:
    """One device, or this rank's blocks of a mesh: ``local`` turns a full
    field into what this process holds, ``full`` back into the whole field
    on the lead process (a collective: every rank calls it; the others get
    None), ``lead`` is whether this process logs and saves.  A process
    group the CLI joined itself it leaves at the end (``close``); one its
    caller made stays."""

    def __init__(self, parser, args):
        self.mesh = None
        self.device = torch.device(args.device)
        self.owns_group = False
        if args.mesh:
            import torch.distributed as dist

            from ..dist import mesh as dmesh

            try:
                ny, nx = (int(n) for n in args.mesh.lower().split("x"))
            except ValueError:
                parser.error(f"--mesh {args.mesh!r}: expected NYxNX")
            world = (dist.get_world_size() if dist.is_initialized()
                     else int(os.environ.get("WORLD_SIZE", "1")))
            if ny * nx != world:
                parser.error(f"--mesh {args.mesh} needs {ny * nx} processes "
                             f"(torchrun --nproc-per-node {ny * nx}); this "
                             f"group has {world}")
            self.owns_group = not dist.is_initialized()
            self.device = dmesh.initialize(args.device)
            self.mesh = dmesh.make_mesh(shape=(ny, nx), device=self.device)
        self.lead = self.mesh is None or self.mesh.rank == 0

    def local(self, x):
        if self.mesh is None:
            return x
        from ..dist.mesh import shard_field

        return shard_field(x, self.mesh)

    def full(self, x):
        if self.mesh is None:
            return x
        from ..dist.mesh import gather_field

        return gather_field(x, self.mesh, dst=0)

    def close(self):
        if self.owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _finish(args, grid, height, logger, lay):
    height = lay.full(height)
    if lay.lead:
        if args.save:
            np.savez_compressed(args.save, terrain=height.cpu().numpy(),
                                coords=np.asarray(grid.coords),
                                circumference=grid.circumference)
            print(f"saved {args.save}", file=sys.stderr)
        from ..kernels import launch_counts

        print(json.dumps({"kernel_launches": launch_counts()}))
    logger.close()
    lay.close()


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)
    _refuse_unported(parser, args)

    from ..core.grid import Grid
    from ..utils import metrics as M

    # no fallback: without a card the default device fails at the first
    # tensor it creates (or, under a mesh, at the NCCL group)
    lay = _Layout(parser, args)
    device, mesh = lay.device, lay.mesh
    grid = Grid(args.width, args.height)
    logger = M.StepLogger(grid, path=args.log if lay.lead else None)

    if args.cmd == "ocean":
        from ..ops import ocean

        h = lay.local(_terrain(grid, args.seed, device))
        cfg = ocean.OceanConfig(jacobi_iters=args.jacobi, coriolis=1.0)
        u, v = (lay.local(x) for x in ocean.init_ocean(grid, device))
        for i in range(args.steps):
            u, v, p, d = ocean.ocean_step(u, v, h, grid, cfg, mesh=mesh)
            fu, fv, fh = lay.full(u), lay.full(v), lay.full(h)
            if lay.lead:
                logger.log(i, div_norm=M.divergence_norm(fu, fv, fh, grid,
                                                         cfg),
                           vmax=torch.sqrt(fu * fu + fv * fv).max(),
                           advect_clamped=ocean.advect_clamped_fraction(
                               fu, fv, fh, grid, cfg))
        # the reference saves the terrain here, not the currents
        _finish(args, grid, h, logger, lay)
        return {"u": u, "v": v, "terrain": h}

    if args.cmd == "climate":
        from ..ops import temperature

        h = lay.local(_terrain(grid, args.seed, device))
        T = lay.local(temperature.init_temperature(grid, device))
        i0 = 0.0
        done = step = 0
        while done < args.steps:
            k = min(_CLIMATE_DISPATCH, args.steps - done)
            T, i0 = temperature.temperature_step(T, h, i0, grid, substeps=k,
                                                 mesh=mesh)
            done += k
            step += 1
            fT = lay.full(T)
            if lay.lead:
                logger.log(step, substeps=done,
                           mean_T=M.mean_temperature(fT, grid))
        # the reference saves the temperature under the name "terrain"
        _finish(args, grid, T, logger, lay)
        return {"temperature": T, "terrain": h, "t_index": i0}

    if args.cmd == "coupled":
        from ..model import CoupledConfig, coupled_step, init_coupled
        from ..ops import ocean

        state = init_coupled(lay.local(_terrain(grid, args.seed, device)),
                             grid, mesh=mesh)
        cfg = CoupledConfig()
        for i in range(args.steps):
            state = coupled_step(state, grid, cfg, mesh=mesh)
            fh, fT, fu, fv = (lay.full(x) for x in (
                state.height, state.temperature, state.u, state.v))
            if lay.lead:
                logger.log(i, mass=M.mass(fh, grid),
                           mean_T=M.mean_temperature(fT, grid),
                           advect_clamped=ocean.advect_clamped_fraction(
                               fu, fv, fh, grid, cfg.ocean))
        _finish(args, grid, state.height, logger, lay)
        return state


_CLIMATE_DISPATCH = 250  # substeps per temperature_step call, as the
#                          reference CLI dispatches them


if __name__ == "__main__":
    main()
