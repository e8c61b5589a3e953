"""Command-line runner of the port.

  python -m demiurge_tpu_torch.api.cli erosion   # BASELINE config 1:
                                                 # 1024x512, 100 steps
  python -m demiurge_tpu_torch.api.cli tectonic-erosion  # config 2:
                                                 # 2048x1024, 70 steps
  python -m demiurge_tpu_torch.api.cli ocean     # config 3: 2048x1024
                                                 # + Coriolis
  python -m demiurge_tpu_torch.api.cli climate   # config 4: 4096x2048,
                                                 # 15000 substeps (1 year)
  python -m demiurge_tpu_torch.api.cli coupled   # config 5: 8192x4096

Flags: --width/--height/--steps override the config size (for ``climate``
the steps are substeps, run in dispatches of 250), --seed the terrain's
fBm seed, --jacobi the ocean command's pressure sweeps, --save out.npz,
--png out.png (the final field through the default appearance chain:
the terrain, or for ``climate`` the temperature, as the reference
renders them), --log metrics.jsonl, --xprof DIR (the command under
``torch.profiler``, host and card, written as one Chrome trace,
DIR/trace.json: the program's spans, ``core.trace``, with the kernels,
copies and fills they launched; under a mesh rank 0's), --device
(default ``cuda``; ``--device cpu`` runs the kernels' plain twins),
--mesh NYxNX (the fields split over NY*NX processes, started by
torchrun, ``--nproc-per-node NY*NX``; NCCL on ``cuda``, gloo on
``cpu``).  ``coupled`` takes
--checkpoint FILE (the state written every --checkpoint-every steps and
at the end, in the reference's format) and --resume (restart from FILE
when it exists).  ``erosion`` is the reference's fluvial
erosion loop with lakes (``ops.erosion.landscape_evolution``; the lake
solve runs on the host, the mass is logged every step); ``tectonic-erosion``
is the same loop with the plate tectonics' uplift refreshed every 5th
step (``ops.erosion.coupled_tectonic_erosion``).  Both run on one device:
they refuse --mesh (the reference builds a mesh and never uses it).

At the end the CLI prints one JSON line to stdout, the kernel launches of
the run.  Under a mesh, every rank reduces its own blocks for the step
log (one all_reduce a metric, ``utils.metrics``) and rank 0 logs; rank 0
renders and saves the gathered fields, and writes the checkpoint of the
gathered state; a resume loads it on every rank, which takes its
blocks.
``main`` returns the last state (``coupled``, this rank's blocks under a
mesh) or fields.
"""

from __future__ import annotations

import argparse
import dataclasses
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
        sp.add_argument("--png", type=str, default=None)
        sp.add_argument("--log", type=str, default=None)
        sp.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
        sp.add_argument("--mesh", type=str, default=None,
                        help="NYxNX domain decomposition (under torchrun)")
        sp.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint file; with --resume, restart from it")
        sp.add_argument("--checkpoint-every", type=int, default=10)
        sp.add_argument("--resume", action="store_true",
                        help="resume from --checkpoint if it exists")
        sp.add_argument("--xprof", type=str, default=None,
                        help="write a profiler trace to DIR/trace.json")

    common(sub.add_parser("erosion", help="fluvial erosion (BASELINE 1)"),
           1024, 512, 100)
    common(sub.add_parser("tectonic-erosion",
                          help="tectonic uplift + erosion (BASELINE 2)"),
           2048, 1024, 70)
    sp = sub.add_parser("ocean", help="ocean currents + Coriolis (BASELINE 3)")
    common(sp, 2048, 1024, 50)
    sp.add_argument("--jacobi", type=int, default=1000)
    common(sub.add_parser("climate", help="seasonal climate (BASELINE 4)"),
           4096, 2048, 15000)
    common(sub.add_parser("coupled", help="coupled pipeline (BASELINE 5)"),
           8192, 4096, 10)
    return p


def _refuse_mesh(parser, args) -> None:
    if args.cmd in ("erosion", "tectonic-erosion") and args.mesh:
        parser.error(f"{args.cmd} runs on one device: --mesh is not "
                     "supported (the reference builds a mesh and never uses "
                     "it)")


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
    if args.save or args.png:
        height = lay.full(height)
    if lay.lead:
        if args.save:
            np.savez_compressed(args.save, terrain=height.cpu().numpy(),
                                coords=np.asarray(grid.coords),
                                circumference=grid.circumference)
            print(f"saved {args.save}", file=sys.stderr)
        if args.png:
            from ..utils.png import write_png
            from ..viz import appearance

            img = appearance.render(height, grid)
            write_png(args.png, img.cpu().numpy()[::-1])
            print(f"wrote {args.png}", file=sys.stderr)
        from ..kernels import launch_counts

        print(json.dumps({"kernel_launches": launch_counts()}))
    logger.close()
    lay.close()


def _map_fields(state, fn):
    """``state`` with ``fn`` applied to each (H, W) field (blocks to the
    whole field or back); 0-d and None leaves stay."""
    return dataclasses.replace(state, **{
        f.name: fn(x) for f in dataclasses.fields(state)
        if isinstance(x := getattr(state, f.name), torch.Tensor)
        and x.dim() == 2})


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)
    _refuse_mesh(parser, args)

    from ..core.grid import Grid
    from ..utils import metrics as M

    # no fallback: without a card the default device fails at the first
    # tensor it creates (or, under a mesh, at the NCCL group)
    lay = _Layout(parser, args)
    grid = Grid(args.width, args.height)
    logger = M.StepLogger(grid, path=args.log if lay.lead else None)
    with M.maybe_profile(args.xprof if lay.lead else None):
        return _command(args, grid, lay, logger)


def _command(args, grid, lay, logger):
    """Run ``args.cmd``; returns what ``main`` returns."""
    from ..utils import metrics as M

    device, mesh = lay.device, lay.mesh
    if args.cmd in ("erosion", "tectonic-erosion"):
        from ..ops import erosion

        h = _terrain(grid, args.seed, device)
        sel = torch.ones(grid.shape, device=device)
        cfg = erosion.ErosionConfig(lakes=True)

        def log_mass(i, hh):
            logger.log(i, mass=M.mass(hh, grid))

        if args.cmd == "erosion":
            h = erosion.landscape_evolution(h, sel, grid, cfg,
                                            iterations=args.steps,
                                            callback=log_mass)
        else:
            # live coupling: the tectonic uplift forcing refreshed during
            # the evolution (not the reference's sequential chain)
            h = erosion.coupled_tectonic_erosion(
                h, sel, grid, cfg, iterations=args.steps, tectonic_every=5,
                callback=log_mass)
        _finish(args, grid, h, logger, lay)
        return {"terrain": h}

    if args.cmd == "ocean":
        from ..ops import ocean

        h = lay.local(_terrain(grid, args.seed, device))
        cfg = ocean.OceanConfig(jacobi_iters=args.jacobi, coriolis=1.0)
        u, v = (lay.local(x) for x in ocean.init_ocean(grid, device))
        for i in range(args.steps):
            u, v, p, d = ocean.ocean_step(u, v, h, grid, cfg, mesh=mesh)
            # every rank reduces its blocks (no field leaves its rank)
            rec = dict(div_norm=M.divergence_norm(u, v, h, grid, cfg, mesh),
                       vmax=M.vmax(u, v, mesh),
                       advect_clamped=ocean.advect_clamped_fraction(
                           u, v, h, grid, cfg, mesh))
            if lay.lead:
                logger.log(i, **rec)
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
            mean_T = M.mean_temperature(T, grid, mesh)
            if lay.lead:
                logger.log(step, substeps=done, mean_T=mean_T)
        # the reference saves the temperature under the name "terrain"
        _finish(args, grid, T, logger, lay)
        return {"temperature": T, "terrain": h, "t_index": i0}

    if args.cmd == "coupled":
        from ..model import CoupledConfig, CoupledState, coupled_step, \
            init_coupled
        from ..ops import ocean
        from ..utils import checkpoint as ckpt

        start = 0
        if args.resume and args.checkpoint and ckpt.latest(args.checkpoint):
            state, start = ckpt.load(args.checkpoint, CoupledState, device)
            state = _map_fields(state, lay.local)
            if lay.lead:
                print(f"resumed from {args.checkpoint} at step {start}",
                      file=sys.stderr)
        else:
            state = init_coupled(lay.local(_terrain(grid, args.seed,
                                                    device)),
                                 grid, mesh=mesh)

        def save_checkpoint(step):
            full = _map_fields(state, lay.full)  # every rank gathers
            if lay.lead:
                ckpt.save(args.checkpoint, full, step, grid)

        cfg = CoupledConfig()
        for i in range(start, args.steps):
            state = coupled_step(state, grid, cfg, mesh=mesh)
            rec = dict(mass=M.mass(state.height, grid, mesh),
                       mean_T=M.mean_temperature(state.temperature, grid,
                                                 mesh),
                       advect_clamped=ocean.advect_clamped_fraction(
                           state.u, state.v, state.height, grid, cfg.ocean,
                           mesh))
            if lay.lead:
                logger.log(i, **rec)
            if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
                save_checkpoint(i + 1)
        if args.checkpoint:
            save_checkpoint(args.steps)
        _finish(args, grid, state.height, logger, lay)
        return state


_CLIMATE_DISPATCH = 250  # substeps per temperature_step call, as the
#                          reference CLI dispatches them


if __name__ == "__main__":
    main()
