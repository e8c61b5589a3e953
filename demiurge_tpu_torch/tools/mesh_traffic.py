"""What each rank receives in the mesh cases that once ran on the gathered
fields: bytes by kind of collective, ``sharded_call``s and full-field
gathers, from ``dist.mesh``'s traffic counters.

Cases, each through its entry point with the counters zeroed just before
and read just after, on a group of CPU processes (the counts are those of
any backend):

- ``climate_deep``: ``temperature_step`` of 40 substeps, deeper than a
  rank's row group;
- ``flow_shallow``: ``flow_filter_device`` on a grid of 4 rows a rank,
  shallower than the flow masks' 7-row halo;
- ``quirks``: the ``exact_quirks`` viscosity (50 sweeps);
- ``pressure_warm``: ``pressure_solve`` warm-started (``p0``, 200 sweeps);
- ``band_step``: one default ``coupled_step`` on a grid that wraps in x
  and stops short of both poles.

These are the entry points at a size of the caller's choosing, on this
checkout or another; tests/test_torch_dist_fallbacks.py holds each
stage's results and counts at its own small grids.  Prints one JSON
line: for each case, each rank's record.  ``--tree DIR``
imports the package from another checkout (e.g. an older commit unpacked
by ``git archive``), to hold two trees' traffic side by side:

    python -m demiurge_tpu_torch.tools.mesh_traffic --mesh 2x2 \\
        --width 128 --height 64 [--tree DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np


def _case_records(ny, nx, W, H):
    import torch

    from demiurge_tpu_torch import model
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.dist import mesh as dm
    from demiurge_tpu_torch.ops import flow, ocean, temperature

    torch.set_num_threads(1)
    mesh = dm.make_mesh(shape=(ny, nx), device="cpu")
    grid, band = Grid(W, H), Grid(W, H, coords=(-1.2, 1.1, -np.pi, np.pi))
    shallow = Grid(W, 4 * ny * nx)
    rng = np.random.default_rng(0)

    def field(g, scale=1.0, offset=0.0):
        full = rng.standard_normal(g.shape).astype(np.float32)
        return dm.shard_field(torch.from_numpy(full * scale + offset), mesh)

    terrain = field(grid, 2.0)
    u, v, p0, div = (field(grid, 0.1) for _ in range(4))
    cases = {
        "climate_deep": lambda: temperature.temperature_step(
            field(grid, 10.0, 40.0), terrain, 0.0, grid, substeps=40,
            mesh=mesh),
        "flow_shallow": lambda: flow.flow_filter_device(
            field(shallow, 20.0), field(shallow, 0.0, 1.0), shallow,
            mesh=mesh),
        "quirks": lambda: ocean.diffusion(
            u, v, terrain, grid, ocean.OceanConfig(exact_quirks=True),
            mesh=mesh),
        "pressure_warm": lambda: ocean.pressure_solve(
            div, terrain, grid, ocean.OceanConfig(jacobi_iters=200), p0=p0,
            mesh=mesh),
        "band_step": lambda: model.coupled_step(
            model.init_coupled(field(band, 2.0), band, mesh=mesh), band,
            mesh=mesh)}
    out = {}
    for name, run in cases.items():
        dm.reset_traffic()
        run()
        out[name] = dm.traffic()
    return out


def _rank(args):
    import torch.distributed as dist

    from demiurge_tpu_torch.core.platform import collective_backend

    dist.init_process_group(collective_backend("cpu"),
                            init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.ny * args.nx)
    recs = _case_records(args.ny, args.nx, args.width, args.height)
    every = [None] * (args.ny * args.nx)
    dist.all_gather_object(every, recs)
    if args.rank == 0:
        print(json.dumps({
            "mesh": [args.ny, args.nx], "grid": [args.width, args.height],
            "cases": {name: [r[name] for r in every] for name in recs}}))
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--tree", default=None,
                    help="the checkout whose package to import")
    # one rank of the group that ``main`` starts
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.ny, args.nx = (int(n) for n in args.mesh.lower().split("x"))
    if args.rank is not None:
        _rank(args)
        return 0
    tree = pathlib.Path(args.tree or pathlib.Path(__file__).parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(tree.resolve()))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, str(pathlib.Path(__file__).resolve()),
                "--mesh", args.mesh, "--width", str(args.width),
                "--height", str(args.height), "--store",
                f"{tmp}/store"]
        procs = [subprocess.Popen(base + ["--rank", str(r)], env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for r in range(args.ny * args.nx)]
        outs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        return 1
    print(outs[0].strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
