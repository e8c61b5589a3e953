"""Weak (or strong) scaling of the coupled step: grid-points/s at 1, 2, 4,
... ranks, and what each rank receives a step.

Counterpart of the reference's ``tools/scaling_bench.py`` (BASELINE's
scaling metric).  One process group per mesh size n = 1, 2, 4, ... up to
``--ranks`` (n = 1 runs the single-device step, ``mesh=None``, as the
reference does); the mesh is ``dist.mesh.choose_mesh_shape(n)``.  Weak
scaling holds each rank's tile at ``--base-width`` x ``--base-height``
(the grid grows with the mesh), strong scaling (``--strong``) holds the
grid.  Each size runs one warm-up step, then ``--steps`` timed steps on
the host clock (the device synchronised before and after), and prints
one JSON line with the reference's keys (``devices``, ``mesh``, ``grid``
as [H, W], ``grid_points_per_s``, ``per_device``, ``efficiency_vs_1``,
``mode``) and, from ``dist.mesh``'s traffic counters over the timed
steps, each rank's bytes received a step by kind (``bytes_per_step``)
with its ``sharded_call``s and full-field gathers a step.  ``--overlap``
turns on the solvers' overlapped halo rounds (``dist.halo.OVERLAP``);
the record's ``overlap`` says whether it was on and ``last_solve_rounds``
holds rank 0's last pressure solve's rounds (``dist.halo.LAST_OVERLAP``:
rounds, rounds split, split rounds issued in flight).

On the CPU (gloo, one process a rank; keep the threads a rank low):

    OMP_NUM_THREADS=1 python -m demiurge_tpu_torch.tools.scaling_bench \\
        --device cpu --base-width 256 --base-height 128 --ranks 4

On the card (NCCL, one rank a card; the default device):

    python -m demiurge_tpu_torch.tools.scaling_bench --base-width 2048 \\
        --base-height 1024 --steps 5

``--device cuda`` refuses, with a message and exit code 2, a largest
rank count above ``torch.cuda.device_count()`` (the default is that
count); it never moves a run to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weak", action="store_true", default=True)
    ap.add_argument("--strong", dest="weak", action="store_false")
    ap.add_argument("--base-width", type=int, default=1024)
    ap.add_argument("--base-height", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--jacobi", type=int, default=200)
    ap.add_argument("--overlap", action="store_true",
                    help="sweep each block's centre while its halo "
                         "exchange is in flight (dist.halo.OVERLAP)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one rank a card) or cpu (gloo)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="the largest rank count (default: the cards, or 4 "
                         "on the CPU)")
    # one rank of one size (the subprocesses this tool starts)
    ap.add_argument("--one", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    return ap


def sizes(largest: int):
    """1, 2, 4, ... up to ``largest``."""
    n, out = 1, []
    while n <= largest:
        out.append(n)
        n *= 2
    return out


def run_rank(args) -> dict:
    """One rank of one mesh size: its step rate and traffic (the record
    on rank 0, None on the others)."""
    import torch.distributed as dist

    from ..core.grid import Grid
    from ..core.platform import claim_rank_device, collective_backend
    from ..dist import halo
    from ..dist import mesh as dm
    from ..model import CoupledConfig, coupled_step, init_coupled
    from ..ops.noise import NoiseParams, fbm
    from ..ops.ocean import OceanConfig

    n = args.one
    halo.OVERLAP = args.overlap
    device = claim_rank_device(args.device, args.rank)
    mesh = None
    ny, nx = dm.choose_mesh_shape(n)
    if n > 1:
        dist.init_process_group(collective_backend(device),
                                init_method=f"file://{args.store}",
                                rank=args.rank, world_size=n)
        mesh = dm.make_mesh(shape=(ny, nx), device=device)
    W, H = ((args.base_width * nx, args.base_height * ny) if args.weak
            else (args.base_width, args.base_height))
    grid = Grid(W, H)
    cfg = CoupledConfig(climate_substeps=10, ocean=OceanConfig(
        jacobi_iters=args.jacobi, diffusion_iters=50))
    h = fbm(grid, NoiseParams(octaves=6, scale=2.0, min=-2.0, max=3.0,
                              seed=7), device)
    if mesh is not None:
        h = dm.shard_field(h, mesh)
    state = init_coupled(h, grid, mesh=mesh)
    del h

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if mesh is not None:
            dist.barrier()

    state = coupled_step(state, grid, cfg, mesh=mesh)  # warm-up
    sync()
    dm.reset_traffic()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = coupled_step(state, grid, cfg, mesh=mesh)
    sync()
    dt = (time.perf_counter() - t0) / args.steps
    finite = bool(torch.isfinite(state.height).all())
    mine = dm.traffic()
    per_step = {"bytes": {k: v / args.steps for k, v in mine["bytes"].items()},
                "sharded_call": mine["sharded_call"] / args.steps,
                "field_gathers": mine["field_gathers"] / args.steps,
                "finite": finite}
    ranks = [per_step]
    if mesh is not None:
        ranks = [None] * n
        dist.all_gather_object(ranks, per_step)
        dist.destroy_process_group()
    if args.rank != 0:
        return None
    gps = W * H / dt
    return {"devices": n, "mesh": [ny, nx], "grid": [H, W],
            "grid_points_per_s": gps, "per_device": gps / n,
            "mode": "weak" if args.weak else "strong",
            "device": device.type, "ms_per_step": dt * 1e3,
            "overlap": args.overlap,
            "last_solve_rounds": dict(halo.LAST_OVERLAP),
            "finite": all(r["finite"] for r in ranks),
            "bytes_per_step": [r["bytes"] for r in ranks],
            "sharded_calls_per_step": max(r["sharded_call"] for r in ranks),
            "field_gathers_per_step": max(r["field_gathers"]
                                          for r in ranks)}


def run_size(args, n: int):
    """Start the n ranks of one mesh size; rank 0's record, or an error
    record."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "demiurge_tpu_torch.tools.scaling_bench",
               "--one", str(n), "--store", os.path.join(tmp, "store"),
               "--device", args.device, "--base-width", str(args.base_width),
               "--base-height", str(args.base_height), "--steps",
               str(args.steps), "--jacobi", str(args.jacobi)]
        if not args.weak:
            cmd.append("--strong")
        if args.overlap:
            cmd.append("--overlap")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(var, None)
        procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
                 for r in range(n)]
        outs = [p.communicate() for p in procs]
    rec = None
    for line in outs[0][0].splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if rec is None or bad:
        return {"devices": n, "error": f"ranks {bad} failed",
                "stderr": (outs[bad[0] if bad else 0][1] or "")[-2000:]}
    return rec


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.one:
        rec = run_rank(args)
        if rec is not None:
            print(json.dumps(rec), flush=True)
        return 0
    device = torch.device(args.device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        largest = cards if args.ranks is None else args.ranks
        if largest > cards or cards == 0:
            print(f"scaling_bench: {largest} ranks need {largest} CUDA "
                  f"devices, this machine has {cards} (one rank a card; "
                  f"--device cpu runs gloo ranks on the CPU)",
                  file=sys.stderr)
            return 2
    else:
        largest = 4 if args.ranks is None else args.ranks
    base, ok = None, True
    for n in sizes(largest):
        rec = run_size(args, n)
        if "error" in rec:
            ok = False
        else:
            if n == 1:
                base = rec["per_device"]
            rec["efficiency_vs_1"] = (rec["per_device"] / base
                                      if base else None)
            ok = ok and rec["finite"]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
