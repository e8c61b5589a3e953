"""Time the band-local flow kernels K10a and K10b of a checkout of the
port, on the card.

    python demiurge_tpu_torch/tools/flow_local_race.py [--tree DIR]
        [--width 2048] [--height 1024] [--band 128] [--reps 5]

Imports ``demiurge_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and makes the flow masks of the
coupled CLI's terrain (fBm, seed 7: the flow pre-blur, the directions,
the mouths, ``pack_masks``), masked to bands of ``--band`` rows.  Then,
each timed with CUDA events over ``--reps`` calls after a warm-up call:
K10a cold (A from the area, with exit ids), K10a warm (the two-level
solve's re-solve without exit ids, from A_loc plus the coarse graph's
injections), and K10b from a seed on the bands' boundary rows.  Each
result is held to its plain twin (A and the exit ids bit for bit, vis
exactly).  Prints one JSON line: the tree, the card, and each call's ms
and launches.  Only entry points that every slice of the port since the
sharded step has are used, so two checkouts can be raced alternately in
one session on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(HERE.parent.parent))
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--band", type=int, default=128)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    tree = pathlib.Path(args.tree).resolve()
    sys.path = [str(tree)] + [q for q in sys.path
                              if pathlib.Path(q or ".").resolve() != HERE]
    import torch

    import demiurge_tpu_torch
    from demiurge_tpu_torch import model
    from demiurge_tpu_torch.api import cli
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.kernels import build
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow2 as k2
    from demiurge_tpu_torch.ops import blur as ob
    from demiurge_tpu_torch.ops import flow as of

    pkg = pathlib.Path(demiurge_tpu_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise RuntimeError(f"imported {pkg}, not the package in {tree}")
    build.build()
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    dev = torch.device("cuda")
    grid = Grid(args.width, args.height)
    H, W, band = args.height, args.width, args.band
    hb = ob.blur(cli._terrain(grid, args.seed, dev), grid,
                 model.CoupledConfig().flow_preblur)
    code = of.flow_directions(hb, torch.ones_like(hb), grid)
    _, mouth, _ = of.incoming_mask(code, grid)
    area = of.cell_area_lower_edge(grid, dev)
    packed = kf.pack_masks(code, mouth, grid)
    ploc = k2.mask_local(packed, band)

    A_loc, E = k2.flow_local_solve_cuda(ploc, area, area, band)
    succ, m0, _, tflat_g, _, cross = k2.coarse_graph(packed, A_loc, E, band)
    X = k2._accumulate_adaptive(succ, m0)
    inj = torch.zeros(H * W + 1, device=dev).index_add_(
        0, tflat_g, torch.where(cross, X, 0.0))[:H * W].reshape(H, W)
    seed = torch.zeros_like(area)
    seed[band - 1::band, ::7] = 1.0
    seed[band::band, 3::11] = 1.0

    calls = {
        "K10a cold": (lambda: k2.flow_local_solve_cuda(ploc, area, area,
                                                       band),
                      lambda: k2.flow_local_solve_plain(ploc, area, area,
                                                        band),
                      "LAUNCHES_LOCAL"),
        "K10a warm": (lambda: k2.flow_local_solve_cuda(
            ploc, area + inj, A_loc + inj, band, with_exit=False)[0],
                      lambda: k2.flow_local_solve_plain(
            ploc, area + inj, A_loc + inj, band, with_exit=False)[0],
                      "LAUNCHES_LOCAL"),
        "K10b seeded": (lambda: k2.flow_local_vis_cuda(ploc, seed, band),
                        lambda: k2.flow_local_vis_plain(ploc, seed, band),
                        "LAUNCHES_LOCAL_VIS"),
    }
    out = {"tree": str(tree), "card": card, "grid": f"{W}x{H}",
           "band": band}
    for name, (kernel, plain, counter) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise RuntimeError(f"{name}: differs from its plain twin")
        before = getattr(k2, counter)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            kernel()
        end.record()
        end.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / args.reps,
                     "launches": (getattr(k2, counter) - before) / args.reps}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
