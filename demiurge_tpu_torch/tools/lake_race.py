"""Time K12, the lake-aware relaxation's tiled solve, of a checkout of the
port, on the card.

    python demiurge_tpu_torch/tools/lake_race.py [--tree DIR]
        [--sizes 2048x1024 1024x512] [--reps 5] [--rounds]

Imports ``demiurge_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and makes, at each size, the inputs
of the erosion CLI's first relaxation (fBm, seed 7: the pre-blur, the
directions, the mouths, the native lake solution's connections, the
packed masks).  The tiled solve is held to the twin's (A bit for bit,
vis and root exactly); then, each timed with CUDA events over ``--reps``
calls after a warm-up call: each tiled kernel's solve alone
(``tile_solves`` of one part), the three side by side
(``relax_solve_cuda``), the whole ``flow_solve_stencil``, and the
packing around the kernels (``conn_fields``, ``pack_lake_masks``).
With ``--rounds``, the A and vis solves once more, one launch a round,
each round timed with CUDA events and its tile visits and most passes
read after it.  Prints one JSON line: the tree, the card, and at each
size the rounds, tile visits and most passes a visit of each solve, each
call's ms and, with ``--rounds``, each round's (us, visits, passes).
Two checkouts (or a copy of this one with a kernel's source edited) are
raced alternately in one call on one card, order A B B A.
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
    p.add_argument("--sizes", nargs="+", default=["2048x1024", "1024x512"])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--rounds", action="store_true")
    args = p.parse_args(argv)

    tree = pathlib.Path(args.tree).resolve()
    sys.path = [str(tree)] + [q for q in sys.path
                              if pathlib.Path(q or ".").resolve() != HERE]
    import torch

    import demiurge_tpu_torch
    from demiurge_tpu_torch.api import cli
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.kernels import build
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import lakeflow as kl
    from demiurge_tpu_torch.native import lakes as nlakes
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

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return round(start.elapsed_time(end) / args.reps, 3)

    out = {"tree": str(tree), "card": card}
    for size in args.sizes:
        W, H = map(int, size.split("x"))
        grid = Grid(W, H)
        h = cli._terrain(grid, args.seed, dev)
        code = of.flow_directions(ob.blur(h, grid, 0.5), torch.ones_like(h),
                                  grid)
        mask, mouth, _ = of.incoming_mask(code, grid)
        sol = nlakes.solve_lakes_native(
            mask.cpu().numpy().reshape(-1), mouth.cpu().numpy().reshape(-1),
            h.cpu().numpy().reshape(-1),
            of.parent_pointers(code, grid).cpu().numpy(), grid)
        cfrom = torch.from_numpy(sol.conn_from).to(dev)
        cto = torch.from_numpy(sol.conn_to).to(dev)
        src, dst = kl.conn_fields(cfrom, cto, grid.shape)
        packed = kl.pack_lake_masks(code, mouth, grid, src, dst)
        area = of.cell_area_lower_edge(grid, dev)

        A, vis, root, stats = kl.relax_solve_cuda(packed, area, src, dst,
                                                  grid, want_root=True)
        wA, wvis, wroot, _ = kl.relax_solve_twin(packed, area, src, dst,
                                                 grid, want_root=True)
        if not (torch.equal(A.view(torch.int32), wA.view(torch.int32))
                and torch.equal(vis, wvis) and torch.equal(root, wroot)):
            raise RuntimeError(f"{size}: the tiled solve left the twin's")
        row = {"connections": int(cfrom.numel())}
        for part, st in stats.items():
            row[part] = {"rounds": st["rounds"],
                         "tiles_run": st["tiles_run"],
                         "max_inner_sweeps": st["max_inner_sweeps"],
                         "ms": ms(lambda part=part: kl.tile_solves(
                             packed, area, src, dst, grid, (part,)))}
        row["side_by_side_ms"] = ms(lambda: kl.relax_solve_cuda(
            packed, area, src, dst, grid, want_root=True))
        row["flow_solve_stencil_ms"] = ms(lambda: of.flow_solve_stencil(
            code, area, mouth, grid, conn_from=cfrom, conn_to=cto,
            want_root=True))
        row["conn_fields_ms"] = ms(lambda: kl.conn_fields(cfrom, cto,
                                                          grid.shape))
        row["pack_lake_masks_ms"] = ms(lambda: kl.pack_lake_masks(
            code, mouth, grid, src, dst))
        if args.rounds:
            row["each_round"] = {part: one_round_a_launch(
                build.library(), kf, kl, part, packed, area, src, dst, grid)
                for part in ("A", "vis")}
        out[size] = row
    print(json.dumps(out))
    return 0


def one_round_a_launch(lib, kf, kl, part, packed, area, src, dst, grid):
    """The tiled ``part`` solve ("A" or "vis") one launch a round, each
    round timed alone with CUDA events, to the certifying round: a list
    of (us, tile visits, most passes a visit)."""
    import torch

    ty, tx = kf.TILE
    H, W = grid.shape
    nt = -(-H // ty) * -(-W // tx)
    flags = torch.full((4 * nt,), -1, dtype=torch.int32, device=area.device)
    flags[2 * nt:] = 0
    stats = torch.zeros(3, dtype=torch.int32, device=area.device)
    stream = torch.cuda.current_stream(area.device).cuda_stream
    if part == "A":
        field = area.clone()
        ins = (packed, area, src, dst, field)
    else:
        field = ((packed >> 16) & 1).to(torch.uint8)
        ins = (packed, src, dst, field)
    entry = getattr(lib, kl.TILE_ENTRIES[part])
    rows = []
    for r in range(kf._max_sweeps(grid)):
        stats.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = entry(*[t.data_ptr() for t in ins], int(grid.wrap_x),
                    flags.data_ptr(), stats.data_ptr(), H, W, ty, tx, r, 1,
                    stream)
        end.record()
        end.synchronize()
        if err:
            raise RuntimeError(f"{kl.TILE_ENTRIES[part]}: CUDA error {err}")
        visits, passes, wrote = stats.tolist()
        rows.append((round(start.elapsed_time(end) * 1e3, 1), visits,
                     passes))
        if not wrote:
            return rows
    raise RuntimeError(f"{part}: no certifying round")


if __name__ == "__main__":
    sys.exit(main())
