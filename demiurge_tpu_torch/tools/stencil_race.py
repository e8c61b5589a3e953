"""Time the climate and blur kernels K1 and K5 of a checkout of the port,
on the card.

    python demiurge_tpu_torch/tools/stencil_race.py [--tree DIR]
        [--width 2048] [--height 1024] [--climate 4096x2048] [--reps 20]

Imports ``demiurge_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and makes the coupled CLI's terrain
(fBm, seed 7) at ``--width`` x ``--height`` and at ``--climate``, with a
temperature of 50 C plus a tenth of the height and the heat capacity of
that terrain.  Then, each timed with CUDA events over ``--reps`` calls
after a warm-up call (the dispatch over a fifth as many), and each held to
its plain twin bit for bit (NaN where the twin has NaN):

- "K1 step": the coupled step's 10 substeps (``climate_step_cuda``);
- "K1 dispatch": a climate dispatch's 250 substeps at ``--climate`` (the
  climate CLI's size, where the reference diverges on land);
- "K5 pre-blur": the flow pre-blur, radius 0.5 (``blur_cuda``).

Prints one JSON line: the tree, the card, and each call's ms and
launches.  Only entry points that every slice of the port since the
coupled step has are used, so two checkouts can be raced alternately on
one card (order A B B A).
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
    p.add_argument("--climate", default="4096x2048")
    p.add_argument("--reps", type=int, default=20)
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
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.kernels import build
    from demiurge_tpu_torch.kernels import climate as kc
    from demiurge_tpu_torch.ops import temperature
    from demiurge_tpu_torch.ops.blur import sigma_list

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

    def climate_inputs(grid, substeps):
        h = cli._terrain(grid, args.seed, dev)
        T = (temperature.init_temperature(grid, dev) + 0.1 * h).contiguous()
        asr = temperature.insolation_table(
            grid, torch.full((), 3.0, device=dev), substeps, 0.30)
        cinv = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
                / temperature.heat_capacity(h)).contiguous()
        return T, cinv, asr, h

    grid = Grid(args.width, args.height)
    T, cinv, asr, h = climate_inputs(grid, 10)
    cgrid = Grid(*map(int, args.climate.split("x")))
    cT, ccinv, casr, _ = climate_inputs(cgrid, 250)
    rlist = sigma_list(model.CoupledConfig().flow_preblur)
    calls = {
        "K1 step": (lambda: kc.climate_step_cuda(T, cinv, asr, grid, 0.55e6),
                    lambda: kc.climate_step_plain(T, cinv, asr, grid,
                                                  0.55e6),
                    kc, args.reps),
        "K1 dispatch": (lambda: kc.climate_step_cuda(cT, ccinv, casr, cgrid,
                                                     0.55e6),
                        lambda: kc.climate_step_plain(cT, ccinv, casr, cgrid,
                                                      0.55e6),
                        kc, max(1, args.reps // 5)),
        "K5 pre-blur": (lambda: kb.blur_cuda(h, grid, rlist),
                        lambda: kb.blur_plain(h, grid, rlist), kb,
                        args.reps),
    }
    out = {"tree": str(tree), "card": card,
           "grid": f"{args.width}x{args.height}", "climate": args.climate}
    for name, (kernel, plain, mod, reps) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        same = torch.equal(torch.isnan(got), torch.isnan(want)) and \
            torch.equal(torch.nan_to_num(got, nan=0.0),
                        torch.nan_to_num(want, nan=0.0))
        if not same:
            raise RuntimeError(f"{name}: differs from its plain twin")
        del got, want
        before = mod.LAUNCHES
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kernel()
        end.record()
        end.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / reps,
                     "launches": (mod.LAUNCHES - before) / reps}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
