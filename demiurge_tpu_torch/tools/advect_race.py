"""Time the fused advect stage (K4's stage form) and the packed direction
kernel (K6's packed form) of a checkout of the port, on the card.

    python demiurge_tpu_torch/tools/advect_race.py [--tree DIR]
        [--width 2048] [--height 1024] [--reps 20]

Imports ``demiurge_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and makes the ocean CLI's terrain
(fBm, seed 7) at ``--width`` x ``--height`` and (u, v) after one ocean
step from rest.  Then each call is held to its twin bit for bit and timed
on the device over ``--reps`` calls queued behind a sleep kernel
(``tools.timing.device_ms``), so that the host's time in the wrappers
stays out of the kernel's time:

- "advect stage": the whole advect stage (``advect_stage_cuda``);
- "directions packed": the codes and packed flow masks
  (``directions_packed_cuda``) on the pre-blurred terrain;
- "directions codes": the codes-only form (``flow_directions_cuda``).

Prints one JSON line: the tree, the card, and each call's ms.  Two
checkouts that both have these entry points are raced alternately on one
card (order A B B A).
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
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    tree = pathlib.Path(args.tree).resolve()
    sys.path = [str(tree)] + [q for q in sys.path
                              if pathlib.Path(q or ".").resolve() != HERE]
    import torch

    import demiurge_tpu_torch
    from demiurge_tpu_torch.api import cli
    from demiurge_tpu_torch.core.grid import Grid
    from demiurge_tpu_torch.kernels import advect as ka
    from demiurge_tpu_torch.kernels import build
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.kernels.flow import pack_masks
    from demiurge_tpu_torch.ops import ocean
    from demiurge_tpu_torch.ops.blur import blur
    from demiurge_tpu_torch.ops.flow import incoming_mask
    from demiurge_tpu_torch.tools.timing import device_ms

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
    terrain = cli._terrain(grid, args.seed, dev)
    cfg = ocean.OceanConfig(jacobi_iters=200, diffusion_iters=50)
    u, v = ocean.init_ocean(grid, dev)
    u, v, _, _ = ocean.ocean_step(u, v, terrain, grid, cfg)
    hb = blur(terrain, grid, 0.5).contiguous()
    sel = torch.ones_like(hb)

    def ms_of(fn):
        return round(device_ms(fn, args.reps), 5)

    ms = {}
    got = ka.advect_stage_cuda(u, v, terrain, grid, cfg)
    want = ka.advect_stage_plain(u, v, terrain, grid, cfg)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("the advect stage differs from its twin")
    ms["advect stage"] = ms_of(
        lambda: ka.advect_stage_cuda(u, v, terrain, grid, cfg))
    code, packed = kd.directions_packed_cuda(hb, sel, grid)
    _, mouth, _ = incoming_mask(code, grid)
    if not (torch.equal(code, kd.flow_directions_cuda(hb, sel, grid))
            and torch.equal(packed, pack_masks(code, mouth, grid))):
        raise RuntimeError("the packed form differs from the codes form "
                           "or from pack_masks of its codes")
    ms["directions packed"] = ms_of(
        lambda: kd.directions_packed_cuda(hb, sel, grid))
    ms["directions codes"] = ms_of(
        lambda: kd.flow_directions_cuda(hb, sel, grid))
    print(json.dumps({"tree": str(tree), "card": card,
                      "grid": f"{args.width}x{args.height}", "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
