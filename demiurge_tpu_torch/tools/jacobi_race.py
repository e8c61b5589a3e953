"""Race tile shapes of the tiled Jacobi kernels K2 and K3, or K11e, on the card.

    python -m demiurge_tpu_torch.tools.jacobi_race [W H] [--variants V,...]
        [--kernel jacobi|packed] [--source FILE] [--reps 10] [--rounds 2]

A variant is ``PTHxPTW/DTHxDTW/k[/warps[/blocks]]``: the pressure tile, the
viscosity tile, the sweeps a launch and, optionally, the warps a block and
the blocks an SM the registers are budgeted for (default: the source's).
``--kernel`` picks K2/K3 (``csrc/jacobi.cu``, ``kernels.jacobi``) or the
packed K11e (``csrc/jacobi_packed.cu``, ``kernels.jacobi_packed``, whose
one-field and two-field tiles are the pressure and viscosity tiles).  For
each variant, the source (default: this checkout's; ``--source`` takes
another tree's, e.g. from ``git archive``, with the same entry points) is
copied with those constants rewritten and built (one ``nvcc`` per variant,
all started together) into a library of its own beside
``csrc/errors.cu``; then, on the ocean CLI's terrain (fBm, seed 7, default
2048x1024) and a (u, v) after one ocean step through the plain twins,
each variant runs the coupled model's solves, 200 pressure sweeps and 50
viscosity sweeps on (u, v), through the kernel's wrappers, is held bit for
bit to the plain twins and is timed with CUDA events (``--reps`` calls, in
``--rounds`` rounds over the variants, in turn).  Prints one JSON line a
variant and round, with the card's name and power limit.  The source in
the checkout is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import tempfile
from unittest import mock

import torch

from ..api import cli
from ..core.grid import Grid
from ..kernels import advect as ka
from ..kernels import build
from ..kernels import jacobi as kj
from ..kernels import jacobi_packed as kp
from ..ops import ocean

DEFAULT = {
    "jacobi": ("32x128/16x128/8,16x128/8x128/8,64x64/32x64/8,32x64/16x64/8,"
               "32x128/32x128/4,32x128/16x128/6,16x128/8x128/12,"
               "16x64/8x64/16"),
    "packed": ("32x128/32x64/8/16/2,32x128/32x64/8/16/1,32x64/32x64/8/16/3,"
               "16x128/16x64/8/8/4,32x128/32x128/8/16/2,32x128/32x64/12/16/2"),
}
# the entry points a kernel's library must carry
ENTRIES = {"jacobi": ("demiurge_jacobi_pressure", "demiurge_jacobi_diffusion"),
           "packed": ("demiurge_jacobi_packed",)}


def _parse(variant: str):
    p, d, k, *rest = variant.split("/")
    pt = tuple(int(n) for n in p.split("x"))
    dt = tuple(int(n) for n in d.split("x"))
    ty, nb = (list(map(int, rest)) + [None, None])[:2]
    return pt, dt, int(k), ty, nb


def _source(path, pt, dt, k, ty, nb) -> str:
    src = pathlib.Path(path).read_text()
    subs = [(r"constexpr int kSweeps = \d+;", f"constexpr int kSweeps = {k};"),
            (r"constexpr int kPressureRows = \d+, kPressureCols = \d+;",
             f"constexpr int kPressureRows = {pt[0]}, kPressureCols = "
             f"{pt[1]};"),
            (r"constexpr int kDiffusionRows = \d+, kDiffusionCols = \d+;",
             f"constexpr int kDiffusionRows = {dt[0]}, kDiffusionCols = "
             f"{dt[1]};")]
    if ty is not None:
        subs.append((r"constexpr int kThreadsX = 32, kThreadsY = \d+;",
                     f"constexpr int kThreadsX = 32, kThreadsY = {ty};"))
    if nb is not None:
        subs.append((r"constexpr int kBlocksPerSM = \d+;",
                     f"constexpr int kBlocksPerSM = {nb};"))
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{path}: no single match of {pattern!r}")
    return src


def build_variants(path, variants, workdir: pathlib.Path,
                   kernel: str = "jacobi"):
    """One library a variant, compiled in parallel: [ctypes.CDLL]."""
    nvcc = build._nvcc()
    procs, libs = [], []
    for j, variant in enumerate(variants):
        d = workdir / f"v{j}"
        d.mkdir()
        (d / "jacobi.cu").write_text(_source(path, *variant))
        lib = d / "libjacobi.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(d / "jacobi.cu"), str(build.CSRC_DIR / "errors.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        libs.append(lib)
    out = []
    for proc, lib in zip(procs, libs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.parent.name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.parent.name} ptxas: {line.strip()}")
        cdll = ctypes.CDLL(str(lib))
        for name in ENTRIES[kernel]:
            fn = getattr(cdll, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        cdll.demiurge_error_string.argtypes = [ctypes.c_int]
        cdll.demiurge_error_string.restype = ctypes.c_char_p
        out.append(cdll)
    return out


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("size", nargs="*", type=int, metavar="W H")
    p.add_argument("--kernel", choices=sorted(DEFAULT), default="jacobi")
    p.add_argument("--variants")
    p.add_argument("--source")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    W, H = list(args.size) + [2048, 1024][len(args.size):]
    source = args.source or str(build.CSRC_DIR / (
        "jacobi.cu" if args.kernel == "jacobi" else "jacobi_packed.cu"))
    variants = [_parse(v) for v in (args.variants
                                    or DEFAULT[args.kernel]).split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    dev = torch.device("cuda")
    grid = Grid(W, H)
    terrain = cli._terrain(grid, 7, dev)
    cfg = ocean.OceanConfig(jacobi_iters=200, diffusion_iters=50)
    u, v = ocean.init_ocean(grid, dev)
    with mock.patch.object(kj, "pressure_solve", kj.pressure_solve_plain), \
            mock.patch.object(kj, "diffusion_solve",
                              kj.diffusion_solve_plain), \
            mock.patch.object(ka, "advect_sample",
                              ka.advect_sample_tiered_plain):
        u, v, _, _ = ocean.ocean_step(u, v, terrain, grid, cfg)
    div = ocean.divergence(u, v, terrain, grid, cfg)
    p0 = torch.zeros_like(div)
    if args.kernel == "jacobi":
        co = kj.coefficients(div, terrain, grid)
        dco = kj.diffusion_coefficients(terrain, grid)

        def solves(pt, dt, k):
            """(pressure solve, viscosity solve, the patched constants)."""
            return (lambda: kj.pressure_solve_cuda(*co, p0, grid, 200),
                    lambda: kj.diffusion_solve_cuda(*dco, u, v, grid, 50),
                    mock.patch.multiple(kj, PRESSURE_TILE=pt,
                                        DIFFUSION_TILE=dt,
                                        SWEEPS_PER_LAUNCH=k))

        want_p = kj.pressure_solve_plain(*co, p0, grid, 200)
        want_u, want_v = kj.diffusion_solve_plain(*dco, u, v, grid, 50)
    else:
        b = kj.coefficients(div, terrain, grid)[5]
        pressure = (kp.pack_ob(terrain, grid, True),
                    kp.row_table(grid, "pressure", dev), b, [p0], grid, 200,
                    True, False)
        viscosity = (kp.pack_ob(terrain, grid, False),
                     kp.row_table(grid, "viscosity", dev), None, [u, v],
                     grid, 50, False, True)

        def solves(pt, dt, k):
            return (lambda: kp.resident_call_packed_cuda(*pressure)[0],
                    lambda: kp.resident_call_packed_cuda(*viscosity),
                    mock.patch.multiple(kp, TILES={1: pt, 2: dt},
                                        SWEEPS_PER_LAUNCH=k))

        (want_p,) = kp.resident_call_packed_plain(*pressure)
        want_u, want_v = kp.resident_call_packed_plain(*viscosity)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(source, variants, pathlib.Path(tmp),
                              args.kernel)
        for rnd in range(args.rounds):
            for (pt, dt, k, ty, nb), lib in zip(variants, libs):
                solve_p, solve_d, constants = solves(pt, dt, k)
                with mock.patch.object(build, "library", lambda: lib), \
                        constants:
                    got_p = solve_p()
                    got_u, got_v = solve_d()
                    torch.cuda.synchronize()
                    equal = (torch.equal(got_p, want_p)
                             and torch.equal(got_u, want_u)
                             and torch.equal(got_v, want_v))
                    ms_p = cuda_ms(solve_p, args.reps)
                    ms_d = cuda_ms(solve_d, args.reps)
                print(json.dumps({
                    "kernel": args.kernel, "source": source, "round": rnd,
                    "pressure_tile": pt, "diffusion_tile": dt, "k": k,
                    "warps": ty, "blocks_per_sm": nb, "grid": f"{W}x{H}",
                    "equal_to_twins": equal,
                    "pressure_200_ms": ms_p, "viscosity_50_ms": ms_d,
                    "card": card}), flush=True)
                if not equal:
                    return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
