"""One rank of a gloo process group on the CPU, for tests/test_torch_dist.py.

    python tests/torch_mesh_worker.py INPUTS.npz OUTDIR NY NX RANK

Joins a group of NY*NX processes through the file store OUTDIR/store,
builds the NYxNX mesh, runs every sharded path of the port on the full
fields in INPUTS.npz (each rank takes its block), gathers the results and,
on rank 0, writes them to OUTDIR/out.npz.  It imports torch, numpy and the
port only (never JAX), so the parent test can hold the results to the
reference package.
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from demiurge_tpu_torch.core.grid import Grid  # noqa: E402
from demiurge_tpu_torch.dist import advect as dadv  # noqa: E402
from demiurge_tpu_torch.dist import climate as dclim  # noqa: E402
from demiurge_tpu_torch.dist import flowdist, halo  # noqa: E402
from demiurge_tpu_torch.dist import mesh as dm  # noqa: E402


def main(inputs, outdir, ny, nx, rank):
    torch.set_num_threads(1)
    outdir = pathlib.Path(outdir)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                            rank=rank, world_size=ny * nx)
    mesh = dm.make_mesh(shape=(ny, nx), device="cpu")
    data = dict(np.load(inputs))
    meta = json.loads(str(data.pop("meta")))
    grid = Grid(*meta["shape"])
    full = {k: torch.from_numpy(v) for k, v in data.items()}
    blk = {k: dm.shard_field(v, mesh) if v.dim() == 2 else v
           for k, v in full.items()}
    out = {}

    def put(name, block):
        out[name] = dm.gather_field(block, mesh).numpy()

    # halo exchanges: padded blocks and row groups, gathered as mosaics
    k = meta["k"]
    f = blk["f"]
    put("halo", halo.exchange_halo(f, k, grid, mesh))
    put("halo_neg", halo.exchange_halo(f, k, grid, mesh, negate_pole=True))
    rows = dm.blocks_to_rows(f, mesh)
    out["rows"] = dm.all_gather_rows(rows, mesh).numpy()
    for edge in ("reflect", "flip", "clamp", "zero"):
        out[f"rows_{edge}"] = dm.all_gather_rows(
            halo.exchange_rows_halo(rows, k, mesh, grid, edge), mesh).numpy()
    put("rows_back", dm.rows_to_blocks(rows, mesh))

    # both sharded flow solves
    args = (blk["code"], blk["area"], blk["mouth"].bool(), grid, mesh)
    if flowdist.flow_sharded_twolevel_supported(grid, mesh):
        A, vis = flowdist.flow_solve_sharded_twolevel(*args)
        put("flow2_A", A)
        put("flow2_vis", vis)
    A, vis = halo.flow_solve_sharded(*args)
    put("flowh_A", A)
    put("flowh_vis", vis)

    # ocean solvers, climate, advect
    put("pressure", halo.pressure_solve_sharded(
        blk["div"], blk["terrain"], grid, mesh, iters=meta["jacobi"], k=8))
    du, dv = halo.diffusion_solve_sharded(blk["u"], blk["v"], blk["terrain"],
                                          grid, mesh,
                                          iters=meta["diffusion"])
    put("diff_u", du)
    put("diff_v", dv)
    T, i1 = dclim.climate_step_sharded(blk["T"], blk["terrain"], 3.0, grid,
                                       mesh, substeps=meta["substeps"])
    put("climate", T)
    out["climate_i"] = np.asarray(float(i1))
    from demiurge_tpu_torch.ops import ocean

    cfg = ocean.OceanConfig()
    au, av = ocean.advect(blk["u"], blk["v"], blk["terrain"], grid, cfg,
                          mesh=mesh)
    put("advect_u", au)
    put("advect_v", av)
    su, sv = dadv.advect_sample_sharded(blk["u"], blk["v"], blk["s2"],
                                        blk["t2"], grid, mesh)
    put("sample_u", su)
    put("sample_v", sv)

    # two coupled steps on blocks
    from demiurge_tpu_torch.model import CoupledConfig, coupled_step, \
        init_coupled
    from demiurge_tpu_torch.utils import interop

    ccfg = CoupledConfig(climate_substeps=2, ocean=dataclasses.replace(
        CoupledConfig().ocean, jacobi_iters=16, diffusion_iters=5))
    state = init_coupled(blk["terrain"], grid, mesh=mesh)
    for tag in ("coupled1", "coupled"):  # after one step and after two
        state = coupled_step(state, grid, ccfg, mesh=mesh)
        for name, arr in interop.coupled_state_blocks_to_numpy(
                state, mesh).items():
            out[f"{tag}_{name}"] = arr

    # the CLI under this mesh (rank 0 logs)
    from demiurge_tpu_torch.api import cli

    log = outdir / "cli.jsonl"
    cli.main(["coupled", "--mesh", f"{ny}x{nx}", "--device", "cpu",
              "--width", str(grid.width), "--height", str(grid.height),
              "--steps", "2", "--log", str(log)])
    if rank == 0:
        np.savez(outdir / "out.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6]))
