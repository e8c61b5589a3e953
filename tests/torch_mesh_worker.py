"""One rank of a gloo process group on the CPU, for tests/test_torch_dist.py,
tests/test_torch_dist_local.py and tests/test_torch_dist_fallbacks.py.

    python tests/torch_mesh_worker.py INPUTS.npz OUTDIR NY NX RANK [MODE]

Joins a group of NY*NX processes through the file store OUTDIR/store,
builds the NYxNX mesh, runs every sharded path of the port on the full
fields in INPUTS.npz (each rank takes its block), gathers the results and,
on rank 0, writes them to OUTDIR/out.npz.  MODE ``local`` runs the
block-local stages (``dist.local``), the overlapped halo sweeps and the
traffic counters instead; ``band`` the mesh paths of a grid without
poles (the inputs' ``coords``); ``fallbacks`` the cases that once ran on
the gathered fields, counted (tests/test_torch_dist_fallbacks.py).  It
imports torch, numpy and the port only (never JAX), so the parent test
can hold the results to the reference package.
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


def local_stages(grid, mesh, blk, meta, out):
    """The block-local stages, the overlapped sweeps against the
    monolithic ones, and the traffic of default coupled steps."""
    from demiurge_tpu_torch.dist import local
    from demiurge_tpu_torch.kernels import jacobi as kj
    from demiurge_tpu_torch.kernels.flow import pack_masks
    from demiurge_tpu_torch.model import CoupledConfig, coupled_step, \
        init_coupled
    from demiurge_tpu_torch.ops import erosion, ocean

    def put(name, block):
        out[name] = dm.gather_field(block, mesh).numpy()

    def put_rows(name, rows):
        out[name] = dm.all_gather_rows(rows, mesh).numpy()

    cfg = ocean.OceanConfig()
    u, v, t, p = blk["u"], blk["v"], blk["terrain"], blk["f"]
    dep = local.block_call(ocean._departure, mesh, 0)(u, v, grid, cfg)
    for i, d in enumerate(dep):
        put(f"dep{i}", d.expand(u.shape).contiguous())
    put("div", local.block_call(ocean.divergence, mesh, 1, halo=(0, 1, 2),
                                negate=(0, 1))(u, v, t, grid, cfg))
    pu, pv = local.block_call(ocean.project, mesh, 1, halo=(2, 3))(
        u, v, p, t, grid, cfg)
    put("proj_u", pu)
    put("proj_v", pv)
    for i, c in enumerate(local.block_call(kj.coefficients, mesh, 1,
                                           halo=(1,))(blk["div"], t, grid)):
        put(f"coef{i}", c)
    for i, c in enumerate(local.block_call(kj.diffusion_coefficients, mesh,
                                           1, halo=(0,))(t, grid)):
        put(f"dcoef{i}", c)
    code, mouth, packed = local.flow_masks_rows(blk["rough"], blk["sel"],
                                                grid, mesh, 0.5)
    put_rows("rows_code", code)
    put_rows("rows_mouth", mouth)
    put_rows("rows_packed", packed)
    put("pack_b", local.block_call(pack_masks, mesh, 1, halo=(0,))(
        blk["code"], blk["mouth"].bool(), grid))
    put("erosion", local.block_call(erosion.erosion_pass, mesh, 1,
                                    halo=(0,))(t, blk["fm"], blk["uplift"],
                                               grid, 1.0, 1.0))

    # the overlapped k sweeps against the monolithic ones: pressure (k 8,
    # 3 rounds), viscosity (k 10, quotas 10, 10, 5, velocity halos
    # negated), and a k the blocks are too small to split for (k 20)
    dcoef = local.block_call(kj.diffusion_coefficients, mesh, 1,
                             halo=(0,))(t, grid)
    pcoef = local.block_call(kj.coefficients, mesh, 1, halo=(1,))(
        blk["div"], t, grid)
    for name, k, coeffs, quotas, neg in (
            ("p", 8, pcoef, [8, 8, 8], False),
            ("d", 10, dcoef + (torch.zeros_like(t),), [10, 10, 5], True),
            ("fb", 20, dcoef + (torch.zeros_like(t),), [20], True)):
        padded = halo._padded_coefficients(coeffs, k, grid, mesh) + (
            halo.exchange_halo(coeffs[5], k, grid, mesh),)
        mono, split = u, u
        halo.LAST_OVERLAP.update(rounds=0, split=0, in_flight=0)
        for n_sw in quotas:
            mono = halo._ksweeps(mono, k, padded, lambda q: halo.exchange_halo(
                q, k, grid, mesh, negate_pole=neg), n_sw=n_sw)
            split = halo._overlapped_ksweeps(split, k, padded, lambda q: (
                halo.post_halo(q, k, grid, mesh, negate_pole=neg)),
                n_sw=n_sw, split=True)
        put(f"sweep_{name}_mono", mono)
        put(f"sweep_{name}_split", split)
        ov = halo.LAST_OVERLAP
        put_rows(f"overlap_{name}", torch.tensor(
            [[ov["rounds"], ov["split"], ov["in_flight"]]]))

    # the traffic of two default coupled steps, and of one exact_quirks
    # step
    kinds = list(dm.TRAFFIC)

    def read():
        tr = dm.traffic()
        return torch.tensor([[tr["sharded_call"], tr["field_gathers"]]
                             + [tr["bytes"][k] for k in kinds]])

    state = init_coupled(t, grid, mesh=mesh)
    dm.reset_traffic()
    state = coupled_step(state, grid, CoupledConfig(), mesh=mesh)
    one = read()
    coupled_step(state, grid, CoupledConfig(), mesh=mesh)
    put_rows("traffic_default", torch.cat([one, read()]).reshape(1, -1))
    quirks = CoupledConfig(climate_substeps=2, ocean=ocean.OceanConfig(
        jacobi_iters=16, diffusion_iters=5, exact_quirks=True))
    dm.reset_traffic()
    coupled_step(state, grid, quirks, mesh=mesh)
    put_rows("traffic_quirks", read())
    out["traffic_kinds"] = np.asarray(json.dumps(kinds))


def band_paths(grid, mesh, blk, out):
    """The mesh paths of an x-periodic grid without poles: the halo
    solvers with their coefficients built on the blocks, the flow filter
    (its masks on the row groups, the two-level fixpoint) and the halo
    fixpoint, with the ``sharded_call``s they make (none)."""
    from demiurge_tpu_torch.ops import flow as tf
    from demiurge_tpu_torch.ops import ocean

    def put(name, block):
        out[name] = dm.gather_field(block, mesh).numpy()

    cfg = ocean.OceanConfig(jacobi_iters=24, diffusion_iters=25)
    dm.reset_traffic()
    put("pressure", ocean.pressure_solve(blk["div"], blk["terrain"], grid,
                                         cfg, mesh=mesh))
    du, dv = ocean.diffusion(blk["u"], blk["v"], blk["terrain"], grid, cfg,
                             mesh=mesh)
    put("diff_u", du)
    put("diff_v", dv)
    solvers = dm.traffic()["sharded_call"]
    fm, acc = tf.flow_filter_device(blk["rough"], blk["sel"], grid,
                                    return_acc=True, mesh=mesh)
    put("fm", fm)
    put("acc", acc)
    area = dm.shard_field(tf.cell_area_lower_edge(grid, mesh.device), mesh)
    A, vis = halo.flow_solve_sharded(blk["code"], area, blk["mouth"].bool(),
                                     grid, mesh)
    put("flowh_A", A)
    put("flowh_vis", vis)
    out["calls"] = np.asarray([solvers, dm.traffic()["sharded_call"]])


def fallback_paths(grid, mesh, blk, meta, out):
    """The cases that once ran on the gathered fields, each through its
    entry point with the traffic counters zeroed just before and read
    just after: a climate dispatch deeper than a row group (on a grid of
    even and of uneven row groups, and one that a group of 9 rows would
    run in one chunk and one of 8 in two), the flow masks and the whole flow
    filter on 4-row groups, the ``exact_quirks`` viscosity, a
    warm-started pressure solve, the stages of a grid without poles;
    then the row-halo exchange deeper than a row group."""
    from demiurge_tpu_torch.dist import local
    from demiurge_tpu_torch.kernels import jacobi as kj
    from demiurge_tpu_torch.kernels.flow import pack_masks
    from demiurge_tpu_torch.ops import flow as tf
    from demiurge_tpu_torch.ops import ocean, temperature

    kinds = list(dm.TRAFFIC)
    band = Grid(*meta["shape"], coords=tuple(meta["band"]))
    results, counts = {}, []

    def case(name, fn):
        dm.reset_traffic()
        results[name] = fn()
        tr = dm.traffic()
        counts.append([tr["sharded_call"], tr["field_gathers"]]
                      + [tr["bytes"][k] for k in kinds])

    def climate(prefix, g, substeps):
        return lambda: temperature.temperature_step(
            blk[f"{prefix}_T"], blk[f"{prefix}_terrain"], 3.0, g,
            substeps=substeps, mesh=mesh)[0]

    W = grid.width
    flow_grid = Grid(W, 4 * mesh.size)
    fh, fsel = blk[f"f{mesh.size}_h"], blk[f"f{mesh.size}_sel"]
    quirks = ocean.OceanConfig(diffusion_iters=25, exact_quirks=True)
    warm = ocean.OceanConfig(jacobi_iters=20)
    u, v, t = blk["u"], blk["v"], blk["terrain"]
    case("climate", climate("c", Grid(W, 32), 40))
    case("climate_uneven", climate("e", Grid(W, 34), 40))
    case("climate_odd", climate("e", Grid(W, 34), 9))
    case("flow_masks", lambda: local.flow_masks_rows(fh, fsel, flow_grid,
                                                     mesh, 0.5))
    case("flow_filter", lambda: tf.flow_filter_device(
        fh, fsel, flow_grid, return_acc=True, mesh=mesh))
    case("flow_uneven", lambda: tf.flow_filter_device(
        blk["e_terrain"], torch.ones_like(blk["e_terrain"]), Grid(W, 34),
        return_acc=True, mesh=mesh))
    case("quirks", lambda: ocean.diffusion(u, v, t, grid, quirks,
                                           mesh=mesh))
    case("pressure_p0", lambda: ocean.pressure_solve(
        blk["div"], t, grid, warm, p0=blk["p0"], mesh=mesh))
    case("band_pcoef", lambda: local.block_or_gathered(
        kj.coefficients, band, mesh, 1, halo=(1,))(blk["div"], t, band))
    case("band_dcoef", lambda: local.block_or_gathered(
        kj.diffusion_coefficients, band, mesh, 1, halo=(0,))(t, band))
    case("band_pack", lambda: local.block_or_gathered(
        pack_masks, band, mesh, 1, halo=(0,))(
            blk["band_code"], blk["band_mouth"].bool(), band))
    case("band_masks", lambda: local.flow_masks_rows(
        blk["rough"], blk["sel"], band, mesh, 0.5))
    case("band_climate", climate("b", band, 40))
    case("band_quirks", lambda: ocean.diffusion(u, v, t, band, quirks,
                                                mesh=mesh))

    for name, res in results.items():
        res = res if isinstance(res, tuple) else (res,)
        for i, x in enumerate(res):
            key = f"{name}{i}"
            if name in ("flow_masks", "band_masks"):   # row groups
                out[key] = dm.all_gather_rows(x, mesh).numpy()
            else:
                out[key] = dm.gather_field(x.float(), mesh).numpy()
    out["cases"] = np.asarray(json.dumps(list(results)))
    out["traffic_kinds"] = np.asarray(json.dumps(kinds))
    out["counts"] = dm.all_gather_rows(
        torch.tensor(counts, dtype=torch.float64).reshape(1, -1),
        mesh).numpy()

    # the row-halo exchange 1.5 groups deep
    rows = dm.blocks_to_rows(blk["f"], mesh)
    k = int(np.diff(dm.row_groups(grid.height, mesh)).min()) * 3 // 2
    out["deep_k"] = np.asarray(k)
    out["deep"] = dm.all_gather_rows(rows_strip(rows, k, grid, mesh),
                                     mesh).numpy()


def rows_strip(rows, k, grid, mesh):
    """``exchange_rows_halo``'s strip set into rows [lo - k, hi + k) of
    this rank's group, NaN beyond the grid's first and last row (every
    rank's the same size, for ``all_gather_rows``)."""
    from demiurge_tpu_torch.dist import local

    lo, hi = dm.row_group(grid.height, mesh)
    win = local.rows_window(grid, mesh, k)
    full = torch.full((hi - lo + 2 * k, grid.width), float("nan"))
    at = win.row0 - (lo - k)
    full[at:at + win.height] = halo.exchange_rows_halo(rows, k, mesh, grid)
    return full


def main(inputs, outdir, ny, nx, rank, mode=""):
    torch.set_num_threads(1)
    outdir = pathlib.Path(outdir)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                            rank=rank, world_size=ny * nx)
    mesh = dm.make_mesh(shape=(ny, nx), device="cpu")
    data = dict(np.load(inputs))
    meta = json.loads(str(data.pop("meta")))
    grid = Grid(*meta["shape"], **({"coords": tuple(meta["coords"])}
                                   if "coords" in meta else {}))
    full = {k: torch.from_numpy(v) for k, v in data.items()}
    blk = {k: dm.shard_field(v, mesh) if v.dim() == 2 else v
           for k, v in full.items()}
    out = {}
    if mode in ("local", "band", "fallbacks"):
        {"local": local_stages,
         "band": lambda g, m, b, _, o: band_paths(g, m, b, o),
         "fallbacks": fallback_paths}[mode](grid, mesh, blk, meta, out)
        if rank == 0:
            np.savez(outdir / "out.npz", **out)
        dist.destroy_process_group()
        return

    def put(name, block):
        out[name] = dm.gather_field(block, mesh).numpy()

    # halo exchanges: padded blocks and row groups, gathered as mosaics
    k = meta["k"]
    f = blk["f"]
    put("halo", halo.exchange_halo(f, k, grid, mesh))
    put("halo_neg", halo.exchange_halo(f, k, grid, mesh, negate_pole=True))
    rows = dm.blocks_to_rows(f, mesh)
    out["rows"] = dm.all_gather_rows(rows, mesh).numpy()
    out["rows_strip"] = dm.all_gather_rows(rows_strip(rows, k, grid, mesh),
                                           mesh).numpy()
    put("rows_back", dm.rows_to_blocks(rows, mesh, grid.height))

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
    main(sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6]), *sys.argv[6:])
