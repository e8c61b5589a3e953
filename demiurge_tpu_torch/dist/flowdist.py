"""Two-level distributed flow solve: a fixed handful of collectives instead
of one halo exchange per relaxation round.

Counterpart of ``demiurge_tpu/dist/flowdist.py``, on the decomposition of
``kernels.flow2`` (band-local fixpoints + a contracted inter-band drainage
graph):

  1. ``all_to_all_single`` over the mesh row: the (y, x) blocks become
     full-width row groups (rank g = yi*nx + xi gets rows [g*r, (g+1)*r)),
     since in-band paths wrap the dateline (the coupled step builds the
     packed masks on the row groups already, ``dist.local``, and enters
     at step 2: ``flow_solve_rows_twolevel``);
  2. band-local solves on each rank, no communication: A_loc and exit ids
     (K10a), and the local reachability (K10b);
  3. ``all_gather`` of the bands' boundary rows only (2 rows a band); every
     rank solves the same small coarse graph;
  4. each rank's own injections and re-solves (K10a, K10b), no
     communication;
  5. ``all_to_all_single`` back to the blocks.

Results match ``ops.flow.flow_solve_stencil``: A within f32 summation
order (the chain sums reassociate), vis exactly.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..kernels.flow import pack_masks
from ..kernels.flow2 import (_accumulate_adaptive, _or_chain_adaptive,
                             coarse_graph_rows, coarse_rows,
                             flow_local_solve, flow_local_vis, mask_local)
from .mesh import Mesh, all_gather_rows, blocks_to_rows, rows_to_blocks


def _pick_dist_band(rows_loc: int) -> int:
    for b in (128, 64, 32, 16, 8, 4, 2):
        if rows_loc % b == 0:
            return b
    return 0


def flow_sharded_twolevel_supported(grid: Grid, mesh: Mesh) -> bool:
    H, W = grid.shape
    if not grid.wrap_x or H % mesh.size != 0 or W % mesh.nx != 0:
        return False
    return _pick_dist_band(H // mesh.size) > 0


def flow_solve_sharded_twolevel(code, area2d, mouth, grid: Grid, mesh: Mesh,
                                band: int = 0):
    """Distributed (A, vis) flow solve by the two-level scheme, on this
    rank's blocks of the codes and mouths: the packed masks built on the
    blocks (a 1-ring halo of the codes, ``dist.local``; on the gathered
    fields on a grid that is not x-periodic, which the solve refuses),
    regrouped into rows, then ``flow_solve_rows_twolevel``.  Same fixpoint as
    ``ops.flow.flow_solve_stencil``.  Returns (A, vis bool) blocks."""
    from .local import block_or_gathered

    packed_b = block_or_gathered(pack_masks, grid, mesh, 1, halo=(0,))(
        code, mouth, grid)
    A, vis = flow_solve_rows_twolevel(blocks_to_rows(packed_b, mesh),
                                      blocks_to_rows(area2d, mesh), grid,
                                      mesh, band)
    return (rows_to_blocks(A, mesh, grid.height),
            rows_to_blocks(vis, mesh, grid.height) > 0.5)


def flow_solve_rows_twolevel(packed_r, ar_r, grid: Grid, mesh: Mesh,
                             band: int = 0):
    """Steps 2-4 of the two-level solve on this rank's row group: the
    packed masks and the cell areas (r, W) in the row-group layout (rank
    g's rows [g*r, (g+1)*r)).  Returns (A, vis float) in that layout."""
    H, W = grid.shape
    rows_loc = H // mesh.size
    band = band or _pick_dist_band(rows_loc)
    if not (band and rows_loc % band == 0 and grid.wrap_x):
        raise ValueError(f"two-level sharded solve: grid {grid.shape}, mesh "
                         f"{mesh.shape}, band {band}")

    # 1. the band edges are those of the grid (each rank's rows start at a
    #    multiple of the band)
    pl_r = mask_local(packed_r, band)

    # 2. local band solves
    A_loc, E = flow_local_solve(pl_r, ar_r, ar_r, band, with_exit=True)
    vis_loc = flow_local_vis(pl_r, torch.zeros_like(ar_r), band)

    # 3. boundary rows -> the replicated coarse graph
    def gather_coarse(x):
        return all_gather_rows(coarse_rows(x, band), mesh)

    pc, Ac, Ec, Vc = (gather_coarse(x) for x in (pl_r, A_loc, E, vis_loc))
    succ, m0, tflat_c, tflat_g, srcflat_g, cross = \
        coarse_graph_rows(pc, Ac, Ec, band)
    X = _accumulate_adaptive(succ, m0)
    n0 = torch.where(cross, Vc.reshape(-1)[tflat_c], 0.0)
    visX = _or_chain_adaptive(succ, n0)

    # 4. own-rows injections and re-solves; the drop bucket is index n_loc
    lo = mesh.rank * rows_loc * W
    n_loc = rows_loc * W
    own_t = cross & (tflat_g >= lo) & (tflat_g < lo + n_loc)
    inj = torch.zeros(n_loc + 1, dtype=torch.float32, device=X.device)
    inj = inj.index_add_(0, torch.where(own_t, tflat_g - lo, n_loc),
                         torch.where(own_t, X, 0.0))[:n_loc]
    own_s = cross & (srcflat_g >= lo) & (srcflat_g < lo + n_loc)
    seed = torch.zeros(n_loc + 1, dtype=torch.float32, device=X.device)
    seed = seed.scatter_reduce_(0, torch.where(own_s, srcflat_g - lo, n_loc),
                                torch.where(own_s, visX, 0.0),
                                reduce="amax")[:n_loc]
    inj, seed = inj.reshape(rows_loc, W), seed.reshape(rows_loc, W)

    A, _ = flow_local_solve(pl_r, ar_r + inj, A_loc + inj, band,
                            with_exit=False)
    # the reference re-solves vis through its XLA twin even on a TPU; the
    # seeded K10b kernel has the same fixpoint
    vis = flow_local_vis(pl_r, seed, band)
    return A, vis
