"""Two-level distributed flow solve: a fixed handful of collectives instead
of one halo exchange per relaxation round.

Counterpart of ``demiurge_tpu/dist/flowdist.py``, on the decomposition of
``kernels.flow2`` (band-local fixpoints + a contracted inter-band drainage
graph):

  1. ``all_to_all_single`` over the mesh row: the (y, x) blocks become
     full-width row groups (rank g = yi*nx + xi gets rows [g*r, (g+1)*r)),
     since in-band paths wrap the dateline;
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
from .mesh import (Mesh, all_gather_rows, blocks_to_rows, rows_to_blocks,
                   sharded_call)


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
    rank's blocks.  Same fixpoint as ``ops.flow.flow_solve_stencil``.
    Returns (A, vis bool) blocks."""
    H, W = grid.shape
    rows_loc = H // mesh.size
    band = band or _pick_dist_band(rows_loc)
    if not (band and rows_loc % band == 0 and grid.wrap_x):
        raise ValueError(f"two-level sharded solve: grid {grid.shape}, mesh "
                         f"{mesh.shape}, band {band}")

    packed_b = sharded_call(pack_masks, mesh)(code, mouth, grid)

    # 1. blocks -> full-width row groups; the band edges are those of the
    #    grid (each rank's rows start at a multiple of the band)
    pl_r = mask_local(blocks_to_rows(packed_b, mesh), band)
    ar_r = blocks_to_rows(area2d, mesh)

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

    # 5. back to the blocks
    return rows_to_blocks(A, mesh), rows_to_blocks(vis, mesh) > 0.5
