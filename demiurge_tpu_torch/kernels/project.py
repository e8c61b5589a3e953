"""The ocean's projection stage in one launch.

No Pallas kernel stands behind this one: the JAX package leaves
``project`` (``demiurge_tpu/ops/ocean.py:596``) to XLA's fusion.
``project_stage_cuda`` is the whole single-card ``ops.ocean.project``
(the pressure gradient, the coastal free-slip redirect, the land mask) as
one launch of ``csrc/project.cu``, bit for bit with that function on the
card; ``ops.ocean.project`` itself is the twin, and runs on CPU tensors
and on grids that are not x-periodic (``project_stage``).  ``LAUNCHES``
counts kernel launches; the twin does not count.
"""

from __future__ import annotations

import torch

from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import _pole_col_shift

LAUNCHES = 0

# csrc/project.cu's block, one thread a pixel: rows x columns (PERF.md has
# the shapes raced); its entry point refuses a width that is no multiple
# of 32 and more than 1024 threads
TILE = (2, 64)


def project_stage_cuda(u, v, p, terrain, grid, cfg, tile=TILE):
    """The projection on the card: one launch on the current stream, no
    synchronisation; ``tile`` the block's (rows, columns) of pixels."""
    global LAUNCHES
    from ..ops import ocean

    check_kernel_inputs(("u", "v", "p", "terrain"), (u, v, p, terrain),
                        shape=grid.shape)
    if not grid.wrap_x:
        raise NotImplementedError("the projection kernel needs an "
                                  "x-periodic grid")
    H, W = grid.shape
    tables = ocean.project_tables(grid, u.device)
    scalars = ocean.project_scalars(cfg)
    from . import build

    fu, fv = torch.empty_like(u), torch.empty_like(v)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = build.library().demiurge_project_stage(
        u.data_ptr(), v.data_ptr(), p.data_ptr(), terrain.data_ptr(),
        tables.data_ptr(), scalars.ctypes.data, scalars.size, fu.data_ptr(),
        fv.data_ptr(), H, W, int(grid.wrap_south), int(grid.wrap_north),
        _pole_col_shift(grid), *tile, stream)
    build.check(err, "demiurge_project_stage")
    LAUNCHES += 1
    return fu, fv


def project_stage(u, v, p, terrain, grid, cfg):
    """The kernel for CUDA tensors on an x-periodic grid, else the twin
    ``ops.ocean.project``."""
    if use_cuda_kernels(u, v, p, terrain, grid=grid):
        return project_stage_cuda(u, v, p, terrain, grid, cfg)
    from ..ops.ocean import project

    return project(u, v, p, terrain, grid, cfg)
