"""The coupled model: climate + ocean + erosion on the sphere.

Counterpart of ``demiurge_tpu/model.py`` (BASELINE config 5).  One step
advances

  1. the seasonal climate by ``climate_substeps`` substeps
     (``ops.temperature``, kernel ``kernels.climate``);
  2. the ocean currents by one outer step (``ops.ocean``, kernels
     ``kernels.advect`` and ``kernels.jacobi``);
  3. the landscape by one uplift + stream-power pass on the device flow
     path (``ops.flow.flow_filter_device``, kernels ``kernels.blur``,
     ``kernels.directions`` and ``kernels.flow``, then
     ``ops.erosion.erosion_pass``), the area relaxation warm-started from
     the previous step's fixpoint.

The state is a dataclass of tensors on one device; the step returns a new
state.  With a ``mesh`` (``dist.mesh``) the state holds this rank's
(H/ny, W/nx) blocks and the step runs on every rank of the mesh together.
"""

from __future__ import annotations

import dataclasses

import torch

from .core.grid import Grid
from .core.trace import span
from .ops import erosion, flow, ocean, temperature


@dataclasses.dataclass(frozen=True)
class CoupledConfig:
    climate_substeps: int = 10
    ocean: ocean.OceanConfig = ocean.OceanConfig(jacobi_iters=200,
                                                 diffusion_iters=50)
    flow_exponent: float = 0.5
    flow_preblur: float = 0.5
    erosion_factor: float = 1.0
    erosion_slope_exponent: float = 1.0


@dataclasses.dataclass
class CoupledState:
    height: torch.Tensor       # terrain (km)
    uplift: torch.Tensor       # uplift forcing field
    sel: torch.Tensor          # selection mask (1 everywhere by default)
    u: torch.Tensor            # ocean velocity east
    v: torch.Tensor            # ocean velocity north
    temperature: torch.Tensor  # surface temperature (C)
    t_index: torch.Tensor      # climate substep counter (0-d float32)
    # the previous step's flow-accumulation fixpoint, the warm start of the
    # relaxation (unique fixpoint: same result, fewer sweeps); zeros = cold
    flow_acc: torch.Tensor = None


def init_coupled(height: torch.Tensor, grid: Grid,
                 cfg: CoupledConfig = CoupledConfig(),
                 mesh=None) -> CoupledState:
    """The initial state on ``height``'s device.  Under a ``mesh``,
    ``height`` is this rank's block and so is every field of the state."""
    device = height.device
    uplift, h = erosion.init_uplift(height)
    if mesh is not None:  # the block's own fields, built on the block
        from .dist.local import block_window

        grid = block_window(grid, mesh, 0)
    u, v = ocean.init_ocean(grid, device)
    fields = dict(
        sel=torch.ones(grid.shape, dtype=torch.float32, device=device),
        u=u, v=v, temperature=temperature.init_temperature(grid, device),
        flow_acc=torch.zeros(grid.shape, dtype=torch.float32, device=device))
    return CoupledState(
        height=h, uplift=uplift,
        t_index=torch.zeros((), dtype=torch.float32, device=device),
        **fields)


def coupled_step(state: CoupledState, grid: Grid,
                 cfg: CoupledConfig = CoupledConfig(),
                 mesh=None) -> CoupledState:
    """One coupled step; returns the new state.

    ``mesh``: a ``dist.mesh.Mesh``; the state's fields are then this
    rank's blocks, and every stage runs on this rank's block or row group
    (``dist``: the climate on row groups, the ocean's stages and solvers
    and the erosion pass on blocks with their halos, the flow's masks on
    row groups and its fixpoint by the two-level solve), whatever the
    options and on any x-periodic grid; on a grid that does not wrap in x
    (regional), and with ``advect_method="exact"``, the stages that have
    no local form run on the gathered fields (``dist.mesh.
    sharded_call``).  Spans (``core.trace``): ``coupled_step`` around
    the step, ``erosion`` around the erosion pass."""
    with span("coupled_step"):
        h = state.height
        T, ti = temperature.temperature_step(
            state.temperature, h, state.t_index, grid,
            substeps=cfg.climate_substeps, mesh=mesh)
        u, v, _, _ = ocean.ocean_step(state.u, state.v, h, grid, cfg.ocean,
                                      mesh=mesh)
        fm, acc = flow.flow_filter_device(h, state.sel, grid,
                                          exponent=cfg.flow_exponent,
                                          preblur=cfg.flow_preblur,
                                          acc0=state.flow_acc,
                                          return_acc=True, mesh=mesh)
        erode = erosion.erosion_pass
        if mesh is not None:
            from .dist.local import block_or_gathered

            erode = block_or_gathered(erode, grid, mesh, 1, halo=(0,))
        with span("erosion"):
            h = erode(h, fm, state.uplift, grid, cfg.erosion_factor,
                      cfg.erosion_slope_exponent)
    return CoupledState(height=h, uplift=state.uplift, sel=state.sel, u=u,
                        v=v, temperature=T, t_index=ti, flow_acc=acc)
