"""Diagnostic tools of the flow solvers, the port's counterparts of the
reference's ``tools/flow_rounds.py`` and ``tools/flow_tune.py``:

    python -m demiurge_tpu_torch.tools.flow_rounds [W H [band k]] [--device D]
    python -m demiurge_tpu_torch.tools.flow_tune [W H] [--device D]

Both run on the card (``--device cuda``, the default) unless asked for the
CPU, where the kernels' plain twins run.  Each prints, as its last line,
``{"kernel_launches": {...}}``: the launches of the kernels it drove.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid


def terrain(grid: Grid, device) -> torch.Tensor:
    """The reference tools' terrain: fBm, 6 octaves, scale 2, [-2, 3],
    seed 7."""
    from ..ops.noise import NoiseParams, fbm

    return fbm(grid, NoiseParams(mode="default", octaves=6, scale=2.0,
                                 min=-2.0, max=3.0, seed=7), device)


def flow_inputs(height, grid: Grid):
    """(packed masks, cell area) of a height, as the device flow path makes
    them (pre-blur 0.5, every cell selected)."""
    from ..kernels.flow import pack_masks
    from ..ops import flow
    from ..ops.blur import blur

    hb = blur(height, grid, 0.5)
    code = flow.flow_directions(hb, torch.ones_like(hb), grid)
    _, mouth, _ = flow.incoming_mask(code, grid)
    area = flow.cell_area_lower_edge(grid, height.device)
    return pack_masks(code, mouth, grid), area


def serpentine(grid: Grid, device, x0: int, cols: int, rows: int):
    """(packed masks, cell area) of a hand-built code field with one long
    river: it runs down column x0 over rows 1..rows, steps east, runs up
    the next column, and so on over ``cols`` columns (x periodic, so it
    crosses the dateline where x0 + cols > W), then flows east into one
    ocean cell.  Every other cell is a land sink (code 5).  The river is
    cols * rows cells long and crosses the tile edges of any tiling many
    times."""
    from ..core.topology import DIR_CODE
    from ..kernels.flow import pack_masks
    from ..ops import flow

    H, W = grid.shape
    if not (0 < rows <= H - 3 and 0 < cols < W):
        raise ValueError(f"a {cols}x{rows} river does not fit {W}x{H}")
    code = torch.full(grid.shape, 5, dtype=torch.int32)
    top, bottom = 1, rows
    for j in range(cols):
        c = (x0 + j) % W
        if j % 2 == 0:  # down the column, then east along the bottom row
            code[top:bottom, c] = DIR_CODE[(0, 1)]
            code[bottom, c] = DIR_CODE[(1, 0)]
        else:           # up the column, then east along the top row
            code[top + 1:bottom + 1, c] = DIR_CODE[(0, -1)]
            code[top, c] = DIR_CODE[(1, 0)]
    end = bottom if (cols - 1) % 2 == 0 else top
    code[end, (x0 + cols) % W] = 0  # the ocean cell the river ends in
    code = code.to(device)
    _, mouth, _ = flow.incoming_mask(code, grid)
    return pack_masks(code, mouth, grid), flow.cell_area_lower_edge(grid,
                                                                    device)
