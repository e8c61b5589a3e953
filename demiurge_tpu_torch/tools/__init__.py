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
