"""The simulation state: named (H, W) float32 fields.

Counterpart of ``demiurge_tpu/core/state.py``.  The reference keeps its
prognostic fields as named GL textures (Project::add_texture,
src/Project.cpp:294-317); here they are tensors carried state-in,
state-out.  Only ``height`` is mandatory (terrain height in km; > 0 land,
<= 0 ocean); every other field is made by the op that needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .grid import Grid


@dataclasses.dataclass
class State:
    """Prognostic fields on the lat-lon grid, all (H, W) float32.

    height      — terrain height (km); > 0 land, <= 0 ocean
    sel         — selection mask in [0, 1] (the reference's 'sel' texture)
    u, v        — ocean velocity tangent components (east, north)
    pressure    — ocean pressure (kept for warm starts)
    temperature — surface temperature (deg C)
    flow        — the last flow/discharge map (FlowFilter output)
    """

    height: torch.Tensor
    sel: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    pressure: Optional[torch.Tensor] = None
    temperature: Optional[torch.Tensor] = None
    flow: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def shape(self):
        return tuple(self.height.shape)

    def sel_or_ones(self) -> torch.Tensor:
        if self.sel is None:
            return torch.ones_like(self.height)
        return self.sel


def new_state(grid: Grid, device, dtype: torch.dtype = torch.float32
              ) -> State:
    """A fresh project state on ``device``: terrain 0, selection 1
    (Project::file_new, src/Project.cpp:95-104)."""
    return State(height=torch.zeros(grid.shape, dtype=dtype, device=device),
                 sel=torch.ones(grid.shape, dtype=dtype, device=device))
