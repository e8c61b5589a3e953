"""The ``coupled`` configuration through the program's public entry
points: ``model.init_coupled`` and ``model.coupled_step``, as the coupled
CLI runs them (BASELINE config 5)."""

from __future__ import annotations

from demiurge_tpu_torch import model
from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.ops import ocean

from h100bench.entries.ocean import ocean_stages
from h100bench.reference.coupled import sigma_list

SPANS = (("demiurge_tpu_torch.ops.temperature", "temperature_step"),
         ("demiurge_tpu_torch.ops.ocean", "ocean_step"),
         ("demiurge_tpu_torch.ops.flow", "flow_filter_device"))


def coupled_stages(n: int, cfg: dict):
    """A step's stages on n pixels: (name, bytes, float32 operations)."""
    c = cfg["coupled"]
    blur_passes = 2 * len(sigma_list(c["flow_preblur"]))
    return [
        # T, h -> T; 14 operations a substep
        ("climate", 12 * n, 14 * c["climate_substeps"] * n),
        *ocean_stages(n, cfg["ocean"]),
        # h -> blurred h; a pass is the centre and 6 lerped taps
        ("flow_blur", 8 * n, 31 * blur_passes * n),
        ("flow_directions", 12 * n, 0),              # h, sel -> codes
        ("flow_area", 16 * n, 0),                    # masks, area, A0 -> A
        ("flow_vis", 5 * n, 0),                      # masks -> vis (bytes)
        ("flow_map", 9 * n, 0),                      # A, vis -> map
        ("erosion", 16 * n, 0),                      # h, map, uplift -> h
    ]


def stages(cfg: dict):
    """A step's stages at the configuration's grid."""
    return coupled_stages(cfg["width"] * cfg["height"], cfg)


class Entry:
    #: the program's functions the traced run wraps in spans
    spans = SPANS

    def __init__(self, cfg: dict, terrain):
        self.grid = Grid(cfg["width"], cfg["height"])
        self.terrain = terrain
        c = cfg["coupled"]
        self.ccfg = model.CoupledConfig(
            climate_substeps=c["climate_substeps"],
            ocean=ocean.OceanConfig(**cfg["ocean"]),
            flow_exponent=c["flow_exponent"], flow_preblur=c["flow_preblur"],
            erosion_factor=c["erosion_factor"],
            erosion_slope_exponent=c["erosion_slope_exponent"])

    def start(self):
        return model.init_coupled(self.terrain, self.grid)

    def step(self, state):
        return model.coupled_step(state, self.grid, self.ccfg)

    @staticmethod
    def fields(state) -> dict:
        return {"height": state.height, "u": state.u, "v": state.v,
                "temperature": state.temperature, "flow_acc": state.flow_acc}
