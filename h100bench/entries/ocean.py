"""The ``ocean`` configuration through the program's public entry points:
``ops.ocean.init_ocean`` and ``ops.ocean.ocean_step``, as the ocean CLI
runs them (BASELINE config 3)."""

from __future__ import annotations

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.ops import ocean

SPANS = (("demiurge_tpu_torch.ops.ocean", "ocean_step"),)


def ocean_stages(n: int, o: dict):
    """A step's stages on n pixels: (name, bytes, float32 operations), each
    stage's inputs read once and outputs written once, 4 bytes a value;
    the operations counted only where a stage's sweeps dominate it."""
    return [
        ("advect", 20 * n, 0),                       # u, v, h -> u, v
        ("viscosity", 20 * n, 18 * o["diffusion_iters"] * n),  # 2 x 9
        ("divergence", 16 * n, 0),                   # u, v, h -> div
        ("pressure", 12 * n, 10 * o["jacobi_iters"] * n),     # 5 x, 5 +
        ("project", 24 * n, 0),                      # u, v, p, h -> u, v
    ]


def stages(cfg: dict):
    """A step's stages at the configuration's grid."""
    return ocean_stages(cfg["width"] * cfg["height"], cfg["ocean"])


class Entry:
    #: the program's functions the traced run wraps in spans
    spans = SPANS

    def __init__(self, cfg: dict, terrain):
        self.grid = Grid(cfg["width"], cfg["height"])
        self.terrain = terrain
        self.ocfg = ocean.OceanConfig(**cfg["ocean"])

    def start(self):
        u, v = ocean.init_ocean(self.grid, self.terrain.device)
        return u, v, None

    def step(self, state):
        u, v, p, _ = ocean.ocean_step(state[0], state[1], self.terrain,
                                      self.grid, self.ocfg)
        return u, v, p

    @staticmethod
    def fields(state) -> dict:
        return {"u": state[0], "v": state[1], "p": state[2]}
