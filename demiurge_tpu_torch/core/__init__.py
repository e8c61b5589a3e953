from .grid import Grid
from .state import State, new_state
from . import fastroll, platform, state, stencils, topology

__all__ = ["Grid", "State", "new_state", "fastroll", "platform", "state",
           "stencils", "topology"]
