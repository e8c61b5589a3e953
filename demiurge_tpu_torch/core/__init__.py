from .grid import Grid
from . import fastroll, platform, stencils, topology

__all__ = ["Grid", "fastroll", "platform", "stencils", "topology"]
