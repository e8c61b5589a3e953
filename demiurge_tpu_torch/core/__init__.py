from .grid import Grid
from . import platform, topology

__all__ = ["Grid", "platform", "topology"]
