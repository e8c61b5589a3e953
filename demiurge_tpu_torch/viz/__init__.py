"""Map projections and the appearance chain (counterpart of
``demiurge_tpu/viz``): plain torch on the caller's device."""

from . import appearance, projections
from .appearance import render, to_png
from .projections import CanvasParams, PROJECTIONS, project_field

__all__ = [
    "appearance",
    "projections",
    "render",
    "to_png",
    "CanvasParams",
    "PROJECTIONS",
    "project_field",
]
