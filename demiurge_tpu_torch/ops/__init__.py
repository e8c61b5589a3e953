from . import blur, erosion, flow, noise, ocean, tectonics, temperature

__all__ = ["blur", "erosion", "flow", "noise", "ocean", "tectonics",
           "temperature"]
