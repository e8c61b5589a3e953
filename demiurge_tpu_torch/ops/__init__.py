from . import blur, erosion, flow, noise, ocean, temperature

__all__ = ["blur", "erosion", "flow", "noise", "ocean", "temperature"]
