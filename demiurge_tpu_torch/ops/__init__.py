from . import noise, ocean

__all__ = ["noise", "ocean"]
