from . import interop, metrics

__all__ = ["interop", "metrics"]
