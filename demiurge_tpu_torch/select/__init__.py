"""The selection subsystem (counterpart of ``demiurge_tpu/select``)."""

from . import selection

__all__ = ["selection"]
