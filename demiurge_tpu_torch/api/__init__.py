"""The port's entry points: the editor session (``Project``) and the
command line (``python -m demiurge_tpu_torch.api.cli``)."""

from .project import Layer, Project, ReversibleHistory, SnapshotHistory

__all__ = ["Layer", "Project", "ReversibleHistory", "SnapshotHistory"]
