"""Wrappers of the hand-written CUDA kernels (``csrc/*.cu``), each beside
its plain PyTorch twin.  ``build`` compiles the sources at first use; it is
imported only by a wrapper that was handed a CUDA tensor."""

from . import advect, jacobi

__all__ = ["advect", "jacobi"]
