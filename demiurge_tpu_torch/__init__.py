"""demiurge_tpu_torch — the PyTorch / CUDA port of demiurge_tpu.

The JAX package (``demiurge_tpu``) is the reference; this package mirrors its
layout and names so that the counterpart of ``demiurge_tpu/<path>`` lives at
``demiurge_tpu_torch/<path>``.  Fields are ``(H, W)`` float32 tensors with
row 0 = southernmost row; every entry point that creates tensors takes an
explicit ``device``.  The TPU's Pallas kernels are replaced by CUDA kernels
written for Hopper (``csrc/*.cu``), each with a plain PyTorch twin beside its
wrapper in ``kernels/``; the twin runs when the tensors lie on the CPU.

Ported so far: the grid and its wrap topology, default-mode fBm noise, and
the ocean step (``ops.ocean``) with its ``ocean`` CLI command.
"""

from .core import Grid

__version__ = "0.1.0"
__all__ = ["Grid", "__version__"]
