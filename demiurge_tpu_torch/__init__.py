"""demiurge_tpu_torch — the PyTorch / CUDA port of demiurge_tpu.

The JAX package (``demiurge_tpu``) is the reference; this package mirrors its
layout and names so that the counterpart of ``demiurge_tpu/<path>`` lives at
``demiurge_tpu_torch/<path>``.  Fields are ``(H, W)`` float32 tensors with
row 0 = southernmost row; every entry point that creates tensors takes an
explicit ``device``.  The TPU's Pallas kernels are replaced by CUDA kernels
written for Hopper (``csrc/*.cu``), each with a plain PyTorch twin beside its
wrapper in ``kernels/``; the twin runs when the tensors lie on the CPU.

Ported so far: the whole of ``core`` (the grid with its vector helpers,
the wrap topology and the gather samplers, the stencils, the state),
every op of ``ops`` (all seven fBm modes, the ocean with the Jacobi or
the CG pressure, the climate, the blur, the flow filter with lakes and
its host lake solver in ``native``, the plate tectonics, the erosion
loops, thermal erosion, morphology, adjust, blend, the brush and
DeTerrace), the selection tools (``select``), the coupled step
(``model.coupled_step``), the editor session (``api.Project``, all but
``render``, with undo through the snapshot codec in ``native``) and the
``erosion``, ``tectonic-erosion``, ``ocean``, ``climate`` and ``coupled``
CLI commands.  Not yet: ``viz`` (map projections and appearance, so
``Project.render``) and ``utils/checkpoint.py``.
"""

from .core import Grid

__version__ = "0.1.0"
__all__ = ["Grid", "__version__"]
