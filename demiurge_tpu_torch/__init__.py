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
(``model.coupled_step``), the map projections and the appearance chain
(``viz``), the editor session (``api.Project`` with ``render``, undo
through the snapshot codec in ``native``), the checkpoints
(``utils.checkpoint``: single-file and sharded, in the reference's
format), the ``erosion``, ``tectonic-erosion``, ``ocean``, ``climate`` and
``coupled`` CLI commands with --png, --checkpoint and --resume, both
examples (``examples``), and the distribution (``dist``): every stage of
the default coupled step on this rank's block or row group
(``dist.local``), the halo exchanges overlapped with the sweeps, and the
weak-scaling tool (``tools.scaling_bench``).
"""

from .core import Grid

__version__ = "0.1.0"
__all__ = ["Grid", "__version__"]
