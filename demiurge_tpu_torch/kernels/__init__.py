"""Wrappers of the hand-written CUDA kernels (``csrc/*.cu``), each beside
its plain PyTorch twin.  ``build`` compiles the sources at first use; it is
imported only by a wrapper that was handed a CUDA tensor."""

from . import advect, blur, climate, directions, flow, flow2, jacobi

__all__ = ["advect", "blur", "climate", "directions", "flow", "flow2",
           "jacobi", "launch_counts"]


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel name."""
    return {"jacobi_pressure": jacobi.PRESSURE_LAUNCHES,
            "jacobi_diffusion": jacobi.DIFFUSION_LAUNCHES,
            "advect_sample_tiered": advect.LAUNCHES,
            "climate": climate.LAUNCHES,
            "blur": blur.LAUNCHES,
            "flow_directions": directions.LAUNCHES,
            "flow_solve": flow.LAUNCHES_A,
            "flow_vis": flow.LAUNCHES_VIS,
            "flow_local_solve": flow2.LAUNCHES_LOCAL,
            "flow_local_vis": flow2.LAUNCHES_LOCAL_VIS}
