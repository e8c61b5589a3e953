"""Wrappers of the hand-written CUDA kernels (``csrc/*.cu``), each beside
its plain PyTorch twin.  ``build`` compiles the sources at first use; it is
imported only by a wrapper that was handed a CUDA tensor."""

from . import (advect, blur, climate, directions, flow, flow2,
               flow_deadends, jacobi, jacobi_packed, lakeflow, project)

__all__ = ["advect", "blur", "climate", "directions", "flow", "flow2",
           "flow_deadends", "jacobi", "jacobi_packed", "lakeflow", "project",
           "launch_counts"]


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
            "flow_local_vis": flow2.LAUNCHES_LOCAL_VIS,
            "advect_sample_pallas": advect.LAUNCHES_ONE_ROW,
            "flow_solve_2d": flow_deadends.LAUNCHES_2D,
            "flow_solve_2d_tma": flow_deadends.LAUNCHES_2D_TMA,
            "flow_solve_fused": flow_deadends.LAUNCHES_FUSED,
            "flow_solve_fused_bands": flow_deadends.LAUNCHES_FUSED_BANDS,
            "flow_solve_wave": flow_deadends.LAUNCHES_WAVE,
            "flow_solve_wave_tiles": flow_deadends.LAUNCHES_WAVE_TILES,
            "flow_banded_rounds": flow_deadends.LAUNCHES_BANDED,
            "flow_banded_sweeps": flow_deadends.LAUNCHES_BANDED_SWEEPS,
            "jacobi_packed": jacobi_packed.LAUNCHES,
            "jacobi_packed_sweeps": jacobi_packed.LAUNCHES_SWEEPS,
            "advect_stage": advect.LAUNCHES_STAGE,
            "advect_stage_one_row": advect.LAUNCHES_STAGE_ONE_ROW,
            "flow_directions_packed": directions.LAUNCHES_PACKED,
            "blur_strip": blur.LAUNCHES_STRIP,
            "flow_directions_strip": directions.LAUNCHES_STRIP,
            "lake_relax": lakeflow.LAUNCHES,
            "lake_area_tiles": lakeflow.LAUNCHES_AREA_TILES,
            "lake_vis_tiles": lakeflow.LAUNCHES_VIS_TILES,
            "lake_root_tiles": lakeflow.LAUNCHES_ROOT_TILES,
            "ocean_project": project.LAUNCHES}
