"""Carrying state and parameters between the reference package and the port.

Fields cross as numpy arrays, so the two packages compute on the same
inputs without importing each other: ``fields_from_numpy`` turns the
reference's fields (``u``, ``v``, ``terrain``, ``p``, ... given as numpy
arrays) into float32 tensors on a device, ``fields_to_numpy`` goes back,
``ocean_config_from_dict`` / ``coupled_config_from_dict`` rebuild a config
from ``dataclasses.asdict`` of the reference's, and
``coupled_state_from_numpy`` / ``coupled_state_to_numpy`` carry a whole
``CoupledState``, and ``coupled_state_blocks_from_numpy`` /
``coupled_state_blocks_to_numpy`` one split over a ``dist.mesh.Mesh``;
``packed_jacobi_from_reference`` cuts the packed Jacobi's padded tables
down to the port's unpadded ones; ``flow_config_from_dict`` /
``erosion_config_from_dict`` rebuild the flow filter's and the erosion
loop's configs, and ``lake_solution_from_numpy`` the host lake solver's
result; ``plates_from_numpy`` / ``plates_to_numpy`` and
``plate_stack_from_numpy`` / ``plate_stack_to_numpy`` carry the
tectonics' plates (fields in the reference's (..., H, W, 4) layout, the
port's (..., 4, H, W)), and ``tectonics_config_from_dict`` its config.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..model import CoupledConfig, CoupledState
from ..ops.erosion import ErosionConfig
from ..ops.flow import FlowConfig, LakeSolution
from ..ops.ocean import OceanConfig
from ..ops.tectonics import Plate, PlateStack, TectonicsConfig


def fields_from_numpy(arrays: Mapping[str, np.ndarray], device
                      ) -> dict:
    """name -> contiguous float32 tensor on ``device``."""
    return {k: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for k, a in arrays.items()}


def fields_to_numpy(tensors: Mapping[str, torch.Tensor]) -> dict:
    """name -> float32 numpy array on the host."""
    return {k: t.detach().to("cpu", torch.float32).numpy()
            for k, t in tensors.items()}


def _config_from_dict(cls, d: Mapping):
    """``cls(**d)``; unknown keys raise, so a field added on one side is
    not silently dropped."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) "
                         f"{sorted(unknown)}")
    return cls(**dict(d))


def ocean_config_from_dict(d: Mapping) -> OceanConfig:
    """The port's OceanConfig from the reference's, as a dict."""
    return _config_from_dict(OceanConfig, d)


def flow_config_from_dict(d: Mapping) -> FlowConfig:
    """The port's FlowConfig from the reference's, as a dict."""
    return _config_from_dict(FlowConfig, d)


def erosion_config_from_dict(d: Mapping) -> ErosionConfig:
    """The port's ErosionConfig from the reference's, as a dict."""
    return _config_from_dict(ErosionConfig, d)


def lake_solution_from_numpy(sol) -> LakeSolution:
    """The port's LakeSolution from the reference's (any object with its
    four arrays as attributes): connections int64, heights float32; the
    three connection arrays must have one length."""
    out = LakeSolution(
        conn_from=np.array(sol.conn_from, dtype=np.int64).reshape(-1),
        conn_to=np.array(sol.conn_to, dtype=np.int64).reshape(-1),
        conn_h=np.array(sol.conn_h, dtype=np.float32).reshape(-1),
        lake_wh=np.array(sol.lake_wh, dtype=np.float32).reshape(-1))
    if not out.conn_from.size == out.conn_to.size == out.conn_h.size:
        raise ValueError(f"connection arrays of {out.conn_from.size}, "
                         f"{out.conn_to.size} and {out.conn_h.size} entries")
    return out


def coupled_config_from_dict(d: Mapping) -> CoupledConfig:
    """The port's CoupledConfig from the reference's, as a dict (its
    ``ocean`` entry a dict too); unknown keys raise."""
    d = dict(d)
    if "ocean" in d and not isinstance(d["ocean"], OceanConfig):
        d["ocean"] = ocean_config_from_dict(d["ocean"])
    return _config_from_dict(CoupledConfig, d)


def coupled_state_from_numpy(arrays: Mapping[str, np.ndarray], device
                             ) -> CoupledState:
    """A CoupledState on ``device`` from one numpy array per field (the
    0-d ``t_index`` included); a missing or unknown field raises."""
    names = [f.name for f in dataclasses.fields(CoupledState)]
    if set(arrays) != set(names):
        raise ValueError(f"CoupledState fields {sorted(names)}, got "
                         f"{sorted(arrays)}")
    return CoupledState(**fields_from_numpy(arrays, device))


def coupled_state_to_numpy(state: CoupledState) -> dict:
    """field name -> float32 numpy array, for every CoupledState field."""
    return fields_to_numpy({f.name: getattr(state, f.name)
                            for f in dataclasses.fields(CoupledState)})


def coupled_state_blocks_from_numpy(arrays: Mapping[str, np.ndarray], mesh,
                                    device) -> CoupledState:
    """This rank's block of a CoupledState given as full-grid numpy arrays
    (as ``coupled_state_from_numpy``; the 0-d ``t_index`` is replicated)."""
    from ..dist.mesh import shard_field

    state = coupled_state_from_numpy(arrays, "cpu")
    return CoupledState(**{
        f.name: (shard_field(x, mesh) if x.dim() == 2 else x).to(device)
        for f in dataclasses.fields(CoupledState)
        for x in [getattr(state, f.name)]})


def packed_jacobi_from_reference(ob_padded: np.ndarray,
                                 rowtab_padded: np.ndarray, k: int):
    """The port's (H, W) obstacle bits and (H, 3) row table from the
    reference's padded ones (``attic/jacobi_packed.py`` ``_pack_ob``, (R, W)
    int32, and ``_row_table``, (R, 8) float32, R = H + 2k): the interior
    rows, and the table's (cx, cy, c0) columns."""
    ob = np.array(np.asarray(ob_padded)[k:-k], dtype=np.int32)
    tab = np.array(np.asarray(rowtab_padded)[k:-k, :3], dtype=np.float32)
    return ob, tab


def coupled_state_blocks_to_numpy(state: CoupledState, mesh) -> dict:
    """Full-grid numpy arrays of a sharded CoupledState, on every rank (a
    collective: every rank of the mesh calls it)."""
    from ..dist.mesh import gather_field

    return fields_to_numpy({
        f.name: (gather_field(x, mesh) if x.dim() == 2 else x)
        for f in dataclasses.fields(CoupledState)
        for x in [getattr(state, f.name)]})


def tectonics_config_from_dict(d: Mapping) -> TectonicsConfig:
    """The port's TectonicsConfig from the reference's, as a dict."""
    return _config_from_dict(TectonicsConfig, d)


def _channels_first(fields) -> np.ndarray:
    """(..., H, W, 4) -> (..., 4, H, W) float32."""
    return np.ascontiguousarray(np.moveaxis(
        np.asarray(fields, dtype=np.float32), -1, -3))


def _channels_last(fields: torch.Tensor) -> np.ndarray:
    """(..., 4, H, W) tensor -> (..., H, W, 4) float32 numpy."""
    return np.ascontiguousarray(np.moveaxis(
        fields.detach().to("cpu", torch.float32).numpy(), -3, -1))


def plates_from_numpy(fields, rotations, angvels, device) -> list:
    """The port's ``Plate`` list from the reference's plates, given as one
    (H, W, 4) field, (3, 3) rotation and (3,) angular velocity each."""
    return [Plate(torch.from_numpy(_channels_first(f)).to(device),
                  np.array(r, dtype=np.float32),
                  np.array(w, dtype=np.float32))
            for f, r, w in zip(fields, rotations, angvels, strict=True)]


def plates_to_numpy(plates) -> tuple:
    """(fields (P, H, W, 4), rotations (P, 3, 3), angular velocities
    (P, 3)), float32, in the reference's layout."""
    return (np.stack([_channels_last(p.field) for p in plates]),
            np.stack([np.asarray(p.rotation, np.float32) for p in plates]),
            np.stack([np.asarray(p.angular_velocity, np.float32)
                      for p in plates]))


def plate_stack_from_numpy(fields, rotations, angvel, device) -> PlateStack:
    """The port's PlateStack on ``device`` from the reference's arrays:
    fields (P, H, W, 4), rotations (P, 3, 3), angvel (P, 3)."""
    return PlateStack(
        fields=torch.from_numpy(_channels_first(fields)).to(device),
        rotations=torch.from_numpy(
            np.array(rotations, dtype=np.float32)).to(device),
        angvel=torch.from_numpy(np.array(angvel, dtype=np.float32)).to(device))


def plate_stack_to_numpy(stack: PlateStack) -> tuple:
    """(fields (P, H, W, 4), rotations (P, 3, 3), angvel (P, 3)), float32,
    in the reference's layout."""
    return (_channels_last(stack.fields),
            stack.rotations.detach().to("cpu", torch.float32).numpy(),
            stack.angvel.detach().to("cpu", torch.float32).numpy())
