"""Carrying state and parameters between the reference package and the port.

Fields cross as numpy arrays, so the two packages compute on the same
inputs without importing each other: ``fields_from_numpy`` turns the
reference's fields (``u``, ``v``, ``terrain``, ``p``, ... given as numpy
arrays) into float32 tensors on a device, ``fields_to_numpy`` goes back,
``ocean_config_from_dict`` / ``coupled_config_from_dict`` rebuild a config
from ``dataclasses.asdict`` of the reference's, and
``coupled_state_from_numpy`` / ``coupled_state_to_numpy`` carry a whole
``CoupledState``, and ``coupled_state_blocks_from_numpy`` /
``coupled_state_blocks_to_numpy`` one split over a ``dist.mesh.Mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..model import CoupledConfig, CoupledState
from ..ops.ocean import OceanConfig


def fields_from_numpy(arrays: Mapping[str, np.ndarray], device
                      ) -> dict:
    """name -> contiguous float32 tensor on ``device``."""
    return {k: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for k, a in arrays.items()}


def fields_to_numpy(tensors: Mapping[str, torch.Tensor]) -> dict:
    """name -> float32 numpy array on the host."""
    return {k: t.detach().to("cpu", torch.float32).numpy()
            for k, t in tensors.items()}


def ocean_config_from_dict(d: Mapping) -> OceanConfig:
    """The port's OceanConfig from the reference's, as a dict; unknown
    keys raise, so a field added on one side is not silently dropped."""
    names = {f.name for f in dataclasses.fields(OceanConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"OceanConfig has no field(s) {sorted(unknown)}")
    return OceanConfig(**dict(d))


def coupled_config_from_dict(d: Mapping) -> CoupledConfig:
    """The port's CoupledConfig from the reference's, as a dict (its
    ``ocean`` entry a dict too); unknown keys raise."""
    names = {f.name for f in dataclasses.fields(CoupledConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"CoupledConfig has no field(s) {sorted(unknown)}")
    d = dict(d)
    if "ocean" in d and not isinstance(d["ocean"], OceanConfig):
        d["ocean"] = ocean_config_from_dict(d["ocean"])
    return CoupledConfig(**d)


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


def coupled_state_blocks_to_numpy(state: CoupledState, mesh) -> dict:
    """Full-grid numpy arrays of a sharded CoupledState, on every rank (a
    collective: every rank of the mesh calls it)."""
    from ..dist.mesh import gather_field

    return fields_to_numpy({
        f.name: (gather_field(x, mesh) if x.dim() == 2 else x)
        for f in dataclasses.fields(CoupledState)
        for x in [getattr(state, f.name)]})
