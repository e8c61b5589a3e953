"""Carrying state and parameters between the reference package and the port.

Fields cross as numpy arrays, so the two packages compute on the same
inputs without importing each other: ``fields_from_numpy`` turns the
reference's fields (``u``, ``v``, ``terrain``, ``p``, ... given as numpy
arrays) into float32 tensors on a device, ``fields_to_numpy`` goes back,
and ``ocean_config_from_dict`` rebuilds an ``OceanConfig`` from
``dataclasses.asdict`` of the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

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
