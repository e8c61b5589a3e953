"""The single place that decides between a CUDA kernel and its plain twin.

Counterpart of ``demiurge_tpu/core/platform.py``.  The device is the
caller's choice, made when it creates its tensors: this module never asks
whether a card exists and never moves data.  Tensors on a CUDA device go to
the hand-written kernels; tensors on the CPU go to the kernels' plain
PyTorch twins.  A grep test (tests/test_torch_platform.py) keeps every other
module from testing the device itself.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def use_cuda_kernels(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on a CUDA device."""
    return bool(tensors) and all(t.is_cuda for t in tensors)


def collective_backend(device) -> str:
    """The torch.distributed backend for tensors on ``device``: NCCL for a
    CUDA device, gloo for the CPU.  Picked by the device the caller names,
    never by what the machine has."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def claim_rank_device(device, local_rank: int) -> torch.device:
    """The device of one process of a group: a CUDA device without an
    index becomes the process's own card, ``cuda:<local_rank>``, and the
    current CUDA device (NCCL needs it set)."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    return device


def host_to_device(array: np.ndarray, device) -> torch.Tensor:
    """A small host table as a tensor on ``device``.  To a CUDA device the
    copy goes through pinned memory and does not wait for the stream (a
    copy from pageable memory would synchronise it)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def check_kernel_inputs(names: Sequence[str], tensors: Sequence[torch.Tensor],
                        shape: Optional[tuple] = None,
                        dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    (and of ``shape`` where given), all on one device — what a kernel
    wrapper demands before it hands raw pointers to a launch."""
    device = None
    for name, t in zip(names, tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t)}")
        if not t.is_cuda:
            raise ValueError(f"{name}: kernel needs a CUDA tensor, got "
                             f"device {t.device}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: on {t.device}, others on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
