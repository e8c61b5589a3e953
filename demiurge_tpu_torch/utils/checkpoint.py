"""Checkpoint and resume for long simulations.

Counterpart of ``demiurge_tpu/utils/checkpoint.py``, in its file format:
the same magic, keys and ``np.savez_compressed`` payloads, so that a
checkpoint written by either package loads in the other.

- ``save``/``load``: one ``.npz`` holding every tensor leaf of a state
  dataclass (``None`` leaves are skipped and take their default on load),
  the step and the grid; written to a temp file and ``os.replace``d, so a
  kill mid-write never corrupts the resume point.  ``load`` puts the
  tensors on the device it is given.
- ``save_sharded``/``load_sharded``: a checkpoint DIRECTORY with one
  ``shard_{rank:05d}.npz`` per process of a ``dist.mesh.Mesh``, each
  holding only that rank's (H/ny, W/nx) block of every field, with the
  block's global row and column ranges beside it, plus a ``manifest.npz``
  written last by rank 0 (its presence marks the checkpoint complete).
  A resume on a mesh of the saved shape reads each rank's own file; any
  other reader (no mesh, or a mesh of another shape: the elastic resume)
  assembles the global fields from every file, then takes its blocks.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.platform import host_to_device

_MAGIC = "demiurge_tpu-ckpt-v1"


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A loaded array on ``device``, 0-d arrays kept 0-d."""
    return host_to_device(a, device).reshape(a.shape)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write_atomic(path: str, payload: dict) -> None:
    """``np.savez_compressed`` to a temp file beside ``path``, then
    ``os.replace``; on any failure the temp file goes and ``path`` is
    untouched."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _grid_meta(grid) -> dict:
    if grid is None:
        return {}
    return {"__coords__": np.asarray(grid.coords, np.float64),
            "__circumference__": np.float64(grid.circumference)}


def save(path: str, state, step: int, grid=None) -> None:
    """Atomically write ``state`` (a dataclass of tensors) at ``step``."""
    saved = [f.name for f in dataclasses.fields(state)
             if getattr(state, f.name) is not None]
    payload = {"__magic__": np.array(_MAGIC),
               "__step__": np.int64(step),
               "__fields__": np.array(saved)}
    for name in saved:   # None leaves (optional fields) default on load
        payload["f_" + name] = _host(getattr(state, name))
    payload.update(_grid_meta(grid))
    _write_atomic(path, payload)


def _check_magic(z, path):
    if str(z["__magic__"]) != _MAGIC:
        raise ValueError(f"{path}: not a demiurge_tpu checkpoint")


def load(path: str, state_cls, device="cuda") -> Tuple[object, int]:
    """Load a checkpoint into ``state_cls`` with its tensors on ``device``;
    returns (state, step)."""
    with np.load(path, allow_pickle=False) as z:
        _check_magic(z, path)
        step = int(z["__step__"])
        kw = {name: _to_device(z["f_" + name], device)
              for name in [str(s) for s in z["__fields__"]]}
    return state_cls(**kw), step


def latest(path: str) -> Optional[str]:
    """Return ``path`` if a complete checkpoint exists there, else None.

    Accepts both single-file and sharded-directory checkpoints."""
    if os.path.isdir(path):
        return path if os.path.exists(os.path.join(path, "manifest.npz")) \
            else None
    return path if os.path.exists(path) else None


# ---------------------------------------------------------------------------
# sharded (per-process) checkpoints
# ---------------------------------------------------------------------------


def _block_range(shape, mesh) -> np.ndarray:
    """Global [start, stop) of this rank's block along each axis."""
    if mesh is None:
        return np.asarray([(0, n) for n in shape], np.int64)
    h, w = shape
    return np.asarray([(mesh.yi * h, (mesh.yi + 1) * h),
                       (mesh.xi * w, (mesh.xi + 1) * w)], np.int64)


def _global_shape(shape, mesh) -> Tuple[int, ...]:
    if mesh is None:
        return tuple(shape)
    return (shape[0] * mesh.ny, shape[1] * mesh.nx)


def _is_block(ndim: int, mesh) -> bool:
    """Whether a leaf is stored as this rank's block: every 2-D field
    under a mesh, every leaf with an axis without one (the whole array,
    one block at the origin).  0-d leaves are stored plainly."""
    return ndim == 2 if mesh is not None else ndim > 0


def _barrier(mesh) -> None:
    import torch.distributed as dist

    if mesh is not None and mesh.size > 1:
        dist.barrier()


def save_sharded(dir_path: str, state, step: int, grid=None,
                 mesh=None) -> None:
    """Write this rank's blocks of ``state`` to its own file; no gather.
    Every rank of ``mesh`` calls this (without a mesh, one process writes
    the whole arrays as one shard).  Rank 0 writes the manifest last."""
    rank = mesh.rank if mesh is not None else 0
    os.makedirs(dir_path, exist_ok=True)

    payload, meta_fields, shapes, dtypes = {}, [], {}, {}
    for f in dataclasses.fields(state):
        arr = getattr(state, f.name)
        if arr is None:   # optional field: defaults on load
            continue
        meta_fields.append(f.name)
        host = _host(arr)
        dtypes[f.name] = str(host.dtype)
        if _is_block(host.ndim, mesh):
            payload[f"f_{f.name}__0"] = host
            payload[f"i_{f.name}__0"] = _block_range(host.shape, mesh)
            shapes[f.name] = _global_shape(host.shape, mesh)
        else:  # scalar / replicated leaf: store plainly
            payload[f"s_{f.name}"] = host
            shapes[f.name] = host.shape
    _write_atomic(os.path.join(dir_path, f"shard_{rank:05d}.npz"), payload)

    _barrier(mesh)   # every shard file before the manifest
    if rank == 0:
        manifest = {"__magic__": np.array(_MAGIC),
                    "__step__": np.int64(step),
                    "__nproc__": np.int64(mesh.size if mesh else 1),
                    "__fields__": np.array(meta_fields)}
        for name in meta_fields:
            manifest[f"shape_{name}"] = np.asarray(shapes[name], np.int64)
            manifest[f"dtype_{name}"] = np.array(dtypes[name])
        manifest.update(_grid_meta(grid))
        _write_atomic(os.path.join(dir_path, "manifest.npz"), manifest)
    # no rank returns before the manifest is durable: a rank that re-opens
    # the checkpoint at once (resume after save) must not race rank 0
    _barrier(mesh)


def _read_manifest(dir_path: str):
    with np.load(os.path.join(dir_path, "manifest.npz"),
                 allow_pickle=False) as m:
        _check_magic(m, dir_path)
        fields = [str(s) for s in m["__fields__"]]
        return (int(m["__step__"]), int(m["__nproc__"]), fields,
                {n: tuple(int(x) for x in m[f"shape_{n}"]) for n in fields},
                {n: np.dtype(str(m[f"dtype_{n}"])) for n in fields})


def _own_blocks(dir_path: str, fields, shapes, mesh) -> Optional[dict]:
    """This rank's leaves from its own shard file, or None when that file
    was not written by a rank of this block layout."""
    path = os.path.join(dir_path, f"shard_{mesh.rank:05d}.npz")
    if not os.path.exists(path):
        return None
    out = {}
    with np.load(path, allow_pickle=False) as z:
        files = set(z.files)
        for name in fields:
            if f"s_{name}" in files:
                out[name] = z[f"s_{name}"]
                continue
            if len(shapes[name]) != 2:
                return None
            want = _block_range((shapes[name][0] // mesh.ny,
                                 shapes[name][1] // mesh.nx), mesh)
            i = 0
            while f"f_{name}__{i}" in files:
                if np.array_equal(z[f"i_{name}__{i}"], want):
                    out[name] = z[f"f_{name}__{i}"]
                    break
                i += 1
            else:
                return None
    return out


def _assemble(dir_path: str, nproc: int, fields, shapes, dtypes) -> dict:
    """The global arrays from every shard file."""
    out = {name: None for name in fields}
    for p in range(nproc):
        with np.load(os.path.join(dir_path, f"shard_{p:05d}.npz"),
                     allow_pickle=False) as z:
            files = set(z.files)
            for name in fields:
                if f"s_{name}" in files:
                    out[name] = z[f"s_{name}"]
                    continue
                i = 0
                while f"f_{name}__{i}" in files:
                    if out[name] is None:
                        out[name] = np.zeros(shapes[name], dtypes[name])
                    idx = z[f"i_{name}__{i}"]
                    sl = tuple(slice(int(a), int(b)) for a, b in idx)
                    out[name][sl] = z[f"f_{name}__{i}"]
                    i += 1
    return out


def load_sharded(dir_path: str, state_cls, mesh=None, device=None):
    """Load a sharded checkpoint; returns (state, step).

    With ``mesh`` each rank gets its own blocks on the mesh's device: read
    from its own shard file when the checkpoint was written on a mesh of
    this shape, else assembled from every file and cut to this rank's
    blocks (the elastic resume).  Without a mesh the global fields are
    assembled on ``device`` (default ``cuda``)."""
    step, nproc, fields, shapes, dtypes = _read_manifest(dir_path)
    if mesh is not None:
        from ..dist.mesh import local_part

        device = mesh.device if device is None else device
        arrays = _own_blocks(dir_path, fields, shapes, mesh)
        if arrays is None:
            full = _assemble(dir_path, nproc, fields, shapes, dtypes)
            arrays = {n: (np.ascontiguousarray(local_part(
                torch.from_numpy(a), a.shape, mesh).numpy())
                if a.ndim == 2 else a) for n, a in full.items()}
    else:
        device = "cuda" if device is None else device
        arrays = _assemble(dir_path, nproc, fields, shapes, dtypes)
    kw = {n: _to_device(np.asarray(a), device) for n, a in arrays.items()}
    return state_cls(**kw), step
