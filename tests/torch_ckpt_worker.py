"""One rank of a gloo process group on the CPU, for
tests/test_torch_checkpoint.py: the sharded checkpoint and the CLI's
checkpoint and resume under a mesh.

    python tests/torch_ckpt_worker.py INPUTS.npz OUTDIR NY NX RANK [ELASTIC]

Joins a group of NY*NX processes through the file store OUTDIR/store and
builds the NYxNX mesh.  From the full initial state in INPUTS.npz (each
rank takes its blocks) it runs 2 coupled steps, writes them with
``save_sharded`` to OUTDIR/ckpt, reads them back with ``load_sharded`` on
the same mesh, and runs 2 more steps on both the read and the original
state.  With ELASTIC (a sharded checkpoint written on another mesh) it
resumes that one on this mesh and runs 2 steps.  Then the CLI: ``coupled
--mesh NYxNX`` for 2 steps with a checkpoint every step, resumed to 3, and
an uninterrupted 3-step run with its own checkpoint.  Rank 0 writes the
gathered states to OUTDIR/out.npz.  It imports torch, numpy and the port
only (never JAX).
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from demiurge_tpu_torch.api import cli  # noqa: E402
from demiurge_tpu_torch.core.grid import Grid  # noqa: E402
from demiurge_tpu_torch.dist import mesh as dm  # noqa: E402
from demiurge_tpu_torch.model import CoupledState, coupled_step  # noqa: E402
from demiurge_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from demiurge_tpu_torch.utils import interop  # noqa: E402


def main(inputs, outdir, ny, nx, rank, elastic=None):
    torch.set_num_threads(1)
    outdir = pathlib.Path(outdir)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                            rank=rank, world_size=ny * nx)
    mesh = dm.make_mesh(shape=(ny, nx), device="cpu")
    data = dict(np.load(inputs))
    meta = json.loads(str(data.pop("meta")))
    grid = Grid(*meta["shape"])
    cfg = interop.coupled_config_from_dict(meta["cfg"])
    state = interop.coupled_state_blocks_from_numpy(data, mesh, "cpu")
    out = {}

    def put(tag, st):
        for name, arr in interop.coupled_state_blocks_to_numpy(
                st, mesh).items():
            out[f"{tag}_{name}"] = arr

    for _ in range(2):
        state = coupled_step(state, grid, cfg, mesh=mesh)
    put("saved", state)
    cdir = outdir / "ckpt"
    ckpt.save_sharded(str(cdir), state, 2, grid, mesh=mesh)
    own = ckpt._own_blocks(str(cdir), [f.name for f in dataclasses.fields(
        state)], {f.name: grid.shape for f in dataclasses.fields(state)},
        mesh) is not None
    loaded, step = ckpt.load_sharded(str(cdir), CoupledState, mesh=mesh)
    assert step == 2 and own
    put("loaded", loaded)
    for _ in range(2):
        state = coupled_step(state, grid, cfg, mesh=mesh)
        loaded = coupled_step(loaded, grid, cfg, mesh=mesh)
    put("cont", state)
    put("resumed", loaded)
    if elastic:
        st, step = ckpt.load_sharded(elastic, CoupledState, mesh=mesh)
        assert step == 2
        for _ in range(2):
            st = coupled_step(st, grid, cfg, mesh=mesh)
        put("elastic", st)

    W, H = meta["shape"]
    common = ["coupled", "--mesh", f"{ny}x{nx}", "--device", "cpu",
              "--width", str(W), "--height", str(H)]
    resumed = str(outdir / "cli_resumed.npz")
    cli.main(common + ["--steps", "2", "--checkpoint", resumed,
                       "--checkpoint-every", "1"])
    cli.main(common + ["--steps", "3", "--checkpoint", resumed,
                       "--checkpoint-every", "1", "--resume"])
    cli.main(common + ["--steps", "3", "--checkpoint",
                       str(outdir / "cli_straight.npz")])
    if rank == 0:
        np.savez(outdir / "out.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6]),
         *sys.argv[6:7])
