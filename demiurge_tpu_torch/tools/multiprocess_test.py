"""A real two-process run of the mesh path and the sharded checkpoint.

Counterpart of the reference's ``tools/multiprocess_test.py``.  Starts two
OS processes that form one process group (a file store in a temporary
directory; gloo on ``--device cpu``, NCCL with one rank per card on
``cuda``, the default), then:

  1. runs 3 coupled steps on a 1x2 mesh (blocks of 64x64 on a 128x64
     grid) and checks them against 3 steps on one device;
  2. writes the sharded checkpoint (``utils.checkpoint.save_sharded``, one
     file per rank), resumes it on the same mesh (``load_sharded`` with the
     mesh: each rank reads only its own file), steps once more on both the
     resumed and the original state and checks they agree bit for bit;
  3. the parent assembles the checkpoint without a mesh
     (``load_sharded(mesh=None)``) and checks it against the single-device
     run.

Prints one JSON line (the reference's keys) and exits 1 unless every check
holds:

    python -m demiurge_tpu_torch.tools.multiprocess_test [--device cpu]
        [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

NPROC = 2
MESH = (1, 2)
SIZE = (128, 64)


def _setup(device):
    from ..core.grid import Grid
    from ..model import CoupledConfig
    from ..ops.noise import NoiseParams, fbm
    from ..ops.ocean import OceanConfig

    g = Grid(*SIZE)
    cfg = CoupledConfig(climate_substeps=2,
                        ocean=OceanConfig(jacobi_iters=16, diffusion_iters=4))
    h = fbm(g, NoiseParams(octaves=4, scale=2.0, min=-2.0, max=3.0, seed=7),
            device)
    return g, cfg, h


def worker(rank: int, device: str, workdir: str) -> None:
    import torch.distributed as dist

    from ..core.platform import claim_rank_device, collective_backend
    from ..dist import mesh as dmesh
    from ..model import CoupledState, coupled_step, init_coupled
    from ..utils import checkpoint as ckpt

    torch.set_num_threads(1)
    dev = claim_rank_device(device, rank)
    dist.init_process_group(collective_backend(dev),
                            init_method=f"file://{workdir}/store",
                            rank=rank, world_size=NPROC)
    mesh = dmesh.make_mesh(shape=MESH, device=dev)
    g, cfg, h = _setup(dev)

    st = init_coupled(dmesh.shard_field(h, mesh), g, mesh=mesh)
    for _ in range(3):
        st = coupled_step(st, g, cfg, mesh=mesh)
    ref = init_coupled(h, g)
    for _ in range(3):
        ref = coupled_step(ref, g, cfg)

    def diff(block, full):
        return (dmesh.gather_field(block, mesh) - full).abs()

    dh = diff(st.height, ref.height)
    dT = diff(st.temperature, ref.temperature)

    # sharded checkpoint round trip on the same mesh
    cdir = os.path.join(workdir, "ckpt")
    ckpt.save_sharded(cdir, st, 3, g, mesh=mesh)
    st2, step_no = ckpt.load_sharded(cdir, CoupledState, mesh=mesh)
    assert step_no == 3, step_no
    a = coupled_step(st, g, cfg, mesh=mesh)
    b = coupled_step(st2, g, cfg, mesh=mesh)
    dresume = float((dmesh.gather_field(a.height, mesh)
                     - dmesh.gather_field(b.height, mesh)).abs().max())

    if rank == 0:
        out = {
            "process_count": dist.get_world_size(),
            "backend": dist.get_backend(),
            "device": str(dev),
            "mesh": list(MESH),
            "grid": [SIZE[1], SIZE[0]],
            "steps": 3,
            "max_abs_height_diff_vs_single_device": float(dh.max()),
            "p999_abs_height_diff_vs_single_device": float(
                torch.quantile(dh.flatten().double().cpu(), 0.999)),
            "max_abs_temperature_diff_vs_single_device": float(dT.max()),
            "resume_then_step_max_abs_height_diff": dresume,
            # the reference tool's bounds: the bulk tight, a cell where a
            # float32 reassociation flips a direction tie may differ more
            "height_ok": bool(torch.quantile(dh.flatten().double().cpu(),
                                             0.999) < 1e-5
                              and float(dh.max()) < 5e-3),
            "temperature_ok": float(dT.max()) < 1e-3,
            "resume_ok": dresume == 0.0,
        }
        with open(os.path.join(workdir, "result.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        np.save(os.path.join(workdir, "ref_height.npy"),
                ref.height.cpu().numpy())
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    if args.worker is not None:
        worker(args.worker, args.device, args.workdir)
        return 0

    from ..model import CoupledState
    from ..utils import checkpoint as ckpt

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory(prefix="demiurge_mptest_") as workdir:
        procs = [subprocess.Popen(
            [sys.executable, "-u", "-m", __spec__.name, "--worker", str(i),
             "--device", args.device, "--workdir", workdir], env=env)
            for i in range(NPROC)]
        try:
            rcs = [p.wait(timeout=1800) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            print(json.dumps({"ok": False, "worker_exit_codes": rcs}))
            return 1
        with open(os.path.join(workdir, "result.json")) as fh:
            result = json.load(fh)

        # meshless assembly of the two-process checkpoint
        st, step_no = ckpt.load_sharded(os.path.join(workdir, "ckpt"),
                                        CoupledState, device=args.device)
        href = np.load(os.path.join(workdir, "ref_height.npy"))
    result["single_host_assembly_step"] = step_no
    result["assembled_fields"] = sorted(CoupledState.__dataclass_fields__)
    diff = np.abs(st.height.cpu().numpy() - href)
    result["single_host_assembly_height_diff_vs_ref"] = float(diff.max())
    result["assembly_ok"] = bool(float(np.quantile(diff, 0.999)) < 1e-5
                                 and float(diff.max()) < 5e-3
                                 and step_no == 3)
    result["ok"] = all(result[k] for k in ("height_ok", "temperature_ok",
                                           "resume_ok", "assembly_ok"))
    txt = json.dumps(result)
    print(txt)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(txt + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
