"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers it includes) is
compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per
source, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, from a kernel wrapper that was handed a CUDA tensor, and
lands in ``demiurge_tpu_torch/_build/`` (git-ignored) under a name keyed
by a hash of the sources, headers and flags, so an edited source rebuilds
and an unchanged one loads the existing library.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry point -> argtypes; every entry point returns cudaGetLastError()
SIGNATURES = {
    # cN cS cE cW cC b p0 ping pong, H W wrap_x wrap_s wrap_n pole_shift
    # th tw k iters, stream
    "demiurge_jacobi_pressure": [_P] * 9 + [_I] * 10 + [_P],
    # cN cS cE cW cC u v u_ping u_pong v_ping v_pong, H W wrap_x wrap_s
    # wrap_n pole_shift th tw k iters, stream
    "demiurge_jacobi_diffusion": [_P] * 11 + [_I] * 10 + [_P],
    # u v dx dy meta(host), nstrips strip_rows, ou ov, H W Ry Rf stride,
    # stream
    "demiurge_advect_sample": [_P] * 5 + [_I] * 2 + [_P] * 2 + [_I] * 5
    + [_P],
    # u v terrain tables meta(host), nstrips strip_rows, scalars(host)
    # nscalars, ou ov, H W Ry Rf stride, stream
    "demiurge_advect_stage": [_P] * 5 + [_I] * 2 + [_P, _I] + [_P] * 2
    + [_I] * 5 + [_P],
    # T cinv asr shifts out, H W wrap_s wrap_n pole_shift steps cluster seg
    # th, diff_scale olr_coef, stream
    "demiurge_climate_band": [_P] * 5 + [_I] * 9 + [_F] * 2 + [_P],
    # field vk vw hk hw weights ping pong, H W wrap_s wrap_n pole_shift
    # n_iter, stream
    "demiurge_blur": [_P] * 8 + [_I] * 6 + [_P],
    # field vk vw hk hw weights out, H W wrap_s wrap_n pole_shift n_iter
    # halo cluster seg th, stream
    "demiurge_blur_band": [_P] * 7 + [_I] * 10 + [_P],
    # cluster smem -> clusters the card holds at once
    "demiurge_climate_band_clusters": [_I] * 2,
    "demiurge_blur_band_clusters": [_I] * 2,
    # hb sel q dx8 code, H W, dy8, ty tx, stream
    "demiurge_flow_directions": [_P] * 5 + [_I] * 2 + [_F] + [_I] * 2
    + [_P],
    # hb sel q dx8 code packed, H W, dy8, turn_s turn_n wrap ty tx, stream
    "demiurge_flow_directions_packed": [_P] * 6 + [_I] * 2 + [_F]
    + [_I] * 5 + [_P],
    # packed area A flags stats, H W ty tx first n, stream
    "demiurge_flow_area_tiles": [_P] * 5 + [_I] * 6 + [_P],
    # packed vis, band, flags stats, H W ty tx first n, stream
    "demiurge_flow_vis_tiles": [_P] * 2 + [_I] + [_P] * 2 + [_I] * 6 + [_P],
    # packed E, band, flags stats, H W ty tx first n, stream
    "demiurge_flow_exit_tiles": [_P] * 2 + [_I] + [_P] * 2 + [_I] * 6
    + [_P],
    # packed area A vis flags next_flags bands(host), nact H W band k
    # cluster nseg seg, stream
    "demiurge_flow_banded_cluster": [_P] * 7 + [_I] * 8 + [_P],
    # cluster smem -> clusters the card holds at once
    "demiurge_flow_banded_cluster_clusters": [_I] * 2,
    # packed area A vis flags bands(host), nact H W band k, stream
    "demiurge_flow_banded_sweeps": [_P] * 6 + [_I] * 5 + [_P],
    # packed area A vis prev cur act, H W ty tx k, stream
    "demiurge_flow_tiles_round": [_P] * 7 + [_I] * 5 + [_P],
    # packed d0 d1 A vis flags, H W first n, stream
    "demiurge_flow_wave_sweeps": [_P] * 6 + [_I] * 4 + [_P],
    # packed area A vis ws, H W ty tx mode max_rounds, blocks(host), stream
    "demiurge_flow_fused": [_P] * 5 + [_I] * 6 + [_P] * 2,
    # packed area A vis ws, H W band k narrow mode max_rounds, blocks(host),
    # stream
    "demiurge_flow_fused_bands": [_P] * 5 + [_I] * 7 + [_P] * 2,
    # packed area A vis ws, H W ty tx k max_rounds, blocks(host), stream
    "demiurge_flow_2d_tma": [_P] * 5 + [_I] * 6 + [_P] * 2,
    # packed A vis d0 d1 ws, H W ty tx k max_rounds, blocks(host), stream
    "demiurge_flow_wave_tiles": [_P] * 6 + [_I] * 6 + [_P] * 2,
    # ob rowtab b in0 in1 ping0 pong0 ping1 pong1, H W wrap_x wrap_s wrap_n
    # pole_shift sea_mask negate th tw k iters, stream
    "demiurge_jacobi_packed": [_P] * 9 + [_I] * 12 + [_P],
    # the same, one launch a sweep: ... pole_shift sea_mask negate iters,
    # stream
    "demiurge_jacobi_packed_sweeps": [_P] * 9 + [_I] * 9 + [_P],
    # packed area conn_src conn_dst A0 vis0 root0 A1 vis1 root1 A2 vis2
    # root2, H W wrap_x n, stream
    "demiurge_lake_relax": [_P] * 13 + [_I] * 4 + [_P],
    # packed area conn_src conn_dst A, wrap_x, flags stats, H W ty tx first
    # n, stream
    "demiurge_lake_area_tiles": [_P] * 5 + [_I] + [_P] * 2 + [_I] * 6
    + [_P],
    # packed conn_src conn_dst vis, wrap_x, flags stats, H W ty tx first n,
    # stream
    "demiurge_lake_vis_tiles": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 6
    + [_P],
    # packed root, wrap_x, flags stats, H W ty tx first n, stream
    "demiurge_lake_root_tiles": [_P] * 2 + [_I] + [_P] * 2 + [_I] * 6
    + [_P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> tuple[pathlib.Path, str, float]:
    """Compile the sources unless a library of the same hash exists.
    Returns (library path, compiler log, seconds spent compiling)."""
    sources = _sources()
    lib = BUILD_DIR / f"libdemiurge_kernels_{_digest(sources)}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [pathlib.Path(tmpdir) / f"{src.stem}.o" for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        # link to a private name, then rename: a concurrent process never
        # loads a half-written library
        tmp = pathlib.Path(tmpdir) / lib.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib, "".join(logs), time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.demiurge_error_string.argtypes = [_I]
    lib.demiurge_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().demiurge_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

