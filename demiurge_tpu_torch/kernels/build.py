"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, from a kernel wrapper that was
handed a CUDA tensor, and lands in ``demiurge_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the existing library.
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
    # iters, stream
    "demiurge_jacobi_pressure": [_P] * 9 + [_I] * 7 + [_P],
    # cN cS cE cW cC u v u_ping u_pong v_ping v_pong, H W wrap_x wrap_s
    # wrap_n pole_shift iters, stream
    "demiurge_jacobi_diffusion": [_P] * 11 + [_I] * 7 + [_P],
    # u v dx dy meta(host), nstrips strip_rows, ou ov, H W Ry Rf stride,
    # stream
    "demiurge_advect_sample": [_P] * 5 + [_I] * 2 + [_P] * 2 + [_I] * 5
    + [_P],
    # T cinv asr shifts ping pong, H W wrap_s wrap_n pole_shift substeps,
    # diff_scale olr_coef, stream
    "demiurge_climate_step": [_P] * 6 + [_I] * 6 + [_F] * 2 + [_P],
    # field vk vw hk hw weights ping pong, H W wrap_s wrap_n pole_shift
    # n_iter, stream
    "demiurge_blur": [_P] * 8 + [_I] * 6 + [_P],
    # hb sel q dx8 code, H W, dy8, stream
    "demiurge_flow_directions": [_P] * 5 + [_I] * 2 + [_F, _P],
    # packed area A flags, H W n, stream
    "demiurge_flow_area_sweeps": [_P] * 4 + [_I] * 3 + [_P],
    # packed vis flags, H W n, stream
    "demiurge_flow_vis_sweeps": [_P] * 3 + [_I] * 3 + [_P],
    # packed area A E(nullable) flags, H W band n, stream
    "demiurge_flow_local_sweeps": [_P] * 5 + [_I] * 4 + [_P],
    # packed vis flags, H W band n, stream
    "demiurge_flow_local_vis_sweeps": [_P] * 3 + [_I] * 4 + [_P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sources:
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

