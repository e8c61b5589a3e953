"""Build and load the port's native libraries (g++, no other dependency).

Each source (``lake_solver.cpp``, the flow routing's host stages, and
``snap_codec.cpp``, the undo snapshots' codec) is compiled with
``g++ -O2 -std=c++17 -shared -fPIC`` into a library of its own in
``demiurge_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the existing library.  A build runs at first use; nothing here runs
at import.  A failed build raises.

    python -m demiurge_tpu_torch.native.build   # build both now
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

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
SOURCE = NATIVE_DIR / "lake_solver.cpp"
SNAP_SOURCE = NATIVE_DIR / "snap_codec.cpp"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

#: source name -> {entry point: (restype, argtypes)}
SIGNATURES = {
    # mask mouth height, H W wrap_x, conn_from conn_to conn_h n_conn lake_wh
    "lake_solver.cpp": {"solve_lakes": (_I, [_P] * 3 + [_I] * 3 + [_P] * 5)},
    # n; data n accuracy out cap; in nbytes accuracy out n
    "snap_codec.cpp": {"dmg_snap_bound": (_I64, [_I64]),
                       "dmg_snap_encode": (_I64, [_P, _I64, _F, _P, _I64]),
                       "dmg_snap_decode": (_I64, [_P, _I64, _F, _P, _I64])},
}


def _digest(source: pathlib.Path = None) -> str:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update((source or SOURCE).read_bytes())
    return h.hexdigest()[:16]


def build(source: pathlib.Path = None) -> tuple[pathlib.Path, float]:
    """Compile ``source`` (default: the lake solver) unless a library of
    the same hash exists.  Returns (library path, seconds compiling)."""
    source = source or SOURCE
    lib = BUILD_DIR / f"libdemiurge_native_{_digest(source)}.so"
    if lib.exists():
        return lib, 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} needs a C++ "
                           "compiler on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        # compile to a private name, then rename: a concurrent process
        # never loads a half-written library
        tmp = pathlib.Path(tmpdir) / lib.name
        cmd = [cxx, *FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(source: pathlib.Path = None) -> ctypes.CDLL:
    """The loaded library of ``source`` (default: the lake solver) with
    every entry point's signature set."""
    source = source or SOURCE
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES[source.name].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


if __name__ == "__main__":
    for src in (SOURCE, SNAP_SOURCE):
        path, seconds = build(src)
        print(f"{path} ({seconds:.1f} s)")
