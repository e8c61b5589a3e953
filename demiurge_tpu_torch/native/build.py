"""Build and load the port's native library (g++, no other dependency).

``lake_solver.cpp`` is compiled with ``g++ -O2 -std=c++17 -shared -fPIC``
into ``demiurge_tpu_torch/_build/`` (git-ignored) under a name keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the existing library.  The build runs at first use;
nothing here runs at import.  A failed build raises.

    python -m demiurge_tpu_torch.native.build   # build now, print the path
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
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int

# mask mouth height, H W wrap_x, conn_from conn_to conn_h n_conn lake_wh
SIGNATURES = {"solve_lakes": [_P] * 3 + [_I] * 3 + [_P] * 5}


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[pathlib.Path, float]:
    """Compile the solver unless a library of the same hash exists.
    Returns (library path, seconds spent compiling)."""
    lib = BUILD_DIR / f"libdemiurge_native_{_digest()}.so"
    if lib.exists():
        return lib, 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the lake solver needs a C++ "
                           "compiler on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        # compile to a private name, then rename: a concurrent process
        # never loads a half-written library
        tmp = pathlib.Path(tmpdir) / lib.name
        cmd = [cxx, *FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native library with every entry point's signature set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    path, seconds = build()
    print(f"{path} ({seconds:.1f} s)")
