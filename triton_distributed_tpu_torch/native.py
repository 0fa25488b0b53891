"""The port's native (C++) host library: built at first use, bound with
ctypes.

Counterpart of ``triton_distributed_tpu/native.py``: one shared library
over ``csrc/moe_utils.cc`` (the MoE align/sort routine), compiled by
``g++`` at first use into ``build/torch_native/`` at the repository root
(listed in ``.gitignore``; the file name carries a hash of the source and
flags, so an edited source is rebuilt and never loaded stale). It has no
XLA FFI targets: ``ops/moe/native_sort.py`` wraps the routine as a torch
custom op instead. The JAX library's AOT archive API
(``csrc/aot_runtime.cc``) comes with the port of the AOT tools (ROADMAP
queue 1 position 10).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SOURCES = (_PKG / "csrc" / "moe_utils.cc",)
BUILD_DIR = _PKG.parent / "build" / "torch_native"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtdt_native_{h.hexdigest()[:16]}.so"


def toolchain_available() -> bool:
    """Whether a ``g++`` is on the PATH to build the library with."""
    return shutil.which("g++") is not None


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises OSError without a ``g++``, and RuntimeError with the
    compiler's error output when the build fails."""
    out = _lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found: the port's native library is built "
                      "from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A process-private file renamed into place: concurrent builds
    # (test workers) never load a half-written library.
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, *map(str, _SOURCES), "-o",
                              str(tmp)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build the native library "
                f"(exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


@functools.cache
def get_native() -> ctypes.CDLL | None:
    """Build and load the library, its entry typed; None only where it is
    not built and no ``g++`` is there to build it. A failed build
    raises."""
    if not _lib_path().exists() and not toolchain_available():
        return None
    lib = ctypes.CDLL(str(build()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn = lib.tdt_moe_align_block_size_host
    fn.restype = ctypes.c_int
    fn.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p,
                   ctypes.c_int64, i32p, ctypes.c_int64, i32p]
    return lib


def native_available() -> bool:
    """True once the library loads; False only without a toolchain. A
    failed build raises."""
    return get_native() is not None
