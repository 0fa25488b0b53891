"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``triton_distributed_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries are built at first use, from the sources in this
checkout only, into ``build/torch_kernels/`` at the repository root
(listed in ``.gitignore``); the file name carries a hash of the sources
and flags, so an edited kernel is rebuilt and never loaded stale.
:func:`build` starts one ``nvcc`` per source, all at once.

Each kernel is a :class:`CudaKernel` with a plain integer ``launches``
counter that goes up by one per successful launch and nowhere else.
Every launch runs on PyTorch's current stream and its C entry point
returns ``cudaGetLastError()``; a non-zero code raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Sources, each one shared library.
SOURCES = ("flash_attention", "flash_decode", "megakernel")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin or PATH); the port's CUDA "
            "kernels are built from source at first use"
        )
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtdt_{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns each
    source's ptxas report (registers, shared memory, spills); raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


class CudaKernel:
    """One C entry point of a kernel library, with its launch counter."""

    def __init__(self, name: str, library_name: str, symbol: str,
                 argtypes: list):
        self.name = name
        self.library_name = library_name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.library_name), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed with cudaError {err}"
            )
        self.launches += 1


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operand(name: str, t: torch.Tensor, device, dtype=None,
                       ndim: int | None = None) -> None:
    """The operand checks every wrapper makes before a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# Kernel registry: one entry per hand-written kernel of the port.
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

FLASH_ATTENTION = CudaKernel(
    "flash_attention", "flash_attention", "tdt_flash_attention_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
)
FLASH_DECODE = CudaKernel(
    "flash_decode", "flash_decode", "tdt_flash_decode",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
)
PAGED_FLASH_DECODE = CudaKernel(
    "paged_flash_decode", "flash_decode", "tdt_paged_flash_decode",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
     _P],
)
FLASH_ATTENTION_INT8 = CudaKernel(
    "flash_attention_int8", "flash_attention", "tdt_flash_attention_int8_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
)
FLASH_ATTENTION_BIAS = CudaKernel(
    "flash_attention_bias", "flash_attention", "tdt_flash_attention_bias_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
)
PAGED_FLASH_DECODE_INT8 = CudaKernel(
    "paged_flash_decode_int8", "flash_decode", "tdt_paged_flash_decode_int8",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
     _I, _P],
)
# The decode megakernel: host arrays of the operand pointers and the
# geometry ints, the RMS epsilon, the softmax scale, an int[4] that
# receives the launch geometry, and the stream
# (megakernel/code_generator.py packs them).
MEGA_DECODE = CudaKernel(
    "mega_decode", "megakernel", "tdt_mega_decode",
    [_P, _P, _F, _F, _P, _P],
)
KERNELS = (FLASH_ATTENTION, FLASH_DECODE, PAGED_FLASH_DECODE,
           FLASH_ATTENTION_INT8, PAGED_FLASH_DECODE_INT8,
           FLASH_ATTENTION_BIAS, MEGA_DECODE)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
