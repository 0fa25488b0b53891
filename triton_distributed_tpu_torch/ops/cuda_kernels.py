"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``triton_distributed_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries are built at first use, from the sources in this
checkout only, into ``build/torch_kernels/`` at the repository root
(listed in ``.gitignore``); the file name carries a hash of the sources
(every ``csrc`` file: a source may include another) and flags, so an
edited kernel is rebuilt and never loaded stale.
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
# --split-compile=0 optimizes a source's kernels in parallel on every
# host core: the megakernel's eight instantiations built in 27.5 s with
# it and 87.6 s without, on the H100's 8-core host.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--split-compile=0",
)
# Sources, each one shared library (megakernel_moe.cu is megakernel.cu
# built with its MoE instantiations only; overlap.cu holds the three
# GEMM+collective kernels, collectives.cu the all-gathers, reduce-scatters,
# all-reduces, the pipeline shift, the broadcast and the low-latency
# all-gather, all_to_all.cu the dense all-to-all and the EP exchange,
# sp_attention.cu the sequence-parallel all-gather attention).
SOURCES = ("flash_attention", "flash_decode", "megakernel", "megakernel_moe",
           "overlap", "collectives", "all_to_all", "sp_attention")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# gemm_rs's wire types (csrc/overlap.cu `Wire`).
WIRE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + (name,)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
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
# The long-context cold partials: non-causal flash attention over the cold
# window with the s_cold bias (model dtype, and int8 codes + scales), and
# the dense decode over int8 codes with one scale per chunk.
FLASH_ATTENTION_COLD = CudaKernel(
    "flash_attention_cold", "flash_attention", "tdt_flash_attention_cold_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
)
FLASH_ATTENTION_COLD_INT8 = CudaKernel(
    "flash_attention_cold_int8", "flash_attention",
    "tdt_flash_attention_cold_int8_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
     _P],
)
FLASH_DECODE_INT8 = CudaKernel(
    "flash_decode_int8", "flash_decode", "tdt_flash_decode_int8",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
     _P],
)
# The decode megakernel: host arrays of the operand pointers and the
# geometry ints, the RMS epsilon, the softmax scale, an int[4] that
# receives the launch geometry, and the stream
# (megakernel/code_generator.py packs them).
MEGA_DECODE = CudaKernel(
    "mega_decode", "megakernel", "tdt_mega_decode",
    [_P, _P, _F, _F, _P, _P],
)
# The same entry point launched with the device task tracer on (a trace
# ring operand; with a work ring, RING_POLL stamps its doorbell): counted
# apart, so a run shows which of its launches were traced.
MEGA_DECODE_TRACED = CudaKernel(
    "mega_decode_traced", "megakernel", "tdt_mega_decode",
    [_P, _P, _F, _F, _P, _P],
)
# The decode megakernel over an MoE graph (traced or not): the MoE build
# of the same source, its own library.
MEGA_DECODE_MOE = CudaKernel(
    "mega_decode_moe", "megakernel_moe", "tdt_mega_decode",
    [_P, _P, _F, _F, _P, _P],
)
# The dense decode megakernel over n > 1 co-located ranks (traced or not):
# one cooperative launch of every rank, n, the n ranks' rows of the
# pointer and geometry arrays, the RMS epsilon, the softmax scale, the
# exchange's slot and flag device tables, epoch, flag and candidate-block
# capacities, blocks per rank, the lagging rank (-1: none) and its lag in
# ns, an int[4] for the launch geometry, and the stream.
_LL = ctypes.c_longlong
MEGA_DECODE_TP = CudaKernel(
    "mega_decode_tp", "megakernel", "tdt_mega_decode_tp",
    [_I, _P, _P, _F, _F, _P, _P, ctypes.c_ulonglong, _I, _I, _I, _I, _LL,
     _P, _P],
)
# The MoE decode megakernel over n > 1 co-located ranks, its experts
# expert-parallel (traced or not): the MoE library's own entry point of
# the same arguments.
MEGA_DECODE_MOE_TP = CudaKernel(
    "mega_decode_moe_tp", "megakernel_moe", "tdt_mega_decode_tp",
    [_I, _P, _P, _F, _F, _P, _P, ctypes.c_ulonglong, _I, _I, _I, _I, _LL,
     _P, _P],
)
# The prefill megakernel (its own __global__ in the same source).
MEGA_PREFILL = CudaKernel(
    "mega_prefill", "megakernel", "tdt_mega_prefill",
    [_P, _P, _F, _F, _P, _P],
)
# The prefill megakernel over n > 1 co-located ranks: n, the ranks' rows
# of the pointer and geometry arrays, the RMS epsilon, the softmax scale,
# the exchange's slot and flag device tables, epoch, flag and block
# capacities, blocks per rank, an int[4] for the launch geometry, and the
# stream.
MEGA_PREFILL_TP = CudaKernel(
    "mega_prefill_tp", "megakernel", "tdt_mega_prefill_tp",
    [_I, _P, _P, _F, _F, _P, _P, ctypes.c_ulonglong, _I, _I, _I, _P, _P],
)
# The cross-rank kernels over co-located ranks: one cooperative launch
# of (kind, dtype, small-M tile, gemm_rs's wire code, host tables of the
# per-rank A/B/O pointers and of the per-rank int32 outputs (the adaptive
# ag_gemm's order, the traced gemm_ar's ring; or null), the symmetric
# workspace's and flags' device tables, n, M, N, K, half_m, the traced
# gemm_ar's tile_n, epoch, ag_gemm's lagging rank (-1: none), its lag and
# every rank's delay in ns, blocks per rank, stream). The GEMM+collective
# kernels share the entry point (its first argument picks the kernel);
# each option's build has its own counter.
_I64P = ctypes.POINTER(ctypes.c_int64)
_U64 = ctypes.c_ulonglong
_OVERLAP_ARGS = [_I, _I, _I, _I, _I64P, _I64P, _I64P, _I64P, _P, _P, _I, _I,
                 _I, _I, _I, _I, _U64, _I, _LL, _LL, _I, _P]
GEMM_AR = CudaKernel("gemm_ar", "overlap", "tdt_overlap_launch",
                     _OVERLAP_ARGS)
GEMM_RS = CudaKernel("gemm_rs", "overlap", "tdt_overlap_launch",
                     _OVERLAP_ARGS)
AG_GEMM = CudaKernel("ag_gemm", "overlap", "tdt_overlap_launch",
                     _OVERLAP_ARGS)
# The options' builds: the arrival-adaptive ag_gemm, gemm_rs with an e4m3
# or a bf16 (over f32 inputs) wire, gemm_rs's one-rank ring
# (force_kernel at n = 1), the traced one-shot gemm_ar.
AG_GEMM_ADAPTIVE = CudaKernel("ag_gemm_adaptive", "overlap",
                              "tdt_overlap_launch", _OVERLAP_ARGS)
GEMM_RS_WIRE_E4M3 = CudaKernel("gemm_rs_wire_e4m3", "overlap",
                               "tdt_overlap_launch", _OVERLAP_ARGS)
GEMM_RS_WIRE_BF16 = CudaKernel("gemm_rs_wire_bf16", "overlap",
                               "tdt_overlap_launch", _OVERLAP_ARGS)
GEMM_RS_N1 = CudaKernel("gemm_rs_n1", "overlap", "tdt_overlap_launch",
                        _OVERLAP_ARGS)
GEMM_AR_TRACED = CudaKernel("gemm_ar_traced", "overlap",
                            "tdt_overlap_launch", _OVERLAP_ARGS)
# The collectives of csrc/collectives.cu, three C entry points whose first
# argument picks the kernel. All-gather (full mesh, ring, bidir ring): kind,
# host tables of the per-rank shard and output pointers, the flags' device
# table, n, shard bytes, the bidir ring's clockwise bytes, epoch, blocks per
# rank, stream.
_AG_ARGS = [_I, _I64P, _I64P, _P, _I, _LL, _LL, _U64, _I, _P]
ALL_GATHER = CudaKernel("all_gather", "collectives", "tdt_all_gather_launch",
                        _AG_ARGS)
ALL_GATHER_RING = CudaKernel(
    "all_gather_ring", "collectives", "tdt_all_gather_launch", _AG_ARGS)
ALL_GATHER_BIDIR_RING = CudaKernel(
    "all_gather_bidir_ring", "collectives", "tdt_all_gather_launch",
    _AG_ARGS)
# Reduce-scatter (one-shot, ring, bidir ring, HBM ring): kind, dtype, the
# x/o pointer tables, the workspace's and flags' device tables, n, chunk
# and bidir split (elements), epoch, blocks per rank, the lagging rank
# (-1: none) and its lag in ns, stream.
_RS_ARGS = [_I, _I, _I64P, _I64P, _P, _P, _I, _LL, _LL, _U64, _I, _I, _LL,
            _P]
REDUCE_SCATTER_ONE_SHOT = CudaKernel(
    "reduce_scatter_one_shot", "collectives", "tdt_reduce_scatter_launch",
    _RS_ARGS)
REDUCE_SCATTER_RING = CudaKernel(
    "reduce_scatter_ring", "collectives", "tdt_reduce_scatter_launch",
    _RS_ARGS)
REDUCE_SCATTER_BIDIR_RING = CudaKernel(
    "reduce_scatter_bidir_ring", "collectives", "tdt_reduce_scatter_launch",
    _RS_ARGS)
REDUCE_SCATTER_RING_HBM = CudaKernel(
    "reduce_scatter_ring_hbm", "collectives", "tdt_reduce_scatter_launch",
    _RS_ARGS)
# All-reduce (one-shot, doubling): kind, dtype, pointer tables, workspace
# and flag tables, n, elements, epoch, blocks per rank, lag rank, lag ns,
# stream.
_AR_ARGS = [_I, _I, _I64P, _I64P, _P, _P, _I, _LL, _U64, _I, _I, _LL, _P]
ALL_REDUCE_ONE_SHOT = CudaKernel(
    "all_reduce_one_shot", "collectives", "tdt_all_reduce_launch", _AR_ARGS)
ALL_REDUCE_DOUBLING = CudaKernel(
    "all_reduce_doubling", "collectives", "tdt_all_reduce_launch", _AR_ARGS)
# The dense all-to-all of csrc/all_to_all.cu: host tables of the per-rank
# x and o pointers, the flags' device table, n, chunk bytes, epoch, blocks
# per rank, stream.
ALL_TO_ALL = CudaKernel(
    "all_to_all", "all_to_all", "tdt_all_to_all_launch",
    [_I64P, _I64P, _P, _I, _LL, _U64, _I, _P])
# The EP exchange of the same source: host tables of the per-rank rows,
# out, splits and recv_counts pointers (the counts stay on the device), the
# flags' device table, n, segment capacity (rows), row bytes, epoch, blocks
# per rank, the lagging rank (-1: none) and its lag in ns, stream.
EP_EXCHANGE = CudaKernel(
    "ep_exchange", "all_to_all", "tdt_ep_exchange_launch",
    [_I64P, _I64P, _I64P, _I64P, _P, _I, _LL, _LL, _U64, _I, _I, _LL, _P])
# The sequence-parallel all-gather attention of csrc/sp_attention.cu:
# dtype, group, host tables of the per-rank q/k/v/o/lse and workspace
# pointers, the workspace's and flags' device tables, n, hkv, s_loc, head
# dim, softmax scale, epoch, a host array of each rank's blocks, stream.
SP_AG_ATTENTION = CudaKernel(
    "sp_ag_attention", "sp_attention", "tdt_sp_ag_attention_launch",
    [_I, _I, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P, _P, _P, _I, _I, _I,
     _I, _F, _U64, ctypes.POINTER(ctypes.c_int), _P])
# The byte movers of csrc/collectives.cu, one C entry point whose first
# argument picks the kernel (0 the pipeline shift, 1 the one-shot
# broadcast, 2 the pull gather, 3 the 2-D torus gather): kind, host tables
# of the per-rank x and o pointers, the flags' device table, n, shard
# bytes, the kernel's argument (wrap, root, window, inner size), epoch,
# blocks per rank, stream.
_MOVE_ARGS = [_I, _I64P, _I64P, _P, _I, _LL, _I, _U64, _I, _P]
PP_SHIFT = CudaKernel("pp_shift", "collectives", "tdt_move_launch",
                      _MOVE_ARGS)
BROADCAST = CudaKernel("broadcast", "collectives", "tdt_move_launch",
                       _MOVE_ARGS)
ALL_GATHER_PULL = CudaKernel("all_gather_pull", "collectives",
                             "tdt_move_launch", _MOVE_ARGS)
ALL_GATHER_TORUS_2D = CudaKernel("all_gather_torus_2d", "collectives",
                                 "tdt_move_launch", _MOVE_ARGS)
# The low-latency all-gather: host tables of the per-rank x and o
# pointers, the workspace's slot and flag device tables, n, shard bytes,
# the caller's phase, barrier_free, blocks per rank, stream.
LL_ALL_GATHER = CudaKernel(
    "ll_all_gather", "collectives", "tdt_ll_all_gather_launch",
    [_I64P, _I64P, _P, _P, _I, _LL, _U64, _I, _I, _P])
KERNELS = (FLASH_ATTENTION, FLASH_DECODE, PAGED_FLASH_DECODE,
           FLASH_ATTENTION_INT8, PAGED_FLASH_DECODE_INT8,
           FLASH_ATTENTION_BIAS, MEGA_DECODE, FLASH_ATTENTION_COLD,
           FLASH_ATTENTION_COLD_INT8, FLASH_DECODE_INT8, MEGA_DECODE_TRACED,
           MEGA_PREFILL, MEGA_DECODE_MOE, MEGA_DECODE_TP, GEMM_AR, GEMM_RS,
           AG_GEMM,
           ALL_GATHER, ALL_GATHER_RING, ALL_GATHER_BIDIR_RING,
           REDUCE_SCATTER_ONE_SHOT, REDUCE_SCATTER_RING,
           REDUCE_SCATTER_BIDIR_RING, REDUCE_SCATTER_RING_HBM,
           ALL_REDUCE_ONE_SHOT, ALL_REDUCE_DOUBLING, MEGA_DECODE_MOE_TP,
           MEGA_PREFILL_TP, ALL_TO_ALL, EP_EXCHANGE, SP_AG_ATTENTION,
           PP_SHIFT, ALL_GATHER_PULL, ALL_GATHER_TORUS_2D, BROADCAST,
           LL_ALL_GATHER, AG_GEMM_ADAPTIVE, GEMM_RS_WIRE_E4M3,
           GEMM_RS_WIRE_BF16, GEMM_RS_N1, GEMM_AR_TRACED)


def coresident_blocks(library_name: str, symbol: str, *args) -> int:
    """A capacity query of a cross-rank library: the blocks of a kernel
    that can be co-resident on the current device (the most one
    cooperative launch takes)."""
    fn = getattr(library(library_name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] * len(args)
    return int(fn(*args))


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
