"""Build, load and call the port's hand-written CUDA kernels.

The sources are ``federated_multi_modal_tpu_torch/csrc/*.cu``. On first use
each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with ``ctypes``. The library
lands in ``federated_multi_modal_tpu_torch/build/`` (listed in
``.gitignore``) under a name that carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs when the module is imported: the CPU tests import every
module, and there is no ``nvcc`` on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # qkv, mask, out, B, T, D, H, valid_T, scale, stream
    "fmm_attention_core": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # the same, then the keys held in registers (forced), stream
    "fmm_attention_core_forced": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # qkv, g, mask, stats scratch, dqkv, B, T, D, H, scale, stream
    "fmm_attention_core_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, q_stride, k_stride, v_stride, mask, out, B, T, D, H, head_dim,
    # scale, stream
    "fmm_attention_split": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, prompt, extra, B, T, D, n_ctx, n_extra, stream
    "fmm_inject_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # A, W, layout, M, N, K, splits, k_per_split, bias, pre_out, pre_f32,
    # gelu, dgelu_in, dgelu_f32, residual, residual_f32, out, out_f32, stream
    "fmm_gemm_epilogue": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P,
                          _I, _P, _I, _P, _I, _P],
    # x, x_f32, gamma, beta, out, rows, D, eps, stream
    "fmm_layernorm_rows": [_P, _I, _P, _P, _P, _I, _I, _F, _P],
    # A, W, M, N, K, bias, pre_out, rope table, rope T, rope columns, gate, out,
    # stream (EVA-CLIP's RoPE and gate epilogues)
    "fmm_gemm_epilogue_eva": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    # x, gamma, beta, out, rows, D, ld, eps, stream
    "fmm_layernorm_rows_ld": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    # pre, dgn, gamma, dpair, partial, rows, D, ld, blocks, eps, stream
    "fmm_layernorm_bwd_gate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # qkv, table, M, T, D, inverse, stream
    "fmm_rope_rows": [_P, _P, _I, _I, _I, _I, _P],
    # x, x_f32, dxn, dres, dres_f32, gamma, dx, dx_f32, dx_copy, partial,
    # rows, D, blocks, eps, stream
    "fmm_layernorm_bwd_rows": [_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
                               _I, _F, _P],
    # x, x_f32, out, rows, N, splits, rows_per_split, stream
    "fmm_column_sum": [_P, _I, _P, _L, _L, _I, _L, _P],
    # x, W, bias, gamma, beta, stats scratch, out, B, T, D, Dk, H, head width,
    # scale, stream
    "fmm_lnqkv_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, W, bias, gamma, beta, stats scratch, qkv, B, T, D, Dk, H, head width,
    # stream
    "fmm_lnqkv_project": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, W, bias, gamma, beta, dy, stats scratch, dqkv, B, T, D, Dk, H, head
    # width, scale, stream
    "fmm_lnqkv_attention_bwd_dqkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _P],
    # A, B, C, M, N, K, stream
    "fmm_gemm_nt_f32": [_P, _P, _P, _I, _I, _I, _P],
    # qkv, out, B, T, D, H, valid_T, scale, stream
    "fmm_attention_pair": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    # span id, opens (1) or closes (0), stream (utils/profiling.py's markers)
    "fmm_span_mark": [_I, _I, _P],
}

# Launches of each CUDA kernel since the last reset, by entry point.
LAUNCHES = {name: 0 for name in _SIGNATURES}

# Entry points that launch nothing: resident blocks per SM of a kernel as
# built and its dynamic shared memory (an int naming the variant, an int for
# masked or not, two int* for the answers).
_OCCUPANCY = ("fmm_attention_split_blocks_per_sm", "fmm_attention_core_bwd_blocks_per_sm",
              "fmm_attention_core_blocks_per_sm", "fmm_lnqkv_attention_blocks_per_sm",
              "fmm_lnqkv_attention_bwd_dqkv_blocks_per_sm", "fmm_attention_pair_blocks_per_sm",
              "fmm_gemm_epilogue_blocks_per_sm", "fmm_layernorm_bwd_rows_blocks_per_sm")

_lib = None
build_seconds = None  # wall time of the last build in this process, or 0.0 if loaded as built
build_log = ""  # nvcc's output for the library in use (registers and spills per kernel)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the port's kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds):
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"{' '.join(cmd)} failed:\n{out}"
              for cmd, proc, out in zip(cmds, procs, outs) if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    global build_seconds, build_log
    lib_path = BUILD_DIR / f"libfmm_kernels_{_digest()}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        build_seconds = 0.0
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    outs = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        for src, obj in zip(_sources(), objs)
    ])
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    outs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
    build_log = "".join(outs)
    log_path.write_text(build_log)  # kept for a process that loads the library as built
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    for obj in objs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0
    return lib_path


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in _OCCUPANCY:
            fn = getattr(lib, name)
            fn.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
            fn.restype = ctypes.c_int
        lib.fmm_attention_core_held_keys.argtypes = [_I, _I, _I]
        lib.fmm_attention_core_held_keys.restype = ctypes.c_int
        lib.fmm_attention_pair_key_tiles.argtypes = [_I, _I]
        lib.fmm_attention_pair_key_tiles.restype = ctypes.c_int
        lib.fmm_error_string.argtypes = [ctypes.c_int]
        lib.fmm_error_string.restype = ctypes.c_char_p
        lib.fmm_span_prepare.restype = ctypes.c_int
        err = lib.fmm_span_prepare()
        if err != 0:
            raise RuntimeError(
                f"fmm_span_prepare: CUDA error {err} ({lib.fmm_error_string(err).decode()})")
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one kernel entry point on the current stream; raise if CUDA
    refused the launch (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.fmm_error_string(err).decode()})")
    LAUNCHES[name] += 1


def blocks_per_sm(name: str, variant: int, masked: bool) -> tuple:
    """``(resident blocks per SM, dynamic shared memory bytes)`` of one
    kernel (``name`` in ``_OCCUPANCY``; ``variant`` its head width for
    ``attention_split``, head width + 256 x pass for ``attention_core_bwd``,
    head width + 256 x the keys held in registers for ``attention_core``,
    head width + 256 x key tiles held in registers for ``attention_pair``, T for ``lnqkv_attention`` and
    ``lnqkv_attention_bwd_dqkv``, layout x 512 + the epilogue's code for
    ``gemm_epilogue`` (``fused_block.GEMM_INSTANCES``; P2's product is NT,
    code 0x100), ``fused_block.ln_bwd_variant`` for ``layernorm_bwd_rows``
    (which has no mask); built with a mask or without), from the CUDA
    occupancy calculator with the registers and shared memory it was built
    with."""
    lib = library()
    blocks, smem = _I(0), _I(0)
    err = getattr(lib, name)(variant, int(masked), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.fmm_error_string(err).decode()})")
    return blocks.value, smem.value


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
