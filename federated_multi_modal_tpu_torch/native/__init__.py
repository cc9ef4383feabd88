"""ctypes bindings for the port's native host-IO library (a copy of the
JAX package's ``native/imagecodec.cc``): libjpeg decode with DCT-domain
prescaling, libpng, PIL-equivalent anti-aliased resampling to a square uint8
canvas, and a threaded batch API.

Build: on first use, ``g++ -ljpeg -lpng`` compiles this directory's
``imagecodec.cc`` into ``federated_multi_modal_tpu_torch/build/`` under a
name keyed by a hash of the source (written to a temporary name, then
renamed, so concurrent processes never load a half-written library). If the
toolchain or the codec libraries are missing, ``available()`` is False and
callers (``data/transforms.py``, ``data/loader.py``) fall back to PIL. Set
``FMM_TPU_NATIVE=0`` to disable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

# mirror of the enums in imagecodec.cc
OK = 0
ERR_OPEN = 1
ERR_FORMAT = 2
ERR_DECODE = 3
ERR_ARG = 4

INTERP = {"nearest": 0, "bilinear": 1, "bicubic": 2}

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "imagecodec.cc")
_BUILD = os.path.join(os.path.dirname(_DIR), "build")

_lock = threading.Lock()
_lib = None
_tried = False
build_error = ""


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libfmm_torch_io_{digest}.so")


def _build(so: str) -> bool:
    global build_error
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-fPIC", "-std=c++17", "-shared",
        "-o", tmp, _SRC,
        "-ljpeg", "-lpng", "-lpthread",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = str(e)
        os.unlink(tmp)
        return False
    if proc.returncode != 0:
        build_error = proc.stderr.strip()[-2000:]
        os.unlink(tmp)
        return False
    os.replace(tmp, so)
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("FMM_TPU_NATIVE", "1") == "0":
            return None
        so = library_path()
        try:
            if not os.path.exists(so) and not _build(so):
                return None
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.fmm_decode_to_canvas.restype = ctypes.c_int
        lib.fmm_decode_to_canvas.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.fmm_decode_batch.restype = ctypes.c_int
        lib.fmm_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.fmm_native_version.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def version() -> str | None:
    lib = _load()
    if lib is None:
        return None
    return lib.fmm_native_version().decode()


def decode_to_canvas(
    path: str, canvas: int, interp: str = "bicubic",
    crop_square: bool = False,
) -> np.ndarray | None:
    """Decode one image file to a (canvas, canvas, 3) uint8 RGB array.

    Returns None on any failure (unsupported format, corrupt file, native
    lib unavailable) so callers can fall back to PIL.
    """
    lib = _load()
    if lib is None:
        return None
    out = np.empty((canvas, canvas, 3), np.uint8)
    rc = lib.fmm_decode_to_canvas(
        os.fsencode(path), canvas, INTERP[interp], int(crop_square),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == OK else None


def decode_batch(
    paths: list[str],
    canvas: int,
    interp: str = "bicubic",
    crop_square: bool = False,
    n_threads: int | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode a list of files in parallel into (N, canvas, canvas, 3) uint8.

    Returns (canvases, statuses) where statuses[i] != 0 marks a file the
    caller must re-decode via PIL; or None if the native lib is missing.
    """
    lib = _load()
    if lib is None or not paths:
        return None
    n = len(paths)
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    out = np.empty((n, canvas, canvas, 3), np.uint8)
    statuses = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.fmm_decode_batch(
        arr, n, canvas, INTERP[interp], int(crop_square), int(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out, statuses
