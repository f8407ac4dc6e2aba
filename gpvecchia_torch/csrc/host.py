"""Native host ops (ordering, neighbor search, SGV selection) via ctypes.

The C++ source is the port's own ``hostops.cpp`` beside this module, a
byte-identical copy of the JAX package's ``gpvecchia_tpu/csrc/hostops.cpp``
(``tests/test_torch_host.py`` holds the two equal); nothing of that package
is read or imported.  The library is compiled with ``g++ -O3 -shared -fPIC``
into the port's build directory under a name keyed by a hash of the source
and the flags (never by mtime), so a stale or foreign binary is never loaded
and the JAX package's tracked ``libhostops.so`` is neither read nor
rewritten.

When no C++ toolchain is available, callers fall back to the NumPy
implementations in ``gpvecchia_torch.geometry`` (exact, but hours at
n=1e6); ``native_loaded()`` reports which path is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Content-addressed location of the compiled host library."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libhostops-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private temp name, then rename: concurrent builders
    # (test workers) never observe a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.maxmin_exact.argtypes = [f64p, ctypes.c_int64, ctypes.c_int, i64p]
        lib.ordered_nn.argtypes = [f64p, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, i64p]
        lib.sgv_select.argtypes = [i64p, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int64, u8p]
        for fn in (lib.maxmin_exact, lib.ordered_nn, lib.sgv_select):
            fn.restype = None
        _lib = lib
        return _lib


def native_loaded() -> bool:
    """True when the compiled host library is in use (else NumPy)."""
    return get_lib() is not None


def maxmin_exact(locs: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    locs = np.ascontiguousarray(locs, dtype=np.float64)
    n, d = locs.shape
    out = np.empty(n, dtype=np.int64)
    lib.maxmin_exact(locs, n, d, out)
    return out


def ordered_nn(locsord: np.ndarray, m: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    locs = np.ascontiguousarray(locsord, dtype=np.float64)
    n, d = locs.shape
    m = int(min(m, n - 1))
    NN = np.empty((n, m + 1), dtype=np.int64)
    lib.ordered_nn(locs, n, d, m, NN)
    return NN


def sgv_select(NN: np.ndarray, first_pred: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    NN = np.ascontiguousarray(NN, dtype=np.int64)
    n, mp1 = NN.shape
    cond = np.empty((n, mp1), dtype=np.uint8)
    lib.sgv_select(NN, n, mp1, first_pred, cond)
    return cond.astype(bool)
