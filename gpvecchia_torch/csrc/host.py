"""Native host ops (ordering, neighbor search, SGV selection, the MRA knot
tree, the symbolic Cholesky fill and the triangular-solve levels) via
ctypes.

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

from ..utils import trace

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


@trace.span("build.hostops")
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
        trace.count("build.hostops.done")
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
        lib.mra_tree.argtypes = [f64p, ctypes.c_int64, ctypes.c_int, i64p,
                                 i64p, ctypes.c_int64, i64p, i64p, i64p]
        lib.symbolic_chol_count.argtypes = [i64p, i64p, ctypes.c_int64,
                                            i64p, i64p]
        lib.symbolic_chol_count.restype = ctypes.c_int64
        lib.symbolic_chol_fill.argtypes = [i64p, i64p, ctypes.c_int64,
                                           i64p, i64p, i64p]
        lib.solve_levels_fwd.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
        lib.solve_levels_bwd.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
        for fn in (lib.maxmin_exact, lib.ordered_nn, lib.sgv_select,
                   lib.mra_tree, lib.symbolic_chol_fill,
                   lib.solve_levels_fwd, lib.solve_levels_bwd):
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


def mra_tree(locsord: np.ndarray, J, M: int, r):
    """Native MRA knot-tree chains; None if the library is unavailable.

    Returns (chain_next, chain_len, {"M": eff_M, "r": eff_r}), matching the
    Python BFS of ``geometry/mra.py`` (GPvecchia src/fastTree.cpp:272-297).
    """
    lib = get_lib()
    if lib is None:
        return None
    locs = np.ascontiguousarray(locsord, dtype=np.float64)
    n, d = locs.shape
    J = np.ascontiguousarray(J, dtype=np.int64)
    r = np.ascontiguousarray(r, dtype=np.int64)
    chain_next = np.empty(n, dtype=np.int64)
    chain_len = np.empty(n, dtype=np.int64)
    eff = np.empty(M + 4, dtype=np.int64)
    lib.mra_tree(locs, n, d, J, r, M, chain_next, chain_len, eff)
    eff_M, finest_count, finest_total = int(eff[0]), int(eff[1]), int(eff[2])
    eff_r = eff[3:3 + M + 1].tolist()
    if finest_count > 0:
        eff_r[M] = finest_total // finest_count
    return chain_next, chain_len, {"M": eff_M, "r": eff_r}


def _symbolic(indptr: np.ndarray, indices: np.ndarray, n: int):
    """(colptr, rows, parent, row_level) of the Cholesky fill; None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    colcount = np.empty(n, dtype=np.int64)
    lib.symbolic_chol_count(indptr, indices, n, parent, colcount)
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(colcount, out=colptr[1:])
    rows = np.empty(colptr[-1], dtype=np.int64)
    row_level = np.empty(n, dtype=np.int64)
    lib.symbolic_chol_fill(indptr, indices, n, colptr, rows, row_level)
    return colptr, rows, parent, row_level


def symbolic_chol_flat(indptr: np.ndarray, indices: np.ndarray, n: int):
    """(colptr, rows, row_level): the CSC pattern of the Cholesky fill of
    the symmetric matrix whose lower pattern is the CSR (indptr, indices),
    rows ascending with the diagonal first; None if the library is
    unavailable."""
    out = _symbolic(indptr, indices, n)
    return None if out is None else (out[0], out[1], out[3])


def symbolic_chol(indptr: np.ndarray, indices: np.ndarray, n: int):
    """(col_arrays, parent, row_level) of the Cholesky fill; None if the
    library is unavailable."""
    out = _symbolic(indptr, indices, n)
    if out is None:
        return None
    colptr, rows, parent, row_level = out
    return ([rows[colptr[j]:colptr[j + 1]] for j in range(n)], parent,
            row_level)


def solve_levels(colptr: np.ndarray, rows: np.ndarray, n: int,
                 direction: str):
    """Per-column dependency levels (from 1) of a triangular solve with the
    lower CSC pattern (colptr, rows): 'fwd' for L x = b, else L^T x = b;
    None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    colptr = np.ascontiguousarray(colptr, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    level = np.empty(n, dtype=np.int64)
    if direction == "fwd":
        lib.solve_levels_fwd(colptr, rows, n, level)
    else:
        lib.solve_levels_bwd(colptr, rows, n, level)
    return level
