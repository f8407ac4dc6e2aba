"""Build, load and call the port's CUDA kernels.

All ``*.cu`` files of this directory (which include its ``*.cuh`` headers)
are compiled, one ``nvcc`` process per file run in parallel, and linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded with
ctypes.  The library lands in the port's
build directory under a name keyed by a hash of the sources, the headers
and the flags.
Nothing is built when the package is imported: the first CUDA launch
builds.  A missing ``nvcc``, a failed build or a failed launch raises; there
is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..utils import trace
from .host import BUILD_DIR

HERE = Path(__file__).resolve().parent
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    # ..., sig2, rho, nu_idx, gen (the general Matern's constants or
    # NULL), outputs ..., on the shared-memory route the general instances'
    # engagement counts (or NULL)
    "gpv_matern_solve_e0": [_P, _I, _P, _P, _P, _P, _I, _I, _D, _D, _I, _P,
                            _P, _P, _I, _P],
    "gpv_matern_solve_e0_bwd": [_P, _I, _P, _P, _P, _P, _I, _I, _D, _D, _I,
                                _P, _P, _P, _P, _P, _P, _I, _P],
    "gpv_matern_solve_e0_regs": [_P, _I, _P, _P, _P, _P, _I, _I, _D, _D, _I,
                                 _P, _P, _P],
    "gpv_matern_solve_e0_bwd_regs": [_P, _I, _P, _P, _P, _P, _I, _I, _D, _D,
                                     _I, _P, _P, _P, _P, _P, _P],
    "gpv_solve_e0": [_P, _I, _I, _P, _I, _P],
    "gpv_solve_e0_bwd": [_P, _I, _I, _P, _P, _P, _I, _P],
    "gpv_solve_e0_regs": [_P, _I, _I, _P, _P],
    "gpv_solve_e0_bwd_regs": [_P, _I, _I, _P, _P, _P, _P],
    "gpv_leaf_assemble": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "gpv_extend_add": [_P, _LL, _LL, _LL, _P, _P, _P, _I, _I, _P, _P],
    "gpv_front_factor": [_P, _I, _I, _I, _P],
    "gpv_front_factor_bwd": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _LL,
                             _P, _P],
    "gpv_extend_add_bwd": [_P, _I, _I, _P, _I, _P, _LL, _LL, _LL, _P, _P, _P],
    "gpv_leaf_assemble_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""              # nvcc's stderr (ptxas register/smem report)


def sources() -> list[Path]:
    return sorted(HERE.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(HERE.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libgpv_cuda-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of gpvecchia_torch"
                           " need the CUDA toolkit (CUDA_HOME or PATH)")
    return found


@trace.span("build.cuda")
def _build(out: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources():
            obj = str(Path(tmp) / (src.stem + ".o"))
            procs.append((obj, subprocess.Popen(
                [nvcc(), *compile_flags, "-Xptxas", "-v", "-c", "-o", obj,
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = []
        for obj, proc in procs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError("nvcc failed:\n" + err[-8000:])
        lib = str(Path(tmp) / out.name)
        res = subprocess.run([nvcc(), *FLAGS, "-o", lib,
                              *(obj for obj, _ in procs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr[-8000:])
        os.replace(lib, out)
    build_log = "".join(logs)
    trace.count("build.cuda.done")


def get_lib():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                for suffix in ("_f32", "_f64"):
                    fn = getattr(lib, name + suffix)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            lib.gpv_error_string.argtypes = [ctypes.c_int]
            lib.gpv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def entry(name: str, dtype: torch.dtype):
    """The C entry point ``name`` for ``dtype`` (float32 or float64)."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: CUDA kernels take float32 or float64, "
                        f"got {dtype}")
    return getattr(get_lib(), name + suffix)


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = get_lib().gpv_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({msg})")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

