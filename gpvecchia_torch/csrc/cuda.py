"""Build, load and call the port's CUDA kernels.

All ``*.cu`` files of this directory are compiled by one ``nvcc`` call into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), loaded with ctypes.  The library lands in the port's
build directory under a name keyed by a hash of the sources and the flags.
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

from .host import BUILD_DIR

HERE = Path(__file__).resolve().parent
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "gpv_matern_solve_e0": [_P, _I, _P, _P, _P, _P, _I, _I, _D, _D, _I, _P,
                            _I, _P],
    "gpv_leaf_assemble": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "gpv_extend_add": [_P, _LL, _LL, _LL, _P, _P, _P, _I, _I, _P, _P],
    "gpv_front_factor": [_P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""              # nvcc's stderr (ptxas register/smem report)


def sources() -> list[Path]:
    return sorted(HERE.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
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


def _build(out: Path) -> None:
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cu = [str(s) for s in sources()]
    try:
        res = subprocess.run([nvcc(), *FLAGS, "-Xptxas", "-v", "-o", tmp, *cu],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stderr[-8000:])
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log = res.stderr


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


class KernelCall(torch.autograd.Function):
    """Runs ``launch(*tensors)`` with a backward that raises.

    Gradients through the CUDA kernels are not written yet (ROADMAP queue 1,
    the gradient item): without this wrapper ``backward()`` would silently
    return a gradient from only the torch parts of the graph.  ``dirty`` is
    the index of a tensor the launch modifies in place, or -1.
    """

    @staticmethod
    def forward(ctx, name, launch, dirty, *tensors):
        ctx.name = name
        out = launch(*tensors)
        if dirty >= 0:
            ctx.mark_dirty(tensors[dirty])
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"backward through the CUDA kernel {ctx.name} is not implemented"
            " (ROADMAP queue 1, item 1: gradient)")
