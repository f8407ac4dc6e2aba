#!/usr/bin/env python3
"""How fast one NVIDIA GPU stores the lower triangles of square (N, F1, F1)
fronts, the layout the port's multifrontal kernels write (H2 leaf_assemble,
H3 extend_add), beside full rows, a packed triangle and cudaMemset of the
same buffer.

    python3 scripts/torch_triangle_stores.py

A bare store kernel (a block per front and band of rows, a row a warp,
coalesced) writes each pattern at the leaf and deepest internal level of
the n=1e6, m=40 plan and at a middle and a top level; CUDA events, median
of 7.  It prints the card's name and power limit and each pattern's time
and rate (bytes written over time).  Needs a CUDA device and nvcc; builds
into the port's build directory.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

from gpvecchia_torch.csrc import cuda
from gpvecchia_torch.csrc.host import BUILD_DIR

SOURCE = r"""
#include <cuda_runtime.h>
// MODE 0: rows i of the lower triangle (i + 1 values at i F1), 1: full rows
// (F1 values), 2: the packed triangle (row i at i (i + 1) / 2)
template <int MODE>
__global__ void __launch_bounds__(256) stores(float* out, int F1, int R) {
  const int r0 = (int)((long)F1 * blockIdx.y / R);
  const int r1 = (int)((long)F1 * (blockIdx.y + 1) / R);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* o = out + (long)blockIdx.x * F1 * F1;
  for (int i = r0 + warp; i < r1; i += 8) {
    const int len = MODE == 1 ? F1 : i + 1;
    float* row = MODE == 2 ? o + i * (i + 1) / 2 : o + i * F1;
    for (int j = lane; j < len; j += 32) row[j] = (float)(i + j);
  }
}
extern "C" int store_pattern(float* out, int N, int F1, int R, int mode) {
  dim3 grid(N, R);
  if (mode == 0) stores<0><<<grid, 256>>>(out, F1, R);
  else if (mode == 1) stores<1><<<grid, 256>>>(out, F1, R);
  else if (mode == 2) stores<2><<<grid, 256>>>(out, F1, R);
  else return (int)cudaMemsetAsync(out, 0, (size_t)N * F1 * F1 * 4);
  return (int)cudaGetLastError();
}
"""

# (N, F1): the leaf and the deepest internal level of n=1e6, m=40, a middle
# level and the widest top level
SHAPES = ((8192, 330), (4096, 334), (64, 2301), (4, 5270))
BANDS = 16


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_triangle_stores: no CUDA device visible")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD_DIR / "triangle_stores.cu", BUILD_DIR / "triangle_stores.so"
    src.write_text(SOURCE)
    subprocess.run([cuda.nvcc(), *cuda.FLAGS, "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).store_pattern
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for N, F1 in SHAPES:
        buf = torch.empty(N * F1 * F1, device="cuda")
        tri = N * F1 * (F1 + 1) // 2 * 4
        for mode, name, nbytes in ((0, "lower-triangle rows", tri),
                                   (1, "full rows", N * F1 * F1 * 4),
                                   (2, "packed triangle", tri),
                                   (3, "cudaMemset", N * F1 * F1 * 4)):
            def once():
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                rc = fn(buf.data_ptr(), N, F1, BANDS, mode)
                b.record()
                b.synchronize()
                if rc:
                    raise RuntimeError(f"store_pattern failed: {rc}")
                return a.elapsed_time(b)
            once()
            ms = statistics.median(once() for _ in range(7))
            print(f"N={N:5d} F1={F1:5d} {name:20s}: {ms:.3f} ms, "
                  f"{nbytes / 1e9:.3f} GB, {nbytes / ms / 1e9:.2f} TB/s",
                  flush=True)
        del buf
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
