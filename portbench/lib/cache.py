"""The benchmark's caches, at fixed paths inside the checkout
(``portbench/.cache/``): the program's spec, written and read through the
port's own ``save_spec`` / ``load_spec``, and the reference's spec and
elimination levels.  Each file's name carries a hash of the configuration
file and of the sources that build it, so a change to either builds
anew."""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

from .cell import BENCH, ROOT

CACHE = BENCH / ".cache"

# the port's sources that decide a spec
SPEC_SOURCES = ("gpvecchia_torch/spec.py", "gpvecchia_torch/geometry/*.py",
                "gpvecchia_torch/csrc/host.py",
                "gpvecchia_torch/csrc/hostops.cpp")
REF_SOURCES = ("portbench/reference/spec.py", "portbench/reference/mra.py",
               "portbench/reference/factor.py")


def key(config_bytes, patterns, root=ROOT):
    """A hex digest of the configuration and of the files ``patterns``
    (globs relative to ``root``) name, path and content."""
    h = hashlib.sha256(config_bytes)
    for pat in patterns:
        for f in sorted(root.glob(pat)):
            h.update(str(f.relative_to(root)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:24]


def _atomic(path: Path, write):
    """write(file object) into ``path``, visible only once complete."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".part{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def program_spec(cell, build, cache_dir=CACHE):
    """The port's spec of ``cell``'s configuration: loaded from the cache,
    or ``build()`` and saved.  Returns (spec, whether it was built)."""
    from gpvecchia_torch.utils.serialize import load_spec, save_spec
    k = key(cell.config_bytes, SPEC_SOURCES)
    path = Path(cache_dir) / "spec" / f"{cell.workload['config']}-{k}.npz"
    if path.exists():
        return load_spec(path), False
    spec = build()
    _atomic(path, lambda f: save_spec(spec, f))
    return spec, True


def reference_arrays(cell, build, cache_dir=CACHE):
    """{name: array} of the reference's spec and levels, cached like the
    program's spec."""
    k = key(cell.config_bytes, REF_SOURCES)
    path = Path(cache_dir) / "reference" / f"{cell.workload['config']}-{k}.npz"
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            return {f: z[f] for f in z.files}
    arrays = build()
    _atomic(path, lambda f: np.savez(f, **arrays))
    return arrays
