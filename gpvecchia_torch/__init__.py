"""gpvecchia_torch: the Vecchia Gaussian-process engine in PyTorch + CUDA.

A port of the JAX package ``gpvecchia_tpu`` (which stays as the reference)
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.  This slice
covers the host spec and plan and the Gaussian log-likelihood in the
multifrontal 'chol' mode (cond_yz y/z/SGV/SGVT without prediction points,
built-in Matern with smoothness 0.5/1.5/2.5).  Importing the package builds
nothing: the host library and the CUDA kernels are compiled at first use.
"""

from .spec import VecchiaSpec, vecchia_specify
from .inference.likelihood import vecchia_likelihood, loglik_fn

__all__ = [
    "VecchiaSpec",
    "vecchia_specify",
    "vecchia_likelihood",
    "loglik_fn",
]

__version__ = "0.1.0"
