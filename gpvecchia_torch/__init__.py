"""gpvecchia_torch: the Vecchia Gaussian-process engine in PyTorch + CUDA.

A port of the JAX package ``gpvecchia_tpu`` (which stays as the reference)
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.  It covers the
host spec and plan; in the multifrontal 'chol' mode (cond_yz y/z/SGV/SGVT,
without prediction points or with ``ordering_pred="general"``) the
Gaussian log-likelihood and its gradient in the covariance parameters and
nuggets, for the covariances the JAX package takes (Matern at any
smoothness, esqe, user callables, a full covariance matrix); Vecchia MLE
(``vecchia_estimate``); posterior prediction through the kept
multifrontal factor (``vecchia_prediction``: means, selected-inverse
variances; ``inference.prediction.vecchia_lincomb`` and ``V2covmat``); and
Vecchia–Laplace for non-Gaussian data (``calculate_posterior_VL``,
``vecchia_laplace_likelihood``, ``vecchia_laplace_prediction``).  The
entry points run on the card unless the caller passes ``device="cpu"``.
Importing the package builds nothing: the host library and the CUDA
kernels are compiled at first use.
"""

from .spec import VecchiaSpec, vecchia_specify
from .inference.likelihood import vecchia_likelihood, loglik_fn
from .fit.mle import vecchia_estimate
from .inference.prediction import vecchia_prediction
from .inference.laplace import (calculate_posterior_VL,
                                vecchia_laplace_likelihood,
                                vecchia_laplace_prediction)

__all__ = [
    "VecchiaSpec",
    "vecchia_specify",
    "vecchia_likelihood",
    "loglik_fn",
    "vecchia_estimate",
    "vecchia_prediction",
    "calculate_posterior_VL",
    "vecchia_laplace_likelihood",
    "vecchia_laplace_prediction",
]

__version__ = "0.1.0"
