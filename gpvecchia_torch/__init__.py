"""gpvecchia_torch: the Vecchia Gaussian-process engine in PyTorch + CUDA.

A port of the JAX package ``gpvecchia_tpu`` (which stays as the reference)
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.  It covers the
host spec and plan, with MRA and 'firstm' conditioning, and every plan
mode of the JAX package:

* the multifrontal 'chol' mode (cond_yz y/z/SGV/SGVT, without prediction
  points or with ``ordering_pred="general"``);
* the per-entry V factor's modes: 'direct' (the zy family zy/RVP/LK, with
  or without prediction points: ``vecchia_pred``'s default spec),
  'obspred' (y/z/SGV/SGVT and MRA specs with obspred prediction points)
  and IC0 (``ic0=True``).

On all of them: the Gaussian log-likelihood and its gradient in the
covariance parameters and nuggets, for the covariances the JAX package
takes (Matern at any smoothness, esqe, user callables, a full covariance
matrix, and the selected (n_all, m+1) layout of ``hv.get_mat_cov``),
zero nuggets included; Vecchia MLE (``vecchia_estimate``); adaptive
HMC/NUTS over the covariance parameters (``fit.mcmc.sample_posterior``);
posterior prediction (``vecchia_prediction``: means, selected-inverse
variances, and the exact prediction variances of obspred specs;
``inference.prediction.vecchia_lincomb`` and ``V2covmat``); Vecchia–
Laplace for non-Gaussian data (``calculate_posterior_VL``,
``vecchia_laplace_likelihood``, ``vecchia_laplace_prediction``); and the
host-side IC0 helpers ``hv.create_L``, ``hv.ic0_csr`` and
``linalg.ichol.ichol``.  The likelihood, its gradient and the posterior
also run sharded over processes (``parallel.mesh``, on
``torch.distributed``: a rank's subtrees of the multifrontal tree, or its
range of rows on the V engine, and the chains axis of
``sample_posterior(mesh=)``), and specs are written and read as ``.npz``
files in the JAX package's layout (``utils.serialize``: ``save_spec``,
``load_spec``).  The entry points run on the card unless the caller passes
``device="cpu"``.  Importing the package builds nothing: the host library
and the CUDA kernels are compiled at first use.
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
