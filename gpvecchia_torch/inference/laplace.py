"""Vecchia–Laplace inference for non-Gaussian data, in PyTorch.

The port of the JAX package's ``inference/laplace.py``: Newton–Raphson on
the latent posterior mode with Gaussian pseudo-data whose pseudo-nuggets
come from the likelihood's score and Hessian (GPvecchia
R/vecchia_laplace_NR.R).  Each iteration is one posterior mean through the
multifrontal factor (``prediction._posterior_core``: H1 for the U entries,
H2-H4 for the factor, a back-substitution); the iterate stays on the
device, and the loop's only host read per iteration is the convergence
test on the step (which also stops on NaN), as ``lax.while_loop`` is in
the JAX package.  Specs whose plan is not the multifrontal 'chol' mode
raise ``NotImplementedError``.

Likelihood models (score/hess/llh/link quadruples, reference lines):
  logistic R:213-224, poisson :227-239, gaussian :242-250, gamma :253-281,
  beta :285-322; negbinomial is a stub in the reference and raises here.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from ..plan import get_plan
from ..spec import vecchia_specify
from .likelihood import (_covmodel_key, _device_arrays, _dispatch_covmodel,
                         resolve_device, vecchia_likelihood)
from .prediction import (_check_mf, _numpy, _posterior_core,
                         vecchia_prediction)

__all__ = ["calculate_posterior_VL", "vecchia_laplace_likelihood",
           "vecchia_laplace_likelihood_from_posterior",
           "vecchia_laplace_prediction", "LIKELIHOOD_MODELS"]

_SQRT2PI_LOG = 0.5 * math.log(2.0 * math.pi)
_Z95 = 1.6448536269514722  # qnorm(0.95)


def _gauss_model(likparms):
    sigma = likparms.get("sigma", math.sqrt(0.1))

    return {
        "llh": lambda y, z: torch.sum(-0.5 * (z - y) ** 2 / sigma ** 2
                                      - math.log(sigma) - _SQRT2PI_LOG),
        "hess": lambda y, z: torch.full_like(y, 1.0 / sigma ** 2),
        "score": lambda y, z: (z - y) / sigma ** 2,
        "link": lambda y: y,
        "invalid": lambda z: False,
    }


def _logistic_model(likparms):
    return {
        "llh": lambda y, z: torch.sum(z * y - torch.logaddexp(
            y.new_zeros(()), y)),
        "hess": lambda y, z: torch.sigmoid(y) * torch.sigmoid(-y),
        "score": lambda y, z: z - torch.sigmoid(y),
        "link": torch.sigmoid,
        "invalid": lambda z: not np.all(np.isin(z, (0.0, 1.0))),
    }


def _poisson_model(likparms):
    return {
        "llh": lambda y, z: torch.sum(z * y - torch.exp(y)
                                      - torch.lgamma(z + 1.0)),
        "hess": lambda y, z: torch.exp(y),
        "score": lambda y, z: z - torch.exp(y),
        "link": torch.exp,
        "invalid": lambda z: bool(np.any(z < 0) or np.any(np.mod(z, 1) > 0)),
    }


def _gamma_model(likparms):
    # mean parameterization: E[z] = exp(y), fixed shape alpha
    a = likparms.get("alpha", 2.0)
    return {
        "llh": lambda y, z: torch.sum(
            -a * z * torch.exp(-y) + (a - 1) * torch.log(z) - a * y
            + a * math.log(a) - math.lgamma(a)),
        "hess": lambda y, z: a * z * torch.exp(-y),
        "score": lambda y, z: a * (z * torch.exp(-y) - 1.0),
        "link": torch.exp,
        "invalid": lambda z: bool(np.any(z <= 0)),
    }


def _gamma_alt_model(likparms):
    a = likparms.get("alpha", 2.0)
    return {
        "llh": lambda y, z: torch.sum(-torch.exp(y) * z
                                      + (a - 1) * torch.log(z) + a * y
                                      - math.lgamma(a)),
        "hess": lambda y, z: z * torch.exp(y),
        "score": lambda y, z: -z * torch.exp(y) + a,
        "link": lambda y: a / torch.exp(y),
        "invalid": lambda z: bool(np.any(z <= 0)),
    }


def _beta_model(likparms):
    b = likparms.get("beta", 0.5)
    digamma = torch.special.digamma

    def trigamma(x):
        return torch.special.polygamma(1, x)

    def hess(y, z):
        ey = torch.exp(y)
        t1 = torch.log(z) - digamma(ey * b) + digamma(b * (1 + ey))
        t2 = -trigamma(ey * b) + trigamma(b * (1 + ey))
        return -ey * b * t1 - (ey * b) ** 2 * t2

    def score(y, z):
        ey = torch.exp(y)
        return ey * b * (torch.log(z) - digamma(ey * b)
                         + digamma(b * (1 + ey)))

    def llh(y, z):
        ey = torch.exp(y)
        return torch.sum((ey * b - 1) * torch.log(z)
                         + (b - 1) * torch.log(1 - z)
                         - (torch.lgamma(b * ey) + math.lgamma(b)
                            - torch.lgamma(b * ey + b)))

    return {
        "llh": llh, "hess": hess, "score": score,
        "link": torch.sigmoid,
        "invalid": lambda z: bool(np.any(z < 0) or np.any(z > 1)),
    }


def _negbin_model(likparms):
    # the reference keeps negative-binomial as a non-functional stub
    # (R/vecchia_laplace_NR.R:327-336); kept here for surface parity
    raise NotImplementedError(
        "The negative-binomial likelihood is a stub in the reference "
        "(R/vecchia_laplace_NR.R:327-336) and is not implemented.")


LIKELIHOOD_MODELS = {
    "gaussian": _gauss_model,
    "logistic": _logistic_model,
    "poisson": _poisson_model,
    "gamma": _gamma_model,
    "gamma_alt": _gamma_alt_model,
    "beta": _beta_model,
    "negbinomial": _negbin_model,
}


def _vl_posterior_fn(spec, model, covmodel, obs_mask, device, dtype):
    """The NR solve run(z_obs, covparms, y0, prior_obs, max_iter, convg) ->
    (y, delta, iters, bad, pseudo_full, nug_full, D, mu_obs), all tensors on
    ``device`` but the Python numbers delta, iters and bad."""
    plan = get_plan(spec)
    _check_mf(plan, "Vecchia-Laplace")
    kernel_fn, covmat = _dispatch_covmodel(spec, covmodel, device, dtype)
    dev = _device_arrays(plan, device, dtype)
    obs_mask_t = torch.as_tensor(obs_mask, device=device)
    obs_idx = torch.as_tensor(np.flatnonzero(obs_mask), device=device)
    ord_t = torch.as_tensor(spec.ord, device=device)
    n_obs_locs = plan.n_obs
    n_locs = spec.ord.shape[0]
    hess, score = model["hess"], model["score"]

    def mu_obs_from(p_full, nug_full, covparms):
        mu_ord, _ = _posterior_core(plan, dev, p_full, covparms, nug_full,
                                    kernel_fn, covmat)
        mu = mu_ord.new_zeros(n_locs).index_put((ord_t,), mu_ord)
        return mu[:n_obs_locs]

    def pseudo_of(y, z_obs, prior_obs):
        D = 1.0 / hess(y, z_obs)
        p_obs = D * score(y, z_obs) + y - prior_obs
        # NA handling as in removeNAs: mean fill + inflated nuggets
        pm = torch.mean(p_obs)
        pv = torch.var(p_obs) * 1e8
        full = p_obs.new_zeros(n_obs_locs)
        p_full = torch.where(obs_mask_t, full.index_put((obs_idx,), p_obs),
                             pm)
        nug_full = torch.where(obs_mask_t, full.index_put((obs_idx,), D), pv)
        return p_full, nug_full, D

    def run(z_obs, covparms, y0, prior_obs, max_iter, convg):
        with torch.no_grad():
            y, delta, it, bad = y0, math.inf, 0, False
            while it < max_iter:
                p_full, nug_full, _ = pseudo_of(y, z_obs, prior_obs)
                y_new = mu_obs_from(p_full, nug_full, covparms)[obs_idx] \
                    + prior_obs
                # the loop's one host read: the step, for the stop rules
                delta = float(torch.max(torch.abs(y_new - y)))
                it += 1
                bad = math.isnan(delta)
                if bad:
                    break
                y = y_new
                if not delta >= convg:
                    break
            p_full, nug_full, D = pseudo_of(y, z_obs, prior_obs)
            mu_obs = mu_obs_from(p_full, nug_full, covparms)
        return y, delta, it, bad, p_full, nug_full, D, mu_obs

    return run


def _link_np(link, x):
    return _numpy(link(torch.as_tensor(np.asarray(x, np.float64))))


def calculate_posterior_VL(z, spec, likelihood_model, covparms,
                           covmodel="matern", likparms=None, max_iter=50,
                           convg=1e-6, return_all=False, y_init=None,
                           prior_mean=None, verbose=False, *, device="cuda",
                           dtype=torch.float64):
    """Latent posterior under a non-Gaussian likelihood by Vecchia–Laplace
    Newton–Raphson (R/vecchia_laplace_NR.R:31-155).

    Returns a dict with the posterior "mean" (numpy, at the observed
    locations), "cnvgd", "iter" and "runtime" (seconds, compilation of the
    kernels included on a first call), the pseudo-data "t" and
    pseudo-nuggets "D", and what the likelihood and prediction below need.
    Runs on the card unless ``device`` says otherwise.
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    likparms = dict(likparms or {"alpha": 2.0, "sigma": math.sqrt(0.1)})
    if isinstance(covmodel, str) and covmodel == "matern" \
            and len(covparms) != 3:
        raise ValueError(f"Matern kernel requires 3 parameters but "
                         f"{len(covparms)} were passed")
    model = LIKELIHOOD_MODELS[likelihood_model](likparms)

    z = np.asarray(z, np.float64)
    obs_mask = ~np.isnan(z)
    z_obs = z[obs_mask]
    if model["invalid"](z_obs):
        raise ValueError("Data invalid for likelihood type. Make sure that "
                         "your data lies in the support of the likelihood "
                         "function.")
    if prior_mean is None:
        prior_mean = np.zeros(len(z))
    prior_mean = np.broadcast_to(np.asarray(prior_mean, np.float64), z.shape)
    prior_obs = prior_mean[obs_mask]

    plan = get_plan(spec)
    key = ("vl", likelihood_model, _covmodel_key(covmodel),
           tuple(sorted(likparms.items())), obs_mask.tobytes(), str(device),
           dtype)
    run = plan.cache.get(key)
    if run is None:
        run = _vl_posterior_fn(spec, model, covmodel, obs_mask, device, dtype)
        plan.cache[key] = run

    if y_init is None or np.any(np.isnan(np.atleast_1d(y_init))):
        y0 = prior_obs.copy()
    else:
        y0 = np.broadcast_to(np.asarray(y_init, np.float64), z.shape)[obs_mask]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)

    # covparms stay on the host: the kernels read them there, and a copy on
    # the device would be read back every iteration
    y, delta, iters, bad, p_full, nug_full, D, mu_obs = run(
        t(z_obs), torch.as_tensor(np.asarray(covparms, np.float64)), t(y0),
        t(prior_obs), max_iter, convg)
    if bad:
        print(f"VL-NR hit NA on iteration {iters}, convergence failed.")

    p_full = _numpy(p_full)
    pseudo = np.full(len(z), np.nan)
    pseudo[obs_mask] = p_full[obs_mask]
    out = {
        "mean": _numpy(mu_obs) + prior_mean,
        "cnvgd": bool(delta < convg), "iter": iters,
        "t": pseudo + prior_mean, "D": _numpy(D), "y": _numpy(y),
        "pseudo_full": p_full, "nug_full": _numpy(nug_full),
        "data_link": model["link"], "model_llh": model["llh"],
        "prior_mean": prior_mean, "obs_mask": obs_mask,
        "likelihood_model": likelihood_model, "likparms": likparms,
    }
    out["runtime"] = time.perf_counter() - t0
    if return_all:
        preds = vecchia_prediction(out["pseudo_full"], spec, covparms,
                                   out["nug_full"], covmodel=covmodel,
                                   return_values="meanmat", device=device,
                                   dtype=dtype)
        out["prediction"] = preds
        out["V"] = preds["V"]
    return out


def vecchia_laplace_likelihood(z, spec, likelihood_model, covparms,
                               likparms=None, covmodel="matern", max_iter=50,
                               convg=1e-5, return_all=False, y_init=None,
                               prior_mean=None, spec_iw=None, *,
                               device="cuda", dtype=torch.float64):
    """Marginal log-likelihood under the Vecchia–Laplace approximation:
    pseudo-marginal Vecchia log-likelihood - pseudo conditional
    log-likelihood + true data log-likelihood (R/vecchia_laplace_NR.R:
    396-409); -inf with a warning when the NR solve does not converge."""
    post = calculate_posterior_VL(z, spec, likelihood_model, covparms,
                                  covmodel, likparms, max_iter, convg,
                                  False, y_init, prior_mean, device=device,
                                  dtype=dtype)
    if not post["cnvgd"]:
        warnings.warn("Convergence Failed, returning -Inf")
        return -np.inf
    return vecchia_laplace_likelihood_from_posterior(
        z, post, spec, covparms, covmodel=covmodel, spec_iw=spec_iw,
        device=device, dtype=dtype)


def vecchia_laplace_likelihood_from_posterior(z, post, spec, covparms,
                                              covmodel="matern", spec_iw=None,
                                              *, device="cuda",
                                              dtype=torch.float64):
    """The marginal VL log-likelihood from an existing posterior.  A
    zy-family spec is re-specified interweaved on the observed locations
    (an SGV spec, R/vecchia_laplace_NR.R:390-395) unless ``spec_iw`` is
    given."""
    z = np.asarray(z, np.float64)
    obs_mask = post["obs_mask"]
    prior_mean = post["prior_mean"]
    z_pseudo = post["t"] - prior_mean
    D = post["D"]
    nug_pseudo = np.full(len(z), np.nan)
    nug_pseudo[obs_mask] = D

    if spec_iw is None:
        spec_iw = spec
        if spec.cond_yz in ("zy", "RVP", "LK"):
            # the reference collapses RVP/LK into cond.yz='zy'
            # (R/vecchia_specify.R:224), so its rewrite fires for all three
            locs = np.empty((spec.n_obs, spec.locsord.shape[1]))
            locs[spec.ord_z] = spec.locsord[:spec.n_obs]
            spec_iw = vecchia_specify(locs, spec.m)

    pseudo_marg = vecchia_likelihood(z_pseudo, spec_iw, covparms,
                                     np.where(obs_mask, nug_pseudo, 1.0),
                                     covmodel, device=device, dtype=dtype)
    mean_obs = post["mean"]
    true_llh = float(post["model_llh"](torch.as_tensor(mean_obs[obs_mask]),
                                       torch.as_tensor(z[obs_mask])))
    resid = z_pseudo[obs_mask] - (mean_obs[obs_mask] - prior_mean[obs_mask])
    pseudo_cond = float(np.sum(
        -0.5 * resid ** 2 / D - 0.5 * np.log(D) - _SQRT2PI_LOG))
    return pseudo_marg - pseudo_cond + true_llh


def vecchia_laplace_prediction(vl_posterior, spec, covparms, pred_mean=0.0,
                               var_exact=False, covmodel="matern",
                               return_values="all", *, device="cuda",
                               dtype=torch.float64):
    """Prediction from the VL pseudo-data, also through the data link, with
    the 95 % quantiles (R/vecchia_laplace_NR.R:523-551); ``spec`` is a
    specification with the prediction locations."""
    z_pseudo = vl_posterior["t"] - vl_posterior["prior_mean"]
    nug = np.full(len(z_pseudo), np.nan)
    nug[vl_posterior["obs_mask"]] = vl_posterior["D"]
    preds = vecchia_prediction(z_pseudo, spec, covparms, nug,
                               var_exact=var_exact, covmodel=covmodel,
                               return_values=return_values, device=device,
                               dtype=dtype)
    link = vl_posterior["data_link"]
    mu_pred = preds["mu_pred"] + pred_mean
    mu_obs = preds["mu_obs"] + vl_posterior["prior_mean"]
    out = dict(preds)
    out["mu_pred"] = mu_pred
    out["mu_obs"] = mu_obs
    out["data_pred"] = _link_np(link, mu_pred)
    out["data_obs"] = _link_np(link, mu_obs)
    if preds.get("var_pred") is not None:
        sd_p = np.sqrt(preds["var_pred"])
        sd_o = np.sqrt(preds["var_obs"])
        out["data_pred_upper_quantile"] = _link_np(link, mu_pred + _Z95 * sd_p)
        out["data_pred_lower_quantile"] = _link_np(link, mu_pred - _Z95 * sd_p)
        out["data_obs_upper_quantile"] = _link_np(link, mu_obs + _Z95 * sd_o)
        out["data_obs_lower_quantile"] = _link_np(link, mu_obs - _Z95 * sd_o)
    return out
