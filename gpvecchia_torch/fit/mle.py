"""Covariance-parameter estimation by Vecchia MLE (``vecchia_estimate``),
and prediction with the estimate (``vecchia_pred``).

The port of the JAX package's ``fit/mle.py`` (GPvecchia
R/vecchia_wrappers.R:28-131): trend handling, the theta.ini heuristic, and
optimization on log-parameters with L-BFGS-B (the default; value and
gradient from ``torch.autograd`` through the port's likelihood), Adam
(``torch.optim.Adam``, lr 1e-2, the same rule as optax's default Adam) or
Nelder-Mead (value only, the reference's optimizer).  The likelihood runs on
``device``, the card unless the caller asks for the CPU; the parameters stay
float64 on the host, where the optimizers work.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy.optimize import minimize
from scipy.spatial.distance import pdist

from ..inference.likelihood import loglik_fn, resolve_device
from ..inference.prediction import vecchia_prediction
from ..spec import vecchia_specify
from ..utils import trace

__all__ = ["vecchia_estimate", "vecchia_pred"]


def _detrend(data, X):
    """Constant / user-X / no trend (R/vecchia_wrappers.R:32-52)."""
    data = np.asarray(data, np.float64)
    if X is None:
        return data, np.empty(0), "none"
    if isinstance(X, str) and X == "constant":
        beta = np.array([np.nanmean(data)])
        return data - beta[0], beta, "constant"
    X = np.asarray(X, np.float64)
    beta = np.linalg.solve(X.T @ X, X.T @ data)
    return data - X @ beta, beta, "userspecified"


def _theta_ini(z, locs):
    """Default initial parameters (R/vecchia_wrappers.R:59-67)."""
    var_res = np.nanvar(z, ddof=1)
    n = len(z)
    rng = np.random.default_rng(0)
    sub = locs[rng.choice(n, size=min(n, 300), replace=False)]
    mean_dist = pdist(sub).mean()
    return np.array([0.9 * var_res, mean_dist / 4.0, 0.8, 0.1 * var_res])


def neg_loglik_fn(spec, z, n_par, covmodel="matern", *, device="cuda",
                  dtype=torch.float64):
    """The estimation objective: lg (float64 tensor of log-parameters,
    covparms then the nugget) -> minus the log-likelihood, differentiable
    in lg.  The nugget is broadcast to a vector of n_obs."""
    fn = loglik_fn(spec, covmodel, device=device, dtype=dtype)
    zt = torch.as_tensor(np.asarray(z, np.float64)).to(device, dtype)

    def neg_loglik(lg):
        theta = torch.exp(lg)
        nugs = theta[n_par - 1].expand(spec.n_obs)
        return -fn(zt, theta[:n_par - 1], nugs)

    return neg_loglik


def vecchia_estimate(data, locs, X="constant", m=20, covmodel="matern",
                     theta_ini=None, method="lbfgs", max_iter=300,
                     reltol=None, output_level=1, *, device="cuda",
                     dtype=torch.float64, **specify_kwargs):
    """Estimate trend and covariance parameters by Vecchia MLE.

    method: 'lbfgs' (autograd gradients, default), 'adam', or
    'nelder-mead' (gradient-free, the reference's optimizer).  ``device``
    and ``dtype`` are the likelihood's.  Returns dict(z, beta_hat,
    theta_hat, trend, locs, covmodel, spec, n_iter, converged, loglik).
    """
    device = resolve_device(device)
    locs = np.asarray(locs, np.float64)
    z, beta_hat, trend = _detrend(data, X)
    spec = vecchia_specify(locs, m, **specify_kwargs)

    is_matern = isinstance(covmodel, str) and covmodel == "matern"
    if theta_ini is None:
        if not is_matern:
            raise ValueError("theta_ini must be given for non-matern models")
        theta_ini = _theta_ini(z, locs)
    theta_ini = np.asarray(theta_ini, np.float64)
    n_par = len(theta_ini)
    neg_loglik = neg_loglik_fn(spec, z, n_par, covmodel, device=device,
                               dtype=dtype)

    def value(lg):
        with torch.no_grad():
            return float(trace.sync(neg_loglik(
                torch.as_tensor(lg, dtype=torch.float64))))

    if method == "nelder-mead":
        def f(lg):
            if is_matern and np.exp(lg[2]) > 10:
                raise RuntimeError(
                    "The default optimization routine to find parameters did "
                    "not converge. Try writing your own optimization.")
            return value(lg)

        tol = 1e-8 if reltol is None else reltol
        res = minimize(f, np.log(theta_ini), method="Nelder-Mead",
                       options={"maxiter": max_iter, "xatol": tol,
                                "fatol": tol})
        lg_hat, n_iter, converged = res.x, res.nit, res.success
    elif method == "lbfgs":
        def fg(lg):
            lgt = torch.tensor(lg, dtype=torch.float64, requires_grad=True)
            v = neg_loglik(lgt)
            (g,) = torch.autograd.grad(v, lgt)
            v, g = float(trace.sync(v).detach()), g.numpy()
            if not np.isfinite(v):
                return 1e10, np.zeros_like(g)
            return v, np.where(np.isfinite(g), g, 0.0)

        bounds = None
        if is_matern:
            bounds = [(None, None)] * n_par
            bounds[2] = (np.log(0.05), np.log(10.0))  # smoothness guard
        res = minimize(fg, np.log(theta_ini), jac=True, method="L-BFGS-B",
                       bounds=bounds, options={"maxiter": max_iter})
        lg_hat, n_iter, converged = res.x, res.nit, res.success
    elif method == "adam":
        lg = torch.tensor(np.log(theta_ini), requires_grad=True)
        opt = torch.optim.Adam([lg], lr=1e-2)
        last = np.inf
        n_iter = 0
        for i in range(max_iter):
            opt.zero_grad()
            v = neg_loglik(lg)
            v.backward()
            opt.step()
            n_iter = i + 1
            v = float(trace.sync(v).detach())
            if abs(v - last) < 1e-9 * (abs(last) + 1):
                break
            last = v
        lg_hat, converged = lg.detach().numpy().copy(), True
    else:
        raise ValueError(f"unknown method '{method}'")

    theta_hat = np.exp(lg_hat)
    if output_level > 0:
        print("estimated trend coefficients:", beta_hat)
        print("estimated covariance parameters:", theta_hat)
    return {"z": z, "beta_hat": beta_hat, "theta_hat": theta_hat,
            "trend": trend, "locs": locs, "covmodel": covmodel,
            "spec": spec, "n_iter": n_iter, "converged": bool(converged),
            "loglik": -value(np.log(theta_hat))}


def vecchia_pred(vecchia_est, locs_pred, X_pred=None, m=30, *, device="cuda",
                 dtype=torch.float64, **specify_kwargs):
    """Predictions with estimated parameters (R/vecchia_wrappers.R:134-161).

    The default spec with prediction points (cond_yz 'zy', the obspred
    ordering) runs the per-entry V factor's direct mode, with exact
    prediction variances; ``specify_kwargs`` pass any other spec to
    ``vecchia_specify``.
    """
    locs_pred = np.asarray(locs_pred, np.float64)
    spec = vecchia_specify(vecchia_est["locs"], m, locs_pred=locs_pred,
                           **specify_kwargs)
    theta = vecchia_est["theta_hat"]
    preds = vecchia_prediction(vecchia_est["z"], spec, theta[:-1], theta[-1],
                               covmodel=vecchia_est["covmodel"],
                               device=device, dtype=dtype)
    trend = vecchia_est["trend"]
    if X_pred is not None:
        mu_pred = preds["mu_pred"] + np.asarray(X_pred) @ vecchia_est["beta_hat"]
    elif trend == "none":
        mu_pred = preds["mu_pred"]
    elif trend == "constant":
        mu_pred = preds["mu_pred"] + vecchia_est["beta_hat"][0]
    else:
        warnings.warn("X_pred was not specified, so no trend was added back "
                      "to the predictions")
        mu_pred = preds["mu_pred"]
    return {"mean_pred": mu_pred, "var_pred": preds["var_pred"]}
