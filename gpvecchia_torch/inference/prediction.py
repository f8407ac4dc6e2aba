"""Vecchia posterior prediction through the multifrontal factor, in PyTorch.

The port of the JAX package's ``inference/prediction.py`` for specs whose
plan has ``use_mf`` (cond_yz y/z/SGV/SGVT, without prediction points or
with ``ordering_pred="general"``).  The posterior precision W = U_y U_y^T +
D is factored by the same multifrontal chain as the likelihood (H1 for the
U entries, H2-H4 for the factor), kept (``linalg.multifrontal.MFFactor``),
and then

* the posterior mean is -W^{-1} z2: the factor's own forward solve rides
  the tree as its augmented row, so one back-substitution remains;
* the variances are diag(W^{-1}) by the top-down selected inverse;
* ``vecchia_lincomb`` and ``V2covmat`` solve with the same factor.

Other modes (obspred, the zy family, IC0), and with them the obspred-only
exact prediction variances, raise ``NotImplementedError``.  The entry
points run on the card (``device="cuda"``) unless the caller asks for
another device; without a visible CUDA device they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.u_entries import u_entries
from ..linalg.multifrontal import (MFFactor, mf_backward, mf_factor_keep,
                                   mf_forward, mf_selinv_diag, mf_solve)
from ..plan import get_plan
from .likelihood import (_covmodel_key, _device_arrays, _dispatch_covmodel,
                         mf_inputs, resolve_device, zero_nugget_variant)

__all__ = ["vecchia_prediction", "vecchia_lincomb", "V2covmat"]


def _check_mf(plan, what="prediction"):
    if not plan.use_mf:
        raise NotImplementedError(
            f"{what} in mode {plan.mode!r} (ic0={plan.ic0}, {plan.n_lat} "
            "latent variables): only the multifrontal 'chol' mode is ported "
            "to gpvecchia_torch (obspred, the zy family, IC0 and their exact "
            "prediction variances: ROADMAP queue 1, item 6)")


def _posterior_core(plan, dev, z, covparms, nuggets,
                    cov=(None, None, None)):
    """(mu over the ordered points, the kept factor) for tensors ``z`` and
    ``nuggets`` (n_obs,) in original observation order on the plan's
    device; no NA handling (the callers fill)."""
    dtype = dev["locs"].dtype
    if not torch.is_tensor(covparms):
        covparms = torch.as_tensor(np.array(covparms, dtype=np.float64))
    covparms = covparms.to(dtype)
    nug_ord = nuggets[dev["ord_z"]]
    nug_point = torch.zeros(plan.n_all, dtype=dtype, device=z.device)
    nug_point = nug_point.index_put((dev["obs_points"],), nug_ord)
    col, bad = u_entries(dev["locs"], dev["NN"], dev["valid"], dev["cond"],
                         nug_point, covparms, *cov)
    # a dropped (non-SPD) row adds nothing to W, as in the likelihood
    col_w = torch.where(bad[:, None], 0.0, col)
    zord = z[dev["ord_z"]]
    z1L = torch.sum(torch.where(dev["nb_resp"],
                                col * zord[dev["nb_obs_pos"]], 0.0), dim=1)
    z1L = torch.where(dev["has_col"], z1L, 0.0)
    u_elem, dvec, rhs_vert = mf_inputs(dev, col_w, zord, nug_ord)
    fac = mf_factor_keep(dev["mf"], u_elem, dvec, z1L, rhs_vert)
    # mean = -W^{-1} z2 over the vertices (the latent ranks)
    mu_lat = -mf_backward(fac)
    if "known_pt" not in dev:
        # every ordered point is latent: rank order is the ordered sequence
        return mu_lat, fac
    # exact (zero-nugget) observations: the posterior mean is the datum
    mu = mu_lat.new_zeros(plan.n_all).index_put((dev["vert_pt"],), mu_lat)
    mu = mu.index_put((dev["known_pt"],), zord[dev["known_obs"]])
    return mu, fac


def _pred_fns(spec, covmodel, device, dtype):
    """((mean_fn, var_fn), plan), cached on the plan per covariance model
    (``_covmodel_key``: a matrix by its whole content), device and dtype.

    mean_fn(z, covparms, nuggets) -> (mu over the ordered points, factor);
    var_fn(factor) -> the posterior variances over the ordered points."""
    plan = get_plan(spec)
    _check_mf(plan)
    key = ("pred", _covmodel_key(covmodel), str(device), dtype)
    if key in plan.cache:
        return plan.cache[key], plan
    cov = _dispatch_covmodel(spec, covmodel, device, dtype)
    dev = _device_arrays(plan, device, dtype)

    def as_t(a):
        if not torch.is_tensor(a):
            a = torch.as_tensor(np.array(a, np.float64))
        return a.to(device, dtype)

    def mean_fn(z, covparms, nuggets):
        with torch.no_grad():
            return _posterior_core(
                plan, dev, as_t(z), covparms,
                as_t(nuggets).expand(plan.n_obs), cov)

    def var_fn(fac):
        with torch.no_grad():
            d = mf_selinv_diag(fac)
            if "known_pt" in dev:
                # exact observations have zero posterior variance
                d = d.new_zeros(plan.n_all).index_put((dev["vert_pt"],), d)
            return d

    plan.cache[key] = (mean_fn, var_fn)
    return plan.cache[key], plan


def _extract(spec, values_ord, known_vals=None):
    """Latent ordered-sequence values -> (obs part, pred part) in original
    order.  Takes one value per ordered location, or one per latent
    variable when the zero-nugget variant removed latents; then the known
    locations are filled from ``known_vals`` (aligned with
    np.flatnonzero(spec.known_pts))."""
    n = spec.n_obs
    n_locs = spec.ord.shape[0]
    values_ord = np.asarray(values_ord, dtype=np.float64)
    if values_ord.shape[0] != n_locs:
        off = spec.n_all - n_locs       # zy layout: latent twin of loc j is n+j
        vals = np.full(n_locs, np.nan)
        vals[spec.latent_point - off] = values_ord
        kn = np.flatnonzero(spec.known_pts)
        vals[kn - off] = known_vals
        values_ord = vals
    out = np.empty(n_locs, dtype=np.float64)
    out[spec.ord] = values_ord
    return out[:n], out[n:]


def _numpy(t):
    return t.detach().to("cpu", torch.float64).numpy()


def vecchia_prediction(z, spec, covparms, nuggets, var_exact=None,
                       covmodel="matern", return_values="all", *,
                       device="cuda", dtype=torch.float64):
    """Posterior mean and variance at the observed and prediction locations
    (GPvecchia R/vecchia_prediction.R:17-56).

    Returns a dict of numpy arrays mu_obs, mu_pred and (for 'meanvar' /
    'all') var_obs, var_pred; for 'meanmat' / 'all' also "V", the kept
    factor (an ``MFFactor``).  NA data are mean-filled with inflated
    nuggets; zero nuggets make exact observations (mean = datum, variance
    0).  ``var_exact`` picks the exact path of obspred specs, which is not
    ported: on the specs that run here the variances are the selected
    inverse's, which is exact for them.  Runs on the card unless ``device``
    says otherwise.
    """
    device = resolve_device(device)
    nuggets = np.broadcast_to(np.asarray(nuggets, np.float64), (spec.n_obs,))
    spec = zero_nugget_variant(spec, np.nan_to_num(nuggets, nan=1.0))
    (mean_fn, var_fn), plan = _pred_fns(spec, covmodel, device, dtype)
    z = np.asarray(z, np.float64)
    # NA handling: mean-fill with inflated nuggets (R/vecchia_likelihood.R:45-58)
    if np.any(np.isnan(z)):
        zv = np.nanvar(z, ddof=1) * 1e8
        nuggets = np.where(np.isnan(z), zv, nuggets)
        z = np.where(np.isnan(z), np.nanmean(z), z)

    known_mu = None
    if spec.known_pts is not None and spec.known_pts.any():
        kn = np.flatnonzero(spec.known_pts)
        known_mu = z[spec.ord_z][spec.obs_pos[spec.NNarray[kn, 0]]]
    mu_ord, fac = mean_fn(z, np.asarray(covparms, np.float64), nuggets)
    mu_obs, mu_pred = _extract(spec, _numpy(mu_ord), known_mu)
    out = {"mu_obs": mu_obs, "mu_pred": mu_pred,
           "var_obs": None, "var_pred": None, "V": None}
    if return_values in ("meanmat", "all"):
        out["V"] = fac
        out["_plan"] = plan
    if return_values in ("meanvar", "all"):
        var_obs, var_pred = _extract(
            spec, _numpy(var_fn(fac)),
            0.0 if known_mu is None else np.zeros_like(known_mu))
        out["var_obs"] = var_obs
        out["var_pred"] = var_pred
    return out


def _mf_factor_of(spec, V, what):
    """The plan of ``spec`` after checking that ``V`` is a multifrontal
    factor of it with every latent free."""
    if not isinstance(V, MFFactor):
        raise NotImplementedError(
            f"{what} takes the multifrontal factor of vecchia_prediction; "
            "the per-entry V factor is not ported (ROADMAP queue 1, item 6)")
    plan = get_plan(spec)
    if np.asarray(plan.known_pts).any():
        # a factor built under the zero-nugget variant spec has fewer
        # vertices and latent ranks that are no longer the ordered sequence
        raise NotImplementedError(
            f"{what} with a multifrontal factor requires all latents free "
            "(no zero-nugget/known points)")
    if V.n_vert != int(np.sum(plan.has_latent_pts)):
        raise ValueError(
            "multifrontal factor does not match this spec's plan "
            "(was it produced under a derived zero-nugget spec?)")
    return plan


def vecchia_lincomb(H, spec, V, cov_mat=False):
    """Variance (or covariance matrix) of H @ y under the posterior
    (R/vecchia_prediction.R:164-178): ||L^{-1} h||^2 = h^T W^{-1} h, which
    does not depend on the factor's ordering.

    H: (k, n_locs) dense or scipy-sparse over the stacked original ordering
    [obs; pred]; V: the factor ``vecchia_prediction`` returned.
    """
    _mf_factor_of(spec, V, "vecchia_lincomb")
    H = np.asarray(H.todense()) if hasattr(H, "todense") else np.asarray(H)
    Hv = torch.as_tensor(np.ascontiguousarray(H[:, spec.ord].T))
    with torch.no_grad():
        ys, _ = mf_forward(V, Hv)       # columns -> latent rank order
        temp = torch.cat([y.reshape(-1, Hv.shape[1]) for y in ys]).mT
        if cov_mat:
            return _numpy(temp @ temp.mT)
        return _numpy(torch.sum(temp * temp, dim=1))


def V2covmat(spec, V):
    """Dense joint posterior covariance, W^{-1} by column solves
    (diagnostics; small n only; R/vecchia_prediction.R:265-288)."""
    plan = _mf_factor_of(spec, V, "V2covmat")
    with torch.no_grad():
        eye = torch.eye(plan.n_lat, dtype=V.dtype, device=V.device)
        Sigma_ord = _numpy(mf_solve(V, eye))
    out = np.empty((spec.ord.size, spec.ord.size))
    out[np.ix_(spec.ord, spec.ord)] = Sigma_ord
    n_obs = spec.n_obs
    return {"Sigma_obs": out[:n_obs, :n_obs],
            "Sigma_pred": out[n_obs:, n_obs:]}
