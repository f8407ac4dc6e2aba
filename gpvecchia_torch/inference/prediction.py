"""Vecchia posterior prediction, in PyTorch.

The port of the JAX package's ``inference/prediction.py``.  The posterior
precision W = U_y U_y^T + D is factored by the likelihood's engine for the
plan (H1 or H8 for the U entries in both):

* ``use_mf`` plans: the multifrontal chain (H2-H4), kept
  (``linalg.multifrontal.MFFactor``).  The posterior mean is -W^{-1} z2,
  the factor's own forward solve riding the tree as its augmented row, so
  one back-substitution remains; the variances are diag(W^{-1}) by the
  top-down selected inverse.
* every other plan (the zy family, obspred specs, IC0): the per-entry V
  factor (``likelihood.compute_v_factor``), its values a tensor in the
  plan's physical layout.  The mean is two level-scheduled solves, the
  variances the Takahashi selected inverse on V's pattern
  (``linalg/selinv.py``), and the exact prediction variances of obspred
  specs ||V^{-1} e_i||^2 by forward solves in chunks of 1024 right-hand
  sides (GPvecchia R/vecchia_prediction.R:224-244).

``vecchia_lincomb`` and ``V2covmat`` solve with either factor.  The entry
points run on the card (``device="cuda"``) unless the caller asks for
another device; without a visible CUDA device they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.u_entries import u_entries
from ..linalg.multifrontal import (MFFactor, mf_backward, mf_factor_keep,
                                   mf_forward, mf_selinv_diag, mf_solve)
from ..linalg.selinv import (build_selinv_levels, device_selinv_levels,
                             selected_inverse)
from ..linalg.trisolve import backward_solve, forward_solve
from ..plan import ensure_v, get_plan
from .likelihood import (_covmodel_key, _device_arrays, _dispatch_covmodel,
                         _local_cov, compute_v_factor, mf_inputs,
                         resolve_device, z2_of, zero_nugget_variant)

__all__ = ["vecchia_prediction", "vecchia_lincomb", "V2covmat"]

# right-hand sides of one chunk of the exact prediction variances, as in
# the JAX package, fewer where one chunk's solve workspace (x, b and a
# level's gathered rows, per right-hand side) would pass EXACT_BYTES
EXACT_CHUNK = 1024
EXACT_BYTES = 1 << 32


def _posterior_core(plan, dev, z, covparms, nuggets,
                    cov=(None, None, None), share=None):
    """(mu, factor) for tensors ``z`` and ``nuggets`` (n_obs,) in original
    observation order on the plan's device; no NA handling (the callers
    fill).  On a ``use_mf`` plan mu is over the ordered points and the
    factor the kept ``MFFactor``; on a V plan mu is over the latent
    variables in the ordered sequence and the factor V's values.  With
    ``share`` (``parallel.mesh.RowShare``, a multifrontal plan) ``dev`` is
    a rank's share: the rank computes its rows' U entries and its levels,
    and mu comes back whole on every rank."""
    dtype = dev["locs"].dtype
    if not torch.is_tensor(covparms):
        covparms = torch.as_tensor(np.array(covparms, dtype=np.float64))
    covparms = covparms.to(dtype)
    nug_ord = nuggets[dev["ord_z"]]
    nug_point = torch.zeros(plan.n_all, dtype=dtype, device=z.device)
    nug_point = nug_point.index_put((dev["obs_points"],), nug_ord)
    col, bad = u_entries(dev["locs"], dev["NN"], dev["valid"], dev["cond"],
                         nug_point, covparms, *_local_cov(dev, cov))
    # a dropped (non-SPD) row adds nothing to W, as in the likelihood
    col_w = torch.where(bad[:, None], 0.0, col)
    zord = z[dev["ord_z"]]
    z1L = torch.sum(torch.where(dev["nb_resp"],
                                col * zord[dev["nb_obs_pos"]], 0.0), dim=1)
    z1L = torch.where(dev["has_col"], z1L, 0.0)
    if not plan.use_mf:
        # mean = -V^{-T} V^{-1} rev(z2), over the latent variables in the
        # ordered sequence; the factor is V's values
        nug_safe = torch.where(dev["zero_obs"], 1.0, nug_ord)
        z2 = z2_of(dev, col_w, z1L, zord / torch.sqrt(nug_safe), nug_safe)
        v = compute_v_factor(plan, dev, col_w, nug_ord)
        temp = forward_solve(v, z2.flip(0), dev["fwd"], dev["fwd_x_perm"])
        mu_rev = backward_solve(v, temp, dev["bwd"], dev["bwd_x_perm"])
        return -mu_rev.flip(0), v
    u_elem, dvec, rhs_vert = mf_inputs(dev, col_w, zord, nug_ord)
    fac = mf_factor_keep(dev["mf"], u_elem, dvec, z1L, rhs_vert, share)
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

    mean_fn(z, covparms, nuggets) -> (mu, factor) (``_posterior_core``);
    var_fn(factor) -> the posterior variances, over the same points as
    mu."""
    plan = get_plan(spec)
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
            if not plan.use_mf:
                z = selected_inverse(fac, _selinv_levels(plan, device),
                                     plan.v_phys_size)
                return z[dev["v_diag_slots"]].flip(0)
            d = mf_selinv_diag(fac)
            if "known_pt" in dev:
                # exact observations have zero posterior variance
                d = d.new_zeros(plan.n_all).index_put((dev["vert_pt"],), d)
            return d

    plan.cache[key] = (mean_fn, var_fn)
    return plan.cache[key], plan


def _selinv_levels(plan, device):
    """The selected inverse's level maps on ``device`` (cached on the
    plan; the host maps once per plan)."""
    key, host = ("selinv_levels", str(device)), ("selinv_levels",)
    if key not in plan.cache:
        if host not in plan.cache:
            plan.cache[host] = build_selinv_levels(ensure_v(plan))
        plan.cache[key] = device_selinv_levels(plan.cache[host], device)
    return plan.cache[key]


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
    0).  On an obspred spec with prediction points, ``var_exact`` (by
    default when there are fewer than 2e5 prediction points) takes the
    prediction variances by exact solves; the other variances are the
    selected inverse's.  Runs on the card unless ``device`` says
    otherwise.
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
        if var_exact is None:
            # the chunked solves keep memory bounded, so the exact path is
            # the default well past the reference's 4e4 threshold
            var_exact = spec.n_pred < 2e5
        var_obs, var_pred = _extract(
            spec, _numpy(var_fn(fac)),
            0.0 if known_mu is None else np.zeros_like(known_mu))
        if var_exact and spec.ordering_pred == "obspred" and spec.n_pred > 0:
            # the exact path recomputes the prediction variances by solves;
            # the observed ones stay the selected inverse's, as in the
            # reference (R/vecchia_prediction.R:224-244)
            var_pred = _exact_pred_vars(spec, plan, fac)
        out["var_obs"] = var_obs
        out["var_pred"] = var_pred
    return out


def _exact_pred_vars(spec, plan, v):
    """Exact prediction variances ||V^{-1} e_rev(i)||^2 (the identity
    lincomb, R/vecchia_prediction.R:164-178) of the prediction latents, in
    original prediction order, by forward solves of ``EXACT_CHUNK``
    right-hand sides at a time (fewer if that chunk's workspace would pass
    ``EXACT_BYTES``)."""
    n = plan.n_lat
    # ordered-sequence positions of the prediction points -> latent ranks
    # -> reversed positions (ranks shift when the zero-nugget variant
    # removes known latents, so go through latent_rank)
    pred_seq = np.flatnonzero(spec.ord >= spec.n_obs)
    off = spec.n_all - spec.ord.shape[0]
    ranks = spec.latent_rank[pred_seq + off]
    assert np.all(ranks >= 0)
    rev_pos = torch.as_tensor(n - 1 - ranks, device=v.device)
    solve = _device_arrays(plan, v.device, v.dtype)["fwd"]
    widest = max((max(nreal) * rslots.shape[-1]
                  for _, _, rslots, _, _, nreal in solve.blocks), default=0)
    per_rhs = (solve.x_size + solve.zx + n + 2 * widest) * v.element_size()
    chunk = max(1, min(EXACT_CHUNK, EXACT_BYTES // per_rhs))
    npred = rev_pos.numel()
    out = []
    with torch.no_grad():
        for s in range(0, npred, chunk):
            rp = rev_pos[s:s + chunk]
            b = v.new_zeros(n, rp.numel())
            b[rp, torch.arange(rp.numel(), device=v.device)] = 1.0
            x = forward_solve(v, b, solve)
            out.append(torch.sum(x * x, dim=0))
    var = np.empty(spec.n_pred)
    var[spec.ord[pred_seq] - spec.n_obs] = _numpy(torch.cat(out)) \
        if out else np.empty(0)
    return var


def _mf_factor_of(spec, V, what):
    """The plan of ``spec`` after checking that ``V`` is a multifrontal
    factor of it with every latent free."""
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


def _v_factor_of(spec, V):
    """(plan with its V machinery, V's values as a tensor) after checking
    that ``V`` (a tensor or an array) has the plan's physical V size."""
    plan = ensure_v(get_plan(spec))
    v = V if torch.is_tensor(V) else torch.as_tensor(np.asarray(V,
                                                                np.float64))
    if v.shape != (plan.v_phys_size,):
        raise ValueError(
            f"V has shape {tuple(v.shape)}, this spec's plan holds "
            f"{plan.v_phys_size} V values (was it produced under another "
            "spec?)")
    return plan, v


def vecchia_lincomb(H, spec, V, cov_mat=False):
    """Variance (or covariance matrix) of H @ y under the posterior
    (R/vecchia_prediction.R:164-178): ||L^{-1} h||^2 = h^T W^{-1} h, which
    does not depend on the factor's ordering.

    H: (k, n_locs) dense or scipy-sparse over the stacked original ordering
    [obs; pred]; V: the factor ``vecchia_prediction`` returned (an
    ``MFFactor``, or the per-entry V's values).
    """
    H = np.asarray(H.todense()) if hasattr(H, "todense") else np.asarray(H)
    if isinstance(V, MFFactor):
        _mf_factor_of(spec, V, "vecchia_lincomb")
        # columns -> latent rank order
        Hv = torch.as_tensor(np.ascontiguousarray(H[:, spec.ord].T)).to(
            V.device, V.dtype)
        with torch.no_grad():
            ys, _ = mf_forward(V, Hv)
            temp = torch.cat([y.reshape(-1, Hv.shape[1]) for y in ys]).mT
    else:
        plan, v = _v_factor_of(spec, V)
        # columns -> reversed latent order; x stays in the physical layout
        # (its pads are 0)
        Ht = torch.as_tensor(np.ascontiguousarray(H[:, spec.ord[::-1]].T))
        with torch.no_grad():
            temp = forward_solve(
                v, Ht.to(v.device, v.dtype),
                _device_arrays(plan, v.device, v.dtype)["fwd"]).mT
    with torch.no_grad():
        if cov_mat:
            return _numpy(temp @ temp.mT)
        return _numpy(torch.sum(temp * temp, dim=1))


def V2covmat(spec, V):
    """Dense joint posterior covariance (diagnostics; small n only;
    R/vecchia_prediction.R:265-288): W^{-1} by column solves with an
    ``MFFactor``, else (V V^T)^{-1} from the per-entry V made dense."""
    if isinstance(V, MFFactor):
        plan = _mf_factor_of(spec, V, "V2covmat")
        with torch.no_grad():
            eye = torch.eye(plan.n_lat, dtype=V.dtype, device=V.device)
            Sigma_ord = _numpy(mf_solve(V, eye))
    else:
        plan, v = _v_factor_of(spec, V)
        n = plan.n_lat
        cp = plan.v_colptr
        vf = _numpy(v)[plan.v_perm]          # physical -> logical col-major
        Vd = np.zeros((n, n))
        Vd[plan.v_rows, np.repeat(np.arange(n), np.diff(cp))] = vf
        Sigma_ord = np.linalg.inv(Vd @ Vd.T)[::-1, ::-1]
    out = np.empty((spec.ord.size, spec.ord.size))
    out[np.ix_(spec.ord, spec.ord)] = Sigma_ord
    n_obs = spec.n_obs
    return {"Sigma_obs": out[:n_obs, :n_obs],
            "Sigma_pred": out[n_obs:, n_obs:]}
