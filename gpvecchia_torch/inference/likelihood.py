"""Gaussian Vecchia log-likelihood, 'chol' (multifrontal) mode, in PyTorch.

The port of the JAX package's ``inference/likelihood.py`` for specs whose
plan has ``use_mf`` (cond_yz in y/z/SGV/SGVT without prediction points),
plus the degenerate all-exact case (no latent variable left).  The
numerator comes from the U columns; the denominator from the multifrontal
factor of W = U_y U_y^T + D, whose RHS z2 = U_y z1 rides the tree as an
augmented row (``linalg/multifrontal.py``).  Other modes (obspred, the zy
family, IC0) raise ``NotImplementedError``.

The covariance model is any the JAX package takes (``_dispatch_covmodel``):
'matern' (closed-form smoothness on H1, any other on the packed path and
H8), 'esqe', a user callable of torch tensors over distances or location
pairs, or a full (n_all, n_all) covariance matrix over the ordered points.
The selected (n_all, m+1) matrix layout raises ``NotImplementedError``.

The entry points run on the card (``device="cuda"``) unless the caller asks
for another device; without a visible CUDA device they raise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import warnings

import numpy as np
import torch

from ..kernels.covariance import make_kernel_fn
from ..kernels.u_entries import u_entries
from ..linalg.multifrontal import mf_device_arrays, mf_factor
from ..plan import get_mf_plan, get_plan

__all__ = ["vecchia_likelihood", "loglik_fn", "zero_nugget_variant"]


def _device_arrays(plan, device, dtype):
    """Index tensors of the plan on ``device`` (cached per device/dtype)."""
    key = ("dev", str(device), dtype)
    if key in plan.cache:
        return plan.cache[key]

    def t(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

    dev = {
        "locs": t(plan.locs, dtype),
        "NN": t(plan.NN),
        "valid": t(plan.valid),
        "cond": t(plan.cond),
        "nb_resp": t(plan.nb_resp),
        "nb_obs_pos": t(plan.nb_obs_pos, torch.long),
        "obs_points": t(plan.obs_points, torch.long),
        "ord_z": t(plan.ord_z, torch.long),
        "has_col": t(plan.has_latent_pts | plan.known_pts),
        "zero_obs": t(plan.zero_obs),
    }
    if plan.use_mf:
        mfp, vert_obs = get_mf_plan(plan)
        dev["mf"] = mf_device_arrays(mfp, device)
        dev["vert_obs"] = t(vert_obs, torch.long)
        dev["vert_pt"] = t(np.flatnonzero(plan.has_latent_pts), torch.long)
        if plan.known_pts.any():
            # exact (zero-nugget) observations: their point and obs position
            kp = np.flatnonzero(plan.known_pts)
            dev["known_pt"] = t(kp, torch.long)
            dev["known_obs"] = t(plan.obs_pos[kp], torch.long)
    plan.cache[key] = dev
    return dev


def _prepare_pack(dev, z):
    """Data-dependent, parameter-free precomputation (cached per z): the
    NA-filled ordered observations, their neighbor gather and the NaN masks
    that drive the nugget-inflation NA handling."""
    isnan = torch.isnan(z)
    zm = torch.nanmean(z)
    n_ok = torch.sum(~isnan)
    zv = torch.nansum(torch.where(isnan, 0.0, (z - zm) ** 2)) / torch.clamp(
        n_ok - 1, min=1)
    zf = torch.where(isnan, zm, z)
    zord = zf[dev["ord_z"]]
    return dict(zord=zord, znb=zord[dev["nb_obs_pos"]],
                nan_ord=isnan[dev["ord_z"]], zv=zv)


def mf_inputs(dev, col, zord, nug_ord):
    """(u_elem, dvec, rhs_vert) of the factor of W = U_y U_y^T + D: D adds
    1/nugget at observed vertices and the RHS adds -zord/nugget there (the
    observation column)."""
    vo = dev["vert_obs"]
    obs_v = vo >= 0
    voc = vo.clamp(min=0)
    nug_v = torch.where(obs_v, nug_ord[voc], 1.0)
    dvec = torch.where(obs_v, 1.0 / nug_v, 0.0)
    rhs_vert = torch.where(obs_v, -zord[voc] / nug_v, 0.0)
    return torch.where(dev["cond"], col, 0.0), dvec, rhs_vert


def _mf_denominator(dev, col, z1L, zord, nug_ord):
    """(logdet W, z2^T W^{-1} z2)."""
    u_elem, dvec, rhs_vert = mf_inputs(dev, col, zord, nug_ord)
    return mf_factor(dev["mf"], u_elem, dvec, z1L, rhs_vert)


def _loglik_core(plan, dev, pack, covparms, nuggets, dtype, device,
                 kernel_fn=None, covmat=None):
    if not torch.is_tensor(covparms):
        covparms = torch.as_tensor(np.array(covparms, dtype=np.float64))
    covparms = covparms.to(dtype)
    if not torch.is_tensor(nuggets):
        nuggets = torch.as_tensor(np.array(nuggets, dtype=np.float64))
    nug_in = nuggets.to(device, dtype)

    # NA handling by nugget inflation (GPvecchia R/vecchia_likelihood.R:45-58)
    big = pack["zv"] * 1e8
    if nug_in.dim() == 0:
        nug_ord = torch.where(pack["nan_ord"], big, nug_in)
    else:
        nug_vec = nug_in.expand(plan.n_obs)
        nug_ord = torch.where(pack["nan_ord"], big, nug_vec[dev["ord_z"]])
    nug_point = torch.zeros(plan.n_all, dtype=dtype, device=device)
    nug_point = nug_point.index_put((dev["obs_points"],), nug_ord)

    col, bad = u_entries(dev["locs"], dev["NN"], dev["valid"], dev["cond"],
                         nug_point, covparms, kernel_fn, covmat)

    # z1 over U columns: regression columns gather the values of their
    # known-conditioned neighbors (response-conditioned, or exact latents)
    zord = pack["zord"]
    zero_obs = dev["zero_obs"]
    nug_safe = torch.where(zero_obs, 1.0, nug_ord)
    z1L = torch.sum(torch.where(dev["nb_resp"], col * pack["znb"], 0.0), dim=1)
    col_mask = dev["has_col"]
    z1L = torch.where(col_mask, z1L, 0.0)
    z1Z = torch.where(zero_obs, 0.0, zord / torch.sqrt(nug_safe))

    quad_num = torch.sum(z1L * z1L) + torch.sum(z1Z * z1Z)
    logdet_num = (-2.0 * torch.sum(torch.where(
        col_mask, torch.log(torch.where(col_mask, col[:, 0], 1.0)), 0.0))
        + torch.sum(torch.where(zero_obs, 0.0, torch.log(nug_safe))))

    # dropped (non-SPD) rows contribute nothing to W = U_y U_y^T
    col_w = torch.where(bad[:, None], 0.0, col)

    if plan.n_lat == 0:
        # every observation exact: no latent left, no denominator
        logdet_denom = quad_denom = torch.zeros((), dtype=dtype, device=device)
    else:
        logdet_w, quad_denom = _mf_denominator(dev, col_w, z1L, zord, nug_ord)
        logdet_denom = -logdet_w

    const = plan.n_obs * math.log(2.0 * math.pi)
    neg2 = logdet_num - logdet_denom + quad_num - quad_denom + const
    return -0.5 * neg2, {"n_dropped_rows": torch.sum(bad)}


def zero_nugget_variant(spec, nuggets):
    """Derived spec handling exact (zero-nugget) observations, if any.

    A zero-nugget point's latent equals its observation: it loses its free
    latent (a 'known' column) and neighbors condition on its response with
    a zero diagonal add (GPvecchia R/createU.R:83-86, 173-193).  Returns
    ``spec`` unchanged when no nugget is zero.
    """
    zero = np.asarray(nuggets) == 0.0
    if not zero.any():
        return spec
    if spec.cond_yz in ("zy", "RVP", "LK"):
        raise NotImplementedError(
            "zero nuggets on a zy-family spec are not ported "
            "(ROADMAP queue 1, per-entry V path)")
    key = ("zero_variant", zero.tobytes())

    def build():
        zero_by_pos = zero[spec.ord_z]
        obs_pos = spec.obs_pos
        is_zero = spec.has_obs & np.where(
            obs_pos >= 0, zero_by_pos[np.maximum(obs_pos, 0)], False)
        NN = spec.NNarray
        valid = NN >= 0
        zero_nb = np.where(valid, is_zero[np.maximum(NN, 0)], False)
        return dataclasses.replace(
            spec, cond_latent=spec.cond_latent & ~zero_nb,
            has_latent=spec.has_latent & ~is_zero,
            known_pts=is_zero, zero_obs_mask=zero_by_pos, _cache={})

    return spec.cached(key, build)


def _check_supported(plan):
    if plan.n_lat > 0 and not plan.use_mf:
        raise NotImplementedError(
            f"likelihood mode {plan.mode!r} (ic0={plan.ic0}): only the "
            "multifrontal 'chol' mode is ported to gpvecchia_torch (obspred, "
            "the zy family and IC0: ROADMAP queue 1, per-entry V path)")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gpvecchia_torch runs on the card by default, and no CUDA device "
            "is visible; pass device='cpu' to run on the CPU")
    return device


def _is_matrix(covmodel) -> bool:
    return isinstance(covmodel, np.ndarray) or (
        hasattr(covmodel, "shape") and not callable(covmodel))


def _as_array(covmodel) -> np.ndarray:
    if torch.is_tensor(covmodel):
        covmodel = covmodel.detach().cpu().numpy()
    return np.asarray(covmodel, np.float64)


def _dispatch_covmodel(spec, covmodel, device, dtype):
    """(kernel_fn, covmat): a kernel evaluator, or a full covariance matrix
    on ``device``."""
    if not _is_matrix(covmodel):
        return make_kernel_fn(covmodel), None
    arr = _as_array(covmodel)
    n_all, mp1 = spec.NNarray.shape
    if arr.shape == (n_all, n_all):
        return None, torch.as_tensor(arr).to(device, dtype)
    if arr.shape == (n_all, mp1):
        raise NotImplementedError(
            "the selected (n_all, m+1) covariance-matrix layout is not ported "
            "to gpvecchia_torch: it needs MRA's hierarchical conditioning "
            "(ROADMAP queue 1, item 7)")
    raise ValueError(
        f"covariance matrix shape {arr.shape} matches neither the full "
        f"({n_all},{n_all}) nor the selected ({n_all},{mp1}) layout")


def _covmodel_key(covmodel):
    """Cache key of a covariance model: a name as it is, a callable by
    identity, a matrix by identity and a digest of its whole content (its
    printed form abbreviates large matrices, so two matrices can print
    alike)."""
    if isinstance(covmodel, str):
        return ("name", covmodel)
    if not _is_matrix(covmodel):
        return ("callable", covmodel)
    arr = np.ascontiguousarray(_as_array(covmodel))
    return ("matrix", id(covmodel), arr.shape, _digest(arr))


def _digest(arr: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                           digest_size=16).hexdigest()


def zkey(z):
    """Cache key of the data z: a torch tensor by (id, data_ptr, version),
    so an in-place update changes it; anything else by id, shape, dtype and
    a digest of its whole content."""
    if torch.is_tensor(z):
        return ("t", id(z), z.data_ptr(), z._version)
    z = np.asarray(z)
    return ("a", id(z), z.shape, str(z.dtype), _digest(z))


def loglik_fn(spec, covmodel="matern", *, device="cuda",
              dtype=torch.float64, with_aux=False):
    """loglik(z, covparms, nuggets) -> 0-dim tensor on ``device`` (cached).

    with_aux=True returns (loglik, {"n_dropped_rows": count}).  The
    parameter-free data preparation is cached per z: a torch tensor is
    keyed on (id, data_ptr, version), so an in-place update invalidates
    it; a numpy array on a digest of its whole content.  The result is
    differentiable in covparms and nuggets (torch.autograd), whose
    gradients come back on their own devices and dtypes.
    """
    device = resolve_device(device)
    plan = get_plan(spec)
    _check_supported(plan)
    key = ("loglik", _covmodel_key(covmodel), str(device), dtype, with_aux)
    if key in plan.cache:
        return plan.cache[key]
    kernel_fn, covmat = _dispatch_covmodel(spec, covmodel, device, dtype)
    dev = _device_arrays(plan, device, dtype)
    zcache = {}

    def fn(z, covparms, nuggets):
        zk = zkey(z)
        if zcache.get("key") != zk:
            zt = torch.as_tensor(np.asarray(z) if not torch.is_tensor(z)
                                 else z).to(device, dtype)
            # ref pins z so that its id stays unique while it is the key
            zcache.update(key=zk, ref=z, pack=_prepare_pack(dev, zt))
        ll, aux = _loglik_core(plan, dev, zcache["pack"], covparms, nuggets,
                               dtype, device, kernel_fn, covmat)
        return (ll, aux) if with_aux else ll

    plan.cache[key] = fn
    return fn


def vecchia_likelihood(z, spec, covparms, nuggets, covmodel="matern", *,
                       device="cuda", dtype=torch.float64):
    """Gaussian Vecchia log-likelihood (float).

    ``z`` in original observation order, ``nuggets`` scalar or
    per-observation vector (GPvecchia R/vecchia_likelihood.R:14-27).
    Runs on the card unless ``device`` says otherwise.
    """
    device = resolve_device(device)
    if spec.cond_yz in ("zy", "RVP", "LK"):
        warnings.warn("cond.yz='zy' will produce a poor likelihood "
                      "approximation. Use 'SGV' instead.")
    nug = np.asarray(nuggets, dtype=np.float64)
    spec = zero_nugget_variant(spec, np.broadcast_to(nug, (spec.n_obs,)))
    if nug.ndim > 0:
        nug = np.broadcast_to(nug, (spec.n_obs,))
    fn = loglik_fn(spec, covmodel, device=device, dtype=dtype, with_aux=True)
    ll, aux = fn(np.asarray(z, np.float64),
                 np.asarray(covparms, np.float64), nug)
    nbad = int(aux["n_dropped_rows"])
    if nbad:
        warnings.warn(f"u_entries: Cholesky failed for {nbad} row(s); "
                      "their U rows were dropped (non-SPD conditioning "
                      "covariance)")
    return float(ll)
