"""Gaussian Vecchia log-likelihood in PyTorch.

The port of the JAX package's ``inference/likelihood.py``.  The numerator
comes from the U columns; the denominator from a factor of W = U_y U_y^T +
D, by one of two engines, as in the JAX package:

* plans with ``use_mf`` (cond_yz y/z/SGV/SGVT without prediction points or
  with ``ordering_pred="general"``): the multifrontal factor, whose RHS z2
  = U_y z1 rides the tree as an augmented row (``linalg/multifrontal.py``);
* every other plan (the zy family's 'direct' mode, the 'obspred' mode of
  specs with obspred prediction points, and IC0): the per-entry V factor
  (``plan.ensure_v``, ``compute_v_factor``), with z2 by ``pair_sum`` and a
  level-scheduled forward solve (``linalg/trisolve.py``).

The degenerate all-exact case (no latent variable left) has no
denominator.

The covariance model is any the JAX package takes (``_dispatch_covmodel``):
'matern' (closed-form smoothness on H1, any other on the packed path and
H8), 'esqe', a user callable of torch tensors over distances or location
pairs, a full (n_all, n_all) covariance matrix over the ordered points, or
the selected (n_all, m+1) layout aligned with NNarray (``hv.get_mat_cov``;
hierarchical conditioning such as MRA), gathered through
``plan.sel_pair_slots_packed`` onto the packed path and H8.

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
from ..linalg.multifrontal import mf_device_arrays, mf_factor_part
from ..linalg.sparse import (device_schedule, pair_sum, spread_pads,
                             with_zeros)
from ..linalg.trisolve import device_blocks, forward_solve
from ..parallel.mesh import LOCAL
from ..plan import ensure_v, get_mf_plan, get_plan, sel_pair_slots_packed
from ..utils import trace

__all__ = ["vecchia_likelihood", "loglik_fn", "zero_nugget_variant",
           "compute_v_factor"]


@trace.span("plan.device_arrays")
def _device_arrays(plan, device, dtype, ranks=1, rank=0):
    """Index tensors of the plan on ``device`` (cached per device, dtype
    and share): the whole plan, or rank ``rank``'s share among ``ranks``
    (``parallel.mesh.shard_rows``): the row arrays of its own rows (its
    leaves' elements on a multifrontal plan, a contiguous range otherwise)
    and its share of the tree; the rest replicated."""
    key = ("dev", str(device), dtype, ranks, rank)
    if key in plan.cache:
        return plan.cache[key]

    def t(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

    dev = {}
    rows = None
    if plan.use_mf:
        mfp, vert_obs = get_mf_plan(plan)
        dev["mf"] = mf_device_arrays(mfp, device, ranks, rank)
        rows = dev["mf"].elems
    elif ranks > 1:
        r0, r1 = plan.n_all * rank // ranks, plan.n_all * (rank + 1) // ranks
        rows = np.arange(r0, r1)
        dev["row0"] = r0
    if rows is not None:
        dev["rows"] = t(rows, torch.long)

    def r(a):
        return a if rows is None else a[rows]

    dev.update({
        "locs": t(plan.locs, dtype),
        "NN": t(r(plan.NN)),
        "valid": t(r(plan.valid)),
        "cond": t(r(plan.cond)),
        "nb_resp": t(r(plan.nb_resp)),
        "nb_obs_pos": t(r(plan.nb_obs_pos), torch.long),
        "obs_points": t(plan.obs_points, torch.long),
        "ord_z": t(plan.ord_z, torch.long),
        "has_col": t(r(plan.has_latent_pts | plan.known_pts)),
        "zero_obs": t(plan.zero_obs),
    })
    if plan.use_mf:
        dev["vert_obs"] = t(vert_obs, torch.long)
        dev["vert_pt"] = t(np.flatnonzero(plan.has_latent_pts), torch.long)
        if plan.known_pts.any():
            # exact (zero-nugget) observations: their point and obs position
            kp = np.flatnonzero(plan.known_pts)
            dev["known_pt"] = t(kp, torch.long)
            dev["known_obs"] = t(plan.obs_pos[kp], torch.long)
    elif plan.n_lat > 0:
        dev.update(_v_device_arrays(ensure_v(plan), device))
    plan.cache[key] = dev
    return dev


def _v_device_arrays(plan, device):
    """The per-entry V engine's schedules on ``device``: everything a
    factor, solve or pair sum reads is put there once, each gather's pads
    spread over zeros of their own (``sparse.spread_pads``)."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device,
                                                            torch.long)

    factor, zv = [], 1
    for b in plan.factor_buckets:
        dcls, ocls, zd = [], [], 1
        for pa, pb, _ in b.diag_classes:
            (pa, k), (pb, _) = (spread_pads(a, plan.v_phys_size)
                                for a in (pa, pb))
            dcls.append((t(pa), t(pb)))
            zv = max(zv, k)
        n_diag = sum(E for _, _, E in b.diag_classes)
        for pa, pb, dloc, _ in b.off_classes:
            (pa, k), (pb, _) = (spread_pads(a, plan.v_phys_size)
                                for a in (pa, pb))
            dloc, kd = spread_pads(dloc, n_diag)
            ocls.append((t(pa), t(pb), t(dloc)))
            zv, zd = max(zv, k), max(zd, kd)
        factor.append((b.offsets.tolist(), b.S, dcls, ocls, zd))
    n_all, mp1 = plan.NN.shape
    return dict(
        v_diag_slots=t(plan.v_diag_slots), dir_pt=t(plan.dir_pt),
        dir_nn=t(plan.dir_nn), factor=factor, factor_zeros=zv,
        w_sched=device_schedule(plan.w_schedule, device, sizes=(
            n_all * mp1 + plan.n_obs + 1,) * 2),
        z2_sched=device_schedule(plan.z2_schedule, device, sizes=(
            n_all * mp1 + 1, n_all + plan.n_obs)),
        fwd=device_blocks(plan.fwd_blocks, device, "fwd", plan.v_phys_size,
                          plan.fwd_x_size),
        bwd=device_blocks(plan.bwd_blocks, device, "bwd", plan.v_phys_size,
                          plan.bwd_x_size),
        fwd_x_perm=t(plan.fwd_x_perm), bwd_x_perm=t(plan.bwd_x_perm))


def compute_v_factor(plan, dev, col, nug_ord):
    """V's values (physical layout, ``plan.v_phys_size``) from the U
    columns and the nuggets over the observed positions.

    Direct columns are a gather of U entries.  The factored columns run
    the up-looking factorization on the static schedule (``plan.py``): W
    is assembled once by a pair sum straight into the physical level
    layout; each elimination level then computes its contiguous segment
    (diagonals first, then the off-diagonals scaled by the rsqrt of their
    column's diagonal) and writes it in place (GPvecchia
    R/vecchia_prediction.R:74-84, src/ic0.cpp:43-64).  The pivots are not
    clamped: a pivot that is not positive surfaces as NaN.
    """
    v_dir = col[dev["dir_pt"], dev["dir_nn"]]
    if not dev["factor"]:
        return v_dir
    ucat = torch.cat([col.reshape(-1), 1.0 / nug_ord, col.new_ones(1)])
    w = pair_sum(ucat, ucat, dev["w_sched"])
    # the zeros after the physical layout stay 0: the products' pads
    v = torch.cat([v_dir, col.new_zeros(plan.v_phys_size - plan.n_dir
                                        + dev["factor_zeros"])])
    for offsets, S, dcls, ocls, zd in dev["factor"]:
        for li, off in enumerate(offsets):
            w_lvl = w[off:off + S]
            pos, dparts = 0, []
            for pa, pb in dcls:
                E = pa.shape[1]
                raw = w_lvl[pos:pos + E]
                if pa.shape[-1] > 0:
                    raw = raw - torch.sum(v[pa[li]] * v[pb[li]], dim=-1)
                dparts.append(raw)
                pos += E
            draw = torch.cat(dparts) if len(dparts) > 1 else dparts[0]
            dinv = with_zeros(torch.rsqrt(draw), zd)
            parts = [draw * dinv[:draw.shape[0]]]  # sqrt of the diagonals
            for pa, pb, dloc in ocls:
                E = pa.shape[1]
                raw = w_lvl[pos:pos + E]
                if pa.shape[-1] > 0:
                    raw = raw - torch.sum(v[pa[li]] * v[pb[li]], dim=-1)
                parts.append(raw * dinv[dloc[li]])
                pos += E
            v[off:off + S] = torch.cat(parts) if len(parts) > 1 else parts[0]
    return v[:plan.v_phys_size]


def z2_of(dev, col_w, z1L, z1Z, nug_safe):
    """z2 = U_y z1 over the latent rows (logical order): the U columns'
    weights z1L, and -z1Z / sqrt(nugget) at each observed latent's own
    row, as a pair sum."""
    ucat = torch.cat([col_w.reshape(-1), col_w.new_ones(1)])
    zcat = torch.cat([z1L, -z1Z / torch.sqrt(nug_safe)])
    return pair_sum(ucat, zcat, dev["z2_sched"])


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


def mf_vert_inputs(dev, zord, nug_ord):
    """(dvec, rhs_vert) of the factor of W = U_y U_y^T + D: D adds
    1/nugget at observed vertices and the RHS adds -zord/nugget there (the
    observation column)."""
    vo = dev["vert_obs"]
    obs_v = vo >= 0
    voc = vo.clamp(min=0)
    nug_v = torch.where(obs_v, nug_ord[voc], 1.0)
    dvec = torch.where(obs_v, 1.0 / nug_v, 0.0)
    rhs_vert = torch.where(obs_v, -zord[voc] / nug_v, 0.0)
    return dvec, rhs_vert


def mf_inputs(dev, col, zord, nug_ord):
    """(u_elem, dvec, rhs_vert) of the factor of W = U_y U_y^T + D."""
    return (torch.where(dev["cond"], col, 0.0),
            *mf_vert_inputs(dev, zord, nug_ord))


def _local_cov(dev, cov):
    """The covariance source as a rank's own rows read it: the selected
    layout's packed pair slots are per row."""
    kernel_fn, covmat, sel = cov
    if sel is not None and "rows" in dev:
        sel = (sel[0], sel[1][dev["rows"]])
    return kernel_fn, covmat, sel


@trace.span("loglik")
def _loglik_core(plan, dev, pack, covparms, nuggets, dtype, device,
                 cov=(None, None, None), share=None):
    """(log-likelihood, aux) on ``dev``: the whole plan, or with ``share``
    (``parallel.mesh.RowShare``) a rank's share of it (``_device_arrays``
    with ranks > 1), every rank returning the whole value.

    The local part (the U entries of the rank's rows, their numerator
    terms and the rank's levels of the tree) reads covparms and the
    nuggets through ``share.replicate`` and leaves through
    ``share.reduce`` / ``share.all_gather``; the replicated part (the
    observation terms, the top levels of the tree, the V engine) reads
    them directly.  Without a share every exchange is the identity, and
    this is the single-process likelihood."""
    share = LOCAL if share is None else share
    if not torch.is_tensor(covparms):
        covparms = torch.as_tensor(np.array(covparms, dtype=np.float64))
    covparms = covparms.to(dtype)
    if not torch.is_tensor(nuggets):
        nuggets = torch.as_tensor(np.array(nuggets, dtype=np.float64))
    nug_in = trace.to(nuggets, device, dtype)

    # NA handling by nugget inflation (GPvecchia R/vecchia_likelihood.R:45-58)
    big = pack["zv"] * 1e8
    if nug_in.dim() == 0:
        nug_ord = torch.where(pack["nan_ord"], big, nug_in)
    else:
        nug_vec = nug_in.expand(plan.n_obs)
        nug_ord = torch.where(pack["nan_ord"], big, nug_vec[dev["ord_z"]])
    zord = pack["zord"]

    # ---- the local part: this rank's rows ----
    cp_l, nug_l = share.replicate(covparms, nug_ord)
    nug_point = torch.zeros(plan.n_all, dtype=dtype, device=device)
    nug_point = nug_point.index_put((dev["obs_points"],), nug_l)
    col, bad = u_entries(dev["locs"], dev["NN"], dev["valid"], dev["cond"],
                         nug_point, cp_l, *_local_cov(dev, cov))

    # z1 over U columns: regression columns gather the values of their
    # known-conditioned neighbors (response-conditioned, or exact latents)
    z1L = torch.sum(torch.where(dev["nb_resp"], col * pack["znb"], 0.0), dim=1)
    col_mask = dev["has_col"]
    z1L = torch.where(col_mask, z1L, 0.0)
    local = [torch.sum(z1L * z1L), -2.0 * torch.sum(torch.where(
        col_mask, torch.log(torch.where(col_mask, col[:, 0], 1.0)), 0.0))]

    # dropped (non-SPD) rows contribute nothing to W = U_y U_y^T
    col_w = torch.where(bad[:, None], 0.0, col)
    mf = plan.use_mf and plan.n_lat > 0
    if mf:
        dvec, rhs_vert = mf_vert_inputs(dev, zord, nug_l)
        ld_w, q_w, schur = mf_factor_part(
            dev["mf"], torch.where(dev["cond"], col_w, 0.0), dvec, z1L,
            rhs_vert)
        local += [ld_w, q_w]
    quad_rows, logdet_rows, *denom = share.reduce(*local)

    # ---- the replicated part ----
    zero_obs = dev["zero_obs"]
    nug_safe = torch.where(zero_obs, 1.0, nug_ord)
    z1Z = torch.where(zero_obs, 0.0, zord / torch.sqrt(nug_safe))
    quad_num = quad_rows + torch.sum(z1Z * z1Z)
    logdet_num = logdet_rows + torch.sum(torch.where(
        zero_obs, 0.0, torch.log(nug_safe)))

    if plan.n_lat == 0:
        # every observation exact: no latent left, no denominator
        logdet_denom = quad_denom = torch.zeros((), dtype=dtype, device=device)
    elif mf:
        logdet_w, quad_denom = denom
        top = dev["mf"].top
        if top is not None:
            # the top levels, from every rank's shallowest Schur blocks
            dvec, rhs_vert = mf_vert_inputs(dev, zord, nug_ord)
            ld_t, q_t, _ = mf_factor_part(top, share.all_gather(schur), dvec,
                                          None, rhs_vert)
            logdet_w = logdet_w + ld_t
            quad_denom = quad_denom + q_t
        logdet_denom = -logdet_w
    else:
        # denominator through V: z3 = V^{-1} rev(z2), logdet from V's diagonal
        if "row0" in dev:
            cz = share.all_gather(torch.cat([col_w, z1L[:, None]], dim=1),
                                  dev["row0"], plan.n_all)
            col_w, z1L = cz[:, :-1], cz[:, -1]
        z2 = z2_of(dev, col_w, z1L, z1Z, nug_safe)
        v = compute_v_factor(plan, dev, col_w, nug_ord)
        z3 = forward_solve(v, z2.flip(0), dev["fwd"])
        quad_denom = torch.sum(z3 * z3)
        logdet_denom = -2.0 * torch.sum(torch.log(v[dev["v_diag_slots"]]))

    const = plan.n_obs * math.log(2.0 * math.pi)
    neg2 = logdet_num - logdet_denom + quad_num - quad_denom + const
    return -0.5 * neg2, {"n_dropped_rows": share.sum_ranks(torch.sum(bad))}


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
    key = ("zero_variant", zero.tobytes())

    def build():
        zero_by_pos = zero[spec.ord_z]
        if spec.cond_yz in ("zy", "RVP", "LK"):
            return _zy_zero_variant(spec, zero_by_pos)
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


def _zy_zero_variant(spec, zero_by_pos):
    """The zero-nugget variant of a response-first (zy-family) spec.

    The observation lives on the response point k < n and its latent twin
    is t = k + n.  With a zero nugget y_t == z_k, so the twin's latent is
    deleted, any conditioning on y_t is redirected to the (known) response
    z_k, and the twin keeps a 'known' U column p(y_t = z_k | nb) whose self
    slot points at k (same location) with the degenerate own-z slot
    removed (GPvecchia R/createU.R:173-193 deletes the Inf-diagonal rows
    and permutes).  The known column conditions on neighbor responses: it
    carries no latent rows, so V = rev(U_y) stays the direct mode's
    identity.
    """
    n = spec.n_obs
    zpts = np.flatnonzero(zero_by_pos)
    twins = zpts + n
    NN = spec.NNarray.copy()
    cond = spec.cond_latent.copy()
    is_twin = np.zeros(spec.n_all, bool)
    is_twin[twins] = True
    hit = (NN >= 0) & is_twin[np.maximum(NN, 0)]
    NN = np.where(hit, NN - n, NN)
    cond = np.where(hit, False, cond)
    NN[twins, 0] = zpts
    NN[twins, 1] = -1          # own-z slot: duplicate location
    tw = NN[twins]
    assert not np.any(tw >= 2 * n), \
        "zero-nugget twin conditions on a prediction latent"
    NN[twins] = np.where(tw >= n, tw - n, tw)
    cond[twins] = False
    has_latent = spec.has_latent.copy()
    has_latent[twins] = False
    known = np.zeros(spec.n_all, bool)
    known[twins] = True
    return dataclasses.replace(
        spec, NNarray=NN, cond_latent=cond & (NN >= 0),
        has_latent=has_latent, known_pts=known, zero_obs_mask=zero_by_pos,
        _cache={})


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


def _sel_slots(spec, device):
    """The selected layout's pair slots, packed like ``build_cov_packed``'s
    rows: (n_all, P) int32 on ``device`` (cached on the spec)."""
    return spec.cached(("sel_slots_packed", str(device)),
                       lambda: torch.as_tensor(
                           sel_pair_slots_packed(spec)).to(device))


@trace.span("plan.covmodel")
def _dispatch_covmodel(spec, covmodel, device, dtype):
    """(kernel_fn, covmat, sel): a kernel evaluator, a full covariance
    matrix on ``device``, or the selected layout's (flat values, packed
    pair slots) on ``device`` (NaN padding read as 0)."""
    if not _is_matrix(covmodel):
        return make_kernel_fn(covmodel), None, None
    arr = _as_array(covmodel)
    n_all, mp1 = spec.NNarray.shape
    if arr.shape == (n_all, n_all):
        return None, torch.as_tensor(arr).to(device, dtype), None
    if arr.shape == (n_all, mp1):
        vals = torch.as_tensor(np.nan_to_num(arr).ravel()).to(device, dtype)
        return None, None, (vals, _sel_slots(spec, device))
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
    key = ("loglik", _covmodel_key(covmodel), str(device), dtype, with_aux)
    if key in plan.cache:
        return plan.cache[key]
    fn = _loglik_closure(plan, _device_arrays(plan, device, dtype),
                         _dispatch_covmodel(spec, covmodel, device, dtype),
                         device, dtype, with_aux)
    plan.cache[key] = fn
    return fn


def _loglik_closure(plan, dev, cov, device, dtype, with_aux=False,
                    share=None):
    """fn(z, covparms, nuggets) over ``dev`` (a whole plan's arrays or a
    rank's share), with the data preparation cached per z (``zkey``)."""
    zcache = {}

    def fn(z, covparms, nuggets):
        zk = zkey(z)
        if zcache.get("key") != zk:
            zt = torch.as_tensor(np.asarray(z) if not torch.is_tensor(z)
                                 else z).to(device, dtype)
            # ref pins z so that its id stays unique while it is the key
            zcache.update(key=zk, ref=z, pack=_prepare_pack(dev, zt))
        ll, aux = _loglik_core(plan, dev, zcache["pack"], covparms, nuggets,
                               dtype, device, cov, share)
        return (ll, aux) if with_aux else ll

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
    nbad = int(trace.sync(aux["n_dropped_rows"]))
    if nbad:
        warnings.warn(f"u_entries: Cholesky failed for {nbad} row(s); "
                      "their U rows were dropped (non-SPD conditioning "
                      "covariance)")
    return float(trace.sync(ll))
