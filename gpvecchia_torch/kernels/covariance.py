"""Covariance kernels on distance tensors (PyTorch).

The Matern closed forms for smoothness 0.5, 1.5 and 2.5, as in the JAX
package's ``kernels/covariance.py`` (``_matern_raw``) and the ``_nu_idx``
dispatch of ``kernels/pallas_crout.py``.  General smoothness (the
log-Bessel-K path), ``esqe``, user callables and full or selected covariance
matrices are not ported yet (ROADMAP queue 1, item 1) and raise.
"""

from __future__ import annotations

import torch

__all__ = ["matern", "nu_index", "check_covmodel"]

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.2360679774997896


def nu_index(nu) -> int:
    """0/1/2 for smoothness 0.5/1.5/2.5; NotImplementedError otherwise."""
    nu = float(nu)
    idx = {0.5: 0, 1.5: 1, 2.5: 2}.get(nu)
    if idx is None:
        raise NotImplementedError(
            f"Matern smoothness {nu}: only the closed forms 0.5, 1.5 and 2.5 "
            "are ported (ROADMAP queue 1, item 1: the remaining covariances)")
    return idx


def check_covmodel(covmodel) -> None:
    """Only the built-in 'matern' covariance is ported."""
    if isinstance(covmodel, str) and covmodel == "matern":
        return
    raise NotImplementedError(
        f"covmodel {covmodel!r}: only 'matern' is ported to gpvecchia_torch "
        "(esqe, user callables and covariance matrices: ROADMAP queue 1, "
        "item 1)")


def safe_dist(d2: torch.Tensor) -> torch.Tensor:
    """sqrt with zero at d2 == 0 (and a zero gradient there)."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def matern(dist: torch.Tensor, covparms: torch.Tensor) -> torch.Tensor:
    """sig2 * g(dist / rho) with g the closed-form Matern correlation."""
    sig2, rho = covparms[0], covparms[1]
    idx = nu_index(covparms[2])
    s = dist / rho
    if idx == 0:
        c = torch.exp(-s)
    elif idx == 1:
        c = (1.0 + _SQRT3 * s) * torch.exp(-_SQRT3 * s)
    else:
        c = (1.0 + _SQRT5 * s + 5.0 * s * s / 3.0) * torch.exp(-_SQRT5 * s)
    return sig2 * torch.where(dist > 0, c, 1.0)
