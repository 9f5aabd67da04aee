"""Closed-form symmetric 2×2 eigensolver for the 2-D normal op (the port of
``pctpu/ops/eig2.py``): trace/discriminant eigenvalues and the
row-nullspace eigenvector (the larger of the two (S − λI) row forms,
normalised, +x for a degenerate isotropic scatter)."""

from __future__ import annotations

import torch


def eig2_sym_values(sxx, sxy, syy):
    """(λ_max, λ_min) of [[sxx, sxy], [sxy, syy]], elementwise."""
    tr = sxx + syy
    det_h = torch.sqrt(torch.clamp_min((sxx - syy) ** 2 + 4.0 * sxy * sxy, 0.0))
    return 0.5 * (tr + det_h), 0.5 * (tr - det_h)


def eig2_sym_vector(sxx, sxy, syy, lam):
    """Unit eigenvector for eigenvalue ``lam``, stacked on the last axis."""
    v1 = torch.stack([sxy, lam - sxx], dim=-1)
    v2 = torch.stack([lam - syy, sxy], dim=-1)
    use1 = v1.abs().sum(dim=-1) >= v2.abs().sum(dim=-1)
    v = torch.where(use1[..., None], v1, v2)
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.tensor([1.0, 0.0], dtype=v.dtype, device=v.device)
    # the guard matches the clamp: 0 < norm < 1e-30 takes the fallback
    return torch.where(norm >= 1e-30, v / torch.clamp_min(norm, 1e-30), fallback)
