"""2-D PCA over (a subset of) a cloud — the PCA2D half of the pcl_norm_2d
library (reference/include/PCA2D.h:27-125, src/PCA2D.cpp:8-108); the port
of ``pctpu/ops/pca2d.py``.

Semantics reproduced:
  * fit (``initCompute``, PCA2D.cpp:8-42): centroid over the selected
    indices, unnormalized 2x2 scatter ``demean · demeanᵀ``, self-adjoint
    eigendecomposition with eigenpairs reordered DESCENDING;
  * ``project`` (:81-108): ``eigvecsᵀ · (p.xy − mean)`` with z = 0.

Runs on the device of its input (a library facade on no CLI; no kernel):
masked sums and the closed-form 2x2 eigenproblem of ``ops/eig2.py``.
Eigenvector signs follow Eigen's SelfAdjointEigenSolver only up to sign
(inherently arbitrary); tests compare up to sign.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pctpu_torch.ops.eig2 import eig2_sym_values, eig2_sym_vector


@dataclasses.dataclass(frozen=True)
class Pca2dFit:
    mean: torch.Tensor  # (2,)
    eigenvalues: torch.Tensor  # (2,) descending
    eigenvectors: torch.Tensor  # (2, 2) columns, descending order


def pca2d_fit(xyz: torch.Tensor, mask: torch.Tensor) -> Pca2dFit:
    """Fit over the masked points (``setIndices`` subsets become masks)."""
    p2 = xyz[:, :2].to(torch.float32)
    cnt = torch.clamp_min(mask.to(torch.float32).sum(), 1.0)
    mean = torch.where(mask[:, None], p2, 0.0).sum(dim=0) / cnt
    d = torch.where(mask[:, None], p2 - mean, 0.0)
    # unnormalized scatter, like cloud_demean * cloud_demean^T (PCA2D.cpp:28)
    sxx = (d[:, 0] * d[:, 0]).sum()
    sxy = (d[:, 0] * d[:, 1]).sum()
    syy = (d[:, 1] * d[:, 1]).sum()
    lam_max, lam_min = eig2_sym_values(sxx, sxy, syy)
    # eigenvector of the LARGER eigenvalue (first column, descending order);
    # the minor one is its orthogonal complement
    vmax = eig2_sym_vector(sxx, sxy, syy, lam_max)
    vmin = torch.stack([-vmax[1], vmax[0]])
    return Pca2dFit(
        mean=mean,
        eigenvalues=torch.stack([lam_max, lam_min]),
        eigenvectors=torch.stack([vmax, vmin], dim=1),
    )


def pca2d_project(fit: Pca2dFit, xyz: torch.Tensor) -> torch.Tensor:
    """Project points into the PCA frame (PCA2D.cpp:81-108): returns (N, 3)
    with ``eigvecsᵀ (p.xy − mean)`` in xy and z = 0 (a full-f32 product)."""
    p2 = xyz[:, :2].to(torch.float32)
    proj = (p2 - fit.mean) @ fit.eigenvectors
    return torch.cat([proj, proj.new_zeros((proj.shape[0], 1))], dim=1)


class PCA2D:
    """API-parity facade (PCA2D.h:27-125): set_input_cloud / set_indices /
    get_mean / get_eigen_values / get_eigen_vectors / project.  Works on
    ``device`` (the card unless asked otherwise): numpy input is put there,
    a tensor input is used where it lies."""

    def __init__(self, device: torch.device | str = "cuda") -> None:
        self.device = torch.device(device)
        self._xyz: torch.Tensor | None = None
        self._indices: torch.Tensor | None = None
        self._fit: Pca2dFit | None = None

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def set_input_cloud(self, xyz) -> None:
        self._xyz = self._tensor(xyz, torch.float32)
        self._fit = None

    def set_indices(self, indices) -> None:
        self._indices = None if indices is None else self._tensor(indices, torch.int64)
        self._fit = None

    def _compute(self) -> Pca2dFit:
        if self._xyz is None:
            raise RuntimeError("You have to set a cloud before ask any result !")
        if self._fit is None:
            sub = self._xyz if self._indices is None else self._xyz[
                self._indices.to(self._xyz.device)]
            mask = torch.ones((sub.shape[0],), dtype=torch.bool, device=sub.device)
            self._fit = pca2d_fit(sub, mask)
        return self._fit

    def get_mean(self) -> torch.Tensor:
        return self._compute().mean

    def get_eigen_values(self) -> torch.Tensor:
        return self._compute().eigenvalues

    def get_eigen_vectors(self) -> torch.Tensor:
        return self._compute().eigenvectors

    def project(self, xyz) -> torch.Tensor:
        fit = self._compute()
        pts = torch.atleast_2d(self._tensor(xyz, torch.float32).to(fit.mean.device))
        return pca2d_project(fit, pts)
