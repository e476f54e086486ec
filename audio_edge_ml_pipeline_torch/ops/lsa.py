"""Truncated SVD by the randomized algorithm, on the device in float64:
scikit-learn's ``TruncatedSVD(algorithm="randomized", n_iter=5,
random_state=42)`` (1.9; ``sklearn/utils/extmath.py::_randomized_svd`` and
``_randomized_range_finder``, ``decomposition/_truncated_svd.py``).

The steps kept:

- the matrix is transposed when it has fewer rows than columns (a corpus of
  fewer documents than terms);
- ``n_components + N_OVERSAMPLES`` random directions, drawn by
  ``numpy.random.RandomState(RANDOM_STATE).normal`` in scikit-learn's shape
  and order, then moved to the device;
- ``N_ITER`` power iterations normalized by LU (scikit-learn picks LU for
  more than two iterations): each product replaced by ``P @ L`` of its
  partially pivoted LU, as ``scipy.linalg.lu(..., permute_l=True)``
  returns it (``torch.linalg.lu_factor_ex``, LAPACK's row pivoting);
- a final reduced QR, the SVD of the small projected matrix, and
  ``svd_flip(u_based_decision=False)``: each component's largest entry is
  made positive;
- the transform is ``X @ components_.T``, as scikit-learn returns it for
  the randomized algorithm.

The JAX package leaves this to scikit-learn on the host; the port runs it as
torch ops (float64 GEMMs, LU, QR, a small SVD), no hand kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# TruncatedSVD's defaults (n_iter=5; _randomized_svd's n_oversamples=10) and
# the random_state the text extractors pass
N_ITER = 5
N_OVERSAMPLES = 10
RANDOM_STATE = 42


@dataclass
class TruncatedSVD:
    """A fitted truncated SVD: ``components`` (k, n_features) and
    ``singular_values`` (k,), float64 on the device."""

    components: torch.Tensor
    singular_values: torch.Tensor

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Rows projected on the components: ``x @ components.T``."""
        return x.to(torch.float64) @ self.components.T


def _permuted_l(a: torch.Tensor) -> torch.Tensor:
    """``P @ L`` of ``a = P L U`` (partial pivoting), without forming P."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(a)  # a rank-deficient a factors too, as in scipy
    m, k = a.shape[0], min(a.shape)
    l = torch.tril(lu[:, :k], diagonal=-1) + torch.eye(m, k, dtype=a.dtype, device=a.device)
    # LAPACK swapped row i with row pivots[i] - 1, in order: (L U)[j] = a[perm[j]]
    perm = list(range(m))
    for i, p in enumerate(pivots.tolist()):
        perm[i], perm[p - 1] = perm[p - 1], perm[i]
    pl = torch.empty_like(l)
    pl[torch.tensor(perm, device=a.device)] = l
    return pl


def _range_finder(a: torch.Tensor, size: int) -> torch.Tensor:
    """An orthonormal basis (a.shape[0], size) of the range of
    ``a (a^T a)^N_ITER omega``: ``_randomized_range_finder``."""
    omega = np.random.RandomState(RANDOM_STATE).normal(size=(a.shape[1], size))
    q = torch.from_numpy(omega).to(a.device)
    for _ in range(N_ITER):
        q = _permuted_l(a @ q)
        q = _permuted_l(a.T @ q)
    return torch.linalg.qr(a @ q, mode="reduced")[0]


def truncated_svd(x: torch.Tensor, n_components: int) -> tuple[TruncatedSVD, torch.Tensor]:
    """Fit the randomized truncated SVD of ``x`` (n_samples, n_features) and
    return it with the transformed rows ``x @ components.T`` (float64, on
    ``x``'s device)."""
    x = x.to(torch.float64)
    if n_components > x.shape[1]:
        raise ValueError(f"n_components({n_components}) must be <= n_features({x.shape[1]}).")
    transpose = x.shape[0] < x.shape[1]
    m = x.T if transpose else x
    q = _range_finder(m, n_components + N_OVERSAMPLES)
    u_hat, s, vt = torch.linalg.svd(q.T @ m, full_matrices=False)
    u = q @ u_hat
    # components_ and the sample-side factor, in x's orientation
    components = u[:, :n_components].T if transpose else vt[:n_components]
    # svd_flip(u_based_decision=False): each component's largest |entry| positive
    largest = components.gather(1, components.abs().argmax(dim=1, keepdim=True))
    components = components * torch.sign(largest)
    svd = TruncatedSVD(components.contiguous(), s[:n_components])
    return svd, svd.transform(x)
