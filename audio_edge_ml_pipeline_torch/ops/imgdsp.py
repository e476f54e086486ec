"""Batched image descriptors: HOG, LBP, GLCM, gray histogram, in PyTorch.

Counterpart of the JAX package's ``ops/imgdsp.py``: the per-sample numpy
descriptors of ``features/image.py`` (the oracle and the CPU path) as batched
tensor ops on (B, H, W) float32 grayscale in [0, 1], every function
returning float32. Bilinear orientation binning is a one-hot weighting, the
LBP ring a gather at host-computed indices, and the histograms and the
co-occurrence matrix are integer counts by ``scatter_add_``. No hand kernel
is on this path: each stage is ordinary torch ops.

Exactness: the LBP and the gray histogram equal the oracle bit for bit on
any device (their arithmetic is exact integers, see ``lbp_histogram_batch``);
HOG and the GLCM statistics agree to float32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_LBP_WEIGHT_SCALE = 1024  # keep equal to features.image.LBP_WEIGHT_SCALE


def _gradient_1d(a: torch.Tensor, axis: int) -> torch.Tensor:
    """np.gradient contract: central differences inside, one-sided at the edges."""
    a = a.movedim(axis, -1)
    interior = (a[..., 2:] - a[..., :-2]) * 0.5
    first = a[..., 1:2] - a[..., 0:1]
    last = a[..., -1:] - a[..., -2:-1]
    return torch.cat([first, interior, last], dim=-1).movedim(-1, axis)


def hog_features_batch(
    gray: torch.Tensor,
    orientations: int = 9,
    cell: tuple[int, int] = (8, 8),
    block: tuple[int, int] = (2, 2),
) -> torch.Tensor:
    """(B, H, W) -> (B, n_by * n_bx * bh * bw * orientations) L2-Hys HOG.

    Same definition as features.image.hog_features: unsigned gradients on
    np.gradient stencils, bilinear orientation binning, cell sums, and
    L2-Hys normalization of overlapping blocks, flattened in (by, bx, dy,
    dx, o) order."""
    ch, cw = cell
    bh, bw = block
    B, H, W = gray.shape
    gy = _gradient_1d(gray, 1)  # d/d(row): numpy's first output
    gx = _gradient_1d(gray, 2)
    n_cy, n_cx = H // ch, W // cw
    n_by, n_bx = n_cy - bh + 1, n_cx - bw + 1
    if n_by <= 0 or n_bx <= 0:  # image smaller than one block (oracle: empty)
        return gray.new_zeros((B, 0))
    mag = torch.hypot(gx, gy)[:, : n_cy * ch, : n_cx * cw]
    ang = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)[:, : n_cy * ch, : n_cx * cw]
    t = ang / (180.0 / orientations)
    f = torch.floor(t)
    frac = t - f
    b0 = torch.remainder(f.to(torch.int64), orientations)
    b1 = torch.remainder(b0 + 1, orientations)
    o = torch.arange(orientations, device=gray.device)
    pix = mag[..., None] * ((1.0 - frac)[..., None] * (b0[..., None] == o) + frac[..., None] * (b1[..., None] == o))
    cells = pix.reshape(B, n_cy, ch, n_cx, cw, orientations).sum(dim=(2, 4))
    windows = torch.stack([cells[:, dy : dy + n_by, dx : dx + n_bx, :] for dy in range(bh) for dx in range(bw)],
                          dim=3)  # (B, n_by, n_bx, bh*bw, O) in the oracle's (dy, dx) ravel order
    v = windows.reshape(B, n_by, n_bx, bh * bw * orientations)
    v = v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)
    v = torch.clamp_max(v, 0.2)
    v = v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)
    return v.reshape(B, -1)


@functools.lru_cache(maxsize=16)
def _lbp_ring_constants(H: int, W: int, P: int, R: float, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear gather indices (P, 4, H*W) int64 and 10-bit fixed-point
    weights (P, 4, H*W) float32 of the P-point ring on ``device``, computed
    in float64 as the numpy oracle computes them, so the corner picks and
    weights agree exactly."""
    ys, xs = np.mgrid[0:H, 0:W]
    angles = 2 * np.pi * np.arange(P) / P
    idx = np.empty((P, 4, H * W), np.int64)
    wts = np.empty((P, 4, H * W), np.float32)
    s = float(_LBP_WEIGHT_SCALE)
    for k in range(P):
        dy, dx = -R * np.sin(angles[k]), R * np.cos(angles[k])
        yy = np.clip(ys + dy, 0, H - 1)
        xx = np.clip(xs + dx, 0, W - 1)
        y0, x0 = np.floor(yy).astype(np.int64), np.floor(xx).astype(np.int64)
        y1, x1 = np.minimum(y0 + 1, H - 1), np.minimum(x0 + 1, W - 1)
        fy, fx = yy - y0, xx - x0
        idx[k] = [(y0 * W + x0).ravel(), (y1 * W + x0).ravel(), (y0 * W + x1).ravel(), (y1 * W + x1).ravel()]
        wts[k] = [np.rint((1 - fy) * (1 - fx) * s).ravel(), np.rint(fy * (1 - fx) * s).ravel(),
                  np.rint((1 - fy) * fx * s).ravel(), np.rint(fy * fx * s).ravel()]
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


def lbp_histogram_batch(gray: torch.Tensor, P: int = 24, R: float = 3.0) -> torch.Tensor:
    """(B, H, W) -> (B, P + 2) normalized uniform-LBP histogram.

    Each bit is the sign of sum_c wq_c * (Q_c - Q_center), with Q the 8-bit
    quantized levels and wq the 10-bit fixed-point bilinear weights: a sum
    of exact integers below 2^24 in float32, the same under any summation
    order, FMA contraction or device (features.image.lbp_histogram's
    contract). The counts are exact too, and their normalization is the
    oracle's float64 division rounded once."""
    B, H, W = gray.shape
    idx, wts = _lbp_ring_constants(H, W, P, float(R), gray.device)
    q = torch.round(gray.reshape(B, H * W) * 255.0)  # half to even, as np.rint
    count_ones = torch.zeros((B, H * W), dtype=torch.int64, device=gray.device)
    transitions = torch.zeros_like(count_ones)
    first = prev = None
    for k in range(P):
        delta = sum(wts[k, c] * (q[:, idx[k, c]] - q) for c in range(4))
        bit = (delta >= 0).to(torch.int64)
        count_ones += bit
        if prev is None:
            first = bit
        else:
            transitions += bit != prev
        prev = bit
    transitions += prev != first
    codes = torch.where(transitions <= 2, count_ones, P + 1)  # non-uniform -> last bin
    hist = torch.zeros((B, P + 2), dtype=torch.float64, device=gray.device)
    hist.scatter_add_(1, codes, torch.ones_like(codes, dtype=torch.float64))
    return (hist / (H * W)).to(torch.float32)


def glcm_stats_batch(gray: torch.Tensor, levels: int = 32) -> torch.Tensor:
    """(B, H, W) -> (B, 6): contrast, dissimilarity, homogeneity, energy,
    correlation, ASM of the symmetric distance-1 / angle-0 co-occurrence
    matrix. The pair counts are exact integers (``scatter_add_`` of pair
    codes a * levels + b); the statistics run in float64, as the oracle's,
    and are rounded once."""
    B, H, W = gray.shape
    q = torch.clamp((gray * levels).to(torch.int64), 0, levels - 1)
    code = (q[:, :, :-1] * levels + q[:, :, 1:]).reshape(B, -1)
    glcm = torch.zeros((B, levels * levels), dtype=torch.float64, device=gray.device)
    glcm.scatter_add_(1, code, torch.ones_like(code, dtype=torch.float64))
    glcm = glcm.reshape(B, levels, levels)
    glcm = glcm + glcm.transpose(1, 2)
    glcm = glcm / torch.clamp_min(glcm.sum(dim=(1, 2), keepdim=True), 1.0)
    i = torch.arange(levels, dtype=torch.float64, device=gray.device)[:, None].expand(levels, levels)
    j = i.T
    diff = i - j
    contrast = (glcm * diff**2).sum(dim=(1, 2))
    dissim = (glcm * diff.abs()).sum(dim=(1, 2))
    homog = (glcm / (1.0 + diff**2)).sum(dim=(1, 2))
    asm = (glcm**2).sum(dim=(1, 2))
    mu_i = (glcm * i).sum(dim=(1, 2))
    mu_j = (glcm * j).sum(dim=(1, 2))
    ci = i - mu_i[:, None, None]
    cj = j - mu_j[:, None, None]
    si = torch.sqrt((glcm * ci**2).sum(dim=(1, 2)))
    sj = torch.sqrt((glcm * cj**2).sum(dim=(1, 2)))
    ok = (si > 0) & (sj > 0)
    corr = torch.where(ok, (glcm * ci * cj).sum(dim=(1, 2)) / torch.where(ok, si * sj, 1.0), 1.0)
    return torch.stack([contrast, dissim, homog, torch.sqrt(asm), corr, asm], dim=1).to(torch.float32)


def gray_hist_batch(gray: torch.Tensor, bins: int = 64) -> torch.Tensor:
    """(B, H, W) -> (B, bins) normalized intensity histogram over [0, 1].

    Bin edges at k / bins are dyadic for power-of-two ``bins``, so floor
    binning equals np.histogram's (the last bin closed on the right, as the
    clip makes it); the counts are exact, and their normalization is the
    oracle's float64 division rounded once."""
    B = gray.shape[0]
    q = torch.clamp((gray * bins).to(torch.int64), 0, bins - 1).reshape(B, -1)
    hist = torch.zeros((B, bins), dtype=torch.float64, device=gray.device)
    hist.scatter_add_(1, q, torch.ones_like(q, dtype=torch.float64))
    return (hist / torch.clamp_min(hist.sum(dim=1, keepdim=True), 1.0)).to(torch.float32)


def classical_image_vector_batch(
    gray: torch.Tensor,
    orientations: int = 9,
    cell: tuple[int, int] = (8, 8),
    block: tuple[int, int] = (2, 2),
    lbp_points: int = 24,
    lbp_radius: float = 3.0,
    n_hist_bins: int = 64,
) -> torch.Tensor:
    """(B, H, W) -> (B, D) HOG + LBP + gray-hist + GLCM, in the order of
    features.image.classical_image_vector (8196-d at 128x128 defaults)."""
    return torch.cat([
        hog_features_batch(gray, orientations=orientations, cell=cell, block=block),
        lbp_histogram_batch(gray, P=lbp_points, R=lbp_radius),
        gray_hist_batch(gray, bins=n_hist_bins),
        glcm_stats_batch(gray),
    ], dim=1).to(torch.float32)
