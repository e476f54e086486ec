"""Registered image extractors: ``image_classical``, ``image_pixels`` and
``image_mobilenet_v2``.

Same names, parameters, defaults and numerical contracts as the JAX
package's ``features/image.py``, plus a ``device`` argument. HOG, LBP and
GLCM are the numpy definitions below (9-orientation HOG on 8x8 cells with
2x2 L2-Hys blocks; uniform LBP P=24 R=3 -> 26 bins; 64-bin gray histogram;
GLCM contrast / dissimilarity / homogeneity / energy / correlation / ASM):
the per-sample path on the CPU and the parity oracle. On a CUDA card,
``image_classical.extract_dataset`` runs the whole descriptor stack in
batches on the card (``ops/imgdsp.py``). Images are decoded with PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import BaseFeatureExtractor, _device_batched_dataset, auto_device_batch, pad_stack
from .registry import register


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("the image extractors decode with Pillow (PIL), which is not installed") from exc
    return Image


def _load_gray(path: Path, size: tuple[int, int], bbox_norm=None) -> np.ndarray:
    img = _pil_image().open(path).convert("L")
    if bbox_norm is not None:
        img = _crop_bbox(img, bbox_norm)
    img = img.resize(size)
    return np.asarray(img, dtype=np.float32) / 255.0


def _load_rgb(path: Path, size: tuple[int, int], bbox_norm=None) -> np.ndarray:
    img = _pil_image().open(path).convert("RGB")
    if bbox_norm is not None:
        img = _crop_bbox(img, bbox_norm)
    img = img.resize(size)
    return np.asarray(img, dtype=np.float32) / 255.0


def _crop_bbox(img, bbox_norm):
    """Crop a YOLO-style normalized (cx, cy, w, h) box."""
    W, H = img.size
    cx, cy, w, h = bbox_norm
    left = max(int((cx - w / 2) * W), 0)
    top = max(int((cy - h / 2) * H), 0)
    right = min(int((cx + w / 2) * W), W)
    bottom = min(int((cy + h / 2) * H), H)
    if right > left and bottom > top:
        return img.crop((left, top, right, bottom))
    return img


# ----------------------------------------------------------------------
# Classical descriptors (numpy)
# ----------------------------------------------------------------------


def hog_features(gray: np.ndarray, orientations: int = 9, cell=8, block=2) -> np.ndarray:
    """Histogram of oriented gradients with L2-Hys block normalization;
    ``cell`` / ``block`` take an int or an (h, w) pair."""
    ch, cw = (cell, cell) if np.isscalar(cell) else (int(cell[0]), int(cell[1]))
    bh, bw = (block, block) if np.isscalar(block) else (int(block[0]), int(block[1]))
    gy, gx = np.gradient(gray)
    mag = np.hypot(gx, gy)
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180.0
    H, W = gray.shape
    n_cy, n_cx = H // ch, W // cw
    mag = mag[: n_cy * ch, : n_cx * cw]
    ang = ang[: n_cy * ch, : n_cx * cw]
    bin_w = 180.0 / orientations
    b0 = np.floor(ang / bin_w).astype(int) % orientations
    frac = ang / bin_w - np.floor(ang / bin_w)
    b1 = (b0 + 1) % orientations
    hist = np.zeros((n_cy, n_cx, orientations))
    cy_idx = np.repeat(np.arange(n_cy), ch)[:, None] * np.ones((1, n_cx * cw), int)
    cx_idx = np.ones((n_cy * ch, 1), int) * np.repeat(np.arange(n_cx), cw)[None, :]
    np.add.at(hist, (cy_idx, cx_idx, b0), mag * (1 - frac))
    np.add.at(hist, (cy_idx, cx_idx, b1), mag * frac)
    blocks = []
    for by in range(n_cy - bh + 1):
        for bx in range(n_cx - bw + 1):
            v = hist[by : by + bh, bx : bx + bw].ravel()
            v = v / np.sqrt(np.sum(v**2) + 1e-12)
            v = np.minimum(v, 0.2)
            v = v / np.sqrt(np.sum(v**2) + 1e-12)
            blocks.append(v)
    return np.concatenate(blocks) if blocks else np.zeros(0)


LBP_WEIGHT_SCALE = 1024  # 10-bit fixed-point bilinear weights


def lbp_histogram(gray: np.ndarray, P: int = 24, R: float = 3.0) -> np.ndarray:
    """Uniform LBP histogram with P+2 bins (26 for P=24).

    Exact-arithmetic contract: the image is quantized to 8-bit levels
    (lossless for PNG/JPEG-decoded inputs) and the bilinear weights to
    10-bit fixed point, so the neighbour >= centre test
    ``sum_c wq_c * (Q_c - Q_center) >= 0`` is a sum of exact integers below
    2^24: the same bit comes out of float32 under any summation order, FMA
    contraction or device. ``ops.imgdsp.lbp_histogram_batch`` shares the
    arithmetic; the tests hold the two together bit for bit."""
    H, W = gray.shape
    q = np.rint(np.asarray(gray, np.float32) * 255.0).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    angles = 2 * np.pi * np.arange(P) / P
    count_ones = np.zeros((H, W), int)
    transitions = np.zeros((H, W), int)
    prev_bit = None
    first_bit = None
    for k in range(P):
        dy, dx = -R * np.sin(angles[k]), R * np.cos(angles[k])
        yy = np.clip(ys + dy, 0, H - 1)
        xx = np.clip(xs + dx, 0, W - 1)
        y0, x0 = np.floor(yy).astype(int), np.floor(xx).astype(int)
        y1, x1 = np.minimum(y0 + 1, H - 1), np.minimum(x0 + 1, W - 1)
        fy, fx = yy - y0, xx - x0
        w11, w10 = fy * fx, fy * (1 - fx)
        w01, w00 = (1 - fy) * fx, (1 - fy) * (1 - fx)
        s = LBP_WEIGHT_SCALE
        delta = (
            np.rint(w00 * s).astype(np.float32) * (q[y0, x0] - q)
            + np.rint(w10 * s).astype(np.float32) * (q[y1, x0] - q)
            + np.rint(w01 * s).astype(np.float32) * (q[y0, x1] - q)
            + np.rint(w11 * s).astype(np.float32) * (q[y1, x1] - q)
        )
        bit = (delta >= 0).astype(int)
        count_ones += bit
        if prev_bit is not None:
            transitions += bit != prev_bit
        else:
            first_bit = bit
        prev_bit = bit
    transitions += prev_bit != first_bit
    uniform = transitions <= 2
    codes = np.where(uniform, count_ones, P + 1)  # non-uniform -> last bin
    hist = np.bincount(codes.ravel(), minlength=P + 2).astype(np.float64)
    return (hist / hist.sum()).astype(np.float32)


def glcm_stats(gray: np.ndarray, levels: int = 32) -> np.ndarray:
    """Gray co-occurrence (distance 1, angle 0) -> 6 Haralick stats."""
    q = np.clip((gray * levels).astype(int), 0, levels - 1)
    a, b = q[:, :-1].ravel(), q[:, 1:].ravel()
    glcm = np.zeros((levels, levels))
    np.add.at(glcm, (a, b), 1.0)
    glcm = glcm + glcm.T  # symmetric
    glcm /= max(glcm.sum(), 1.0)
    i, j = np.mgrid[0:levels, 0:levels]
    diff = (i - j).astype(np.float64)
    contrast = float((glcm * diff**2).sum())
    dissim = float((glcm * np.abs(diff)).sum())
    homog = float((glcm / (1.0 + diff**2)).sum())
    asm = float((glcm**2).sum())
    energy = float(np.sqrt(asm))
    mu_i = float((glcm * i).sum())
    mu_j = float((glcm * j).sum())
    si = np.sqrt((glcm * (i - mu_i) ** 2).sum())
    sj = np.sqrt((glcm * (j - mu_j) ** 2).sum())
    corr = float((glcm * (i - mu_i) * (j - mu_j)).sum() / (si * sj)) if si > 0 and sj > 0 else 1.0
    return np.array([contrast, dissim, homog, energy, corr, asm], dtype=np.float32)


def classical_image_vector(gray: np.ndarray, orientations: int = 9, cell=8,
                           block=2, lbp_points: int = 24, lbp_radius: float = 3.0,
                           n_hist_bins: int = 64) -> np.ndarray:
    hog = hog_features(gray, orientations=orientations, cell=cell, block=block)
    lbp = lbp_histogram(gray, P=lbp_points, R=lbp_radius)
    hist, _ = np.histogram(gray, bins=n_hist_bins, range=(0.0, 1.0))
    hist = hist.astype(np.float32) / max(hist.sum(), 1)
    glcm = glcm_stats(gray)
    return np.concatenate([hog, lbp, hist, glcm]).astype(np.float32)


def make_classical_batch_fn(ext):
    """(B, H, W) tensor -> (B, D) HOG/LBP/GLCM/hist stack over ``ext``'s
    descriptor knobs: one factory for the image and video classical
    extractors, so the knob plumbing cannot drift between them."""
    from ..ops import imgdsp

    def run(gray: torch.Tensor) -> torch.Tensor:
        return imgdsp.classical_image_vector_batch(
            gray,
            orientations=ext.hog_orientations,
            cell=ext.hog_pixels_per_cell,
            block=ext.hog_cells_per_block,
            lbp_points=ext.lbp_n_points,
            lbp_radius=ext.lbp_radius,
            n_hist_bins=ext.n_hist_bins,
        )

    return run


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (int, float)):
        return int(v), int(v)
    a, b = v
    return int(a), int(b)


@register
class ImageClassicalExtractor(BaseFeatureExtractor):
    """HOG + LBP + gray-hist + GLCM flat vector (8196-d at 128x128);
    ``image_size`` is a scalar alias of ``resize_to``."""

    name = "image_classical"
    feature_type = "classical"
    modality = "image"
    batch_size = 256

    def __init__(self, resize_to=(128, 128), hog_orientations: int = 9,
                 hog_pixels_per_cell=(8, 8), hog_cells_per_block=(2, 2),
                 lbp_n_points: int = 24, lbp_radius: float = 3.0,
                 n_hist_bins: int = 64, image_size: Optional[int] = None,
                 device: torch.device | str | None = None) -> None:
        self.resize_to = _pair(image_size if image_size is not None else resize_to)
        self.image_size = self.resize_to[0]
        self.hog_orientations = hog_orientations
        self.hog_pixels_per_cell = _pair(hog_pixels_per_cell)
        self.hog_cells_per_block = _pair(hog_cells_per_block)
        self.lbp_n_points = lbp_n_points
        self.lbp_radius = lbp_radius
        self.n_hist_bins = n_hist_bins
        self.device = resolve_device(device)

    def extract(self, sample_path, bbox_norm=None, **_kw) -> np.ndarray:
        gray = _load_gray(sample_path, self.resize_to, bbox_norm)
        return classical_image_vector(
            gray, orientations=self.hog_orientations, cell=self.hog_pixels_per_cell,
            block=self.hog_cells_per_block, lbp_points=self.lbp_n_points,
            lbp_radius=self.lbp_radius, n_hist_bins=self.n_hist_bins,
        )

    # None = auto: the batched path on a CUDA device, the per-sample numpy
    # path on the CPU
    use_device_batch: Optional[bool] = None

    def extract_dataset(self, loader, max_samples=None):
        """Decode and resize on host threads, then the descriptor stack in
        batches of ``batch_size`` on ``device``."""
        if not auto_device_batch(self.use_device_batch, self.device):
            return super().extract_dataset(loader, max_samples)
        return _device_batched_dataset(
            loader,
            max_samples,
            decode=lambda p, meta: _load_gray(p, self.resize_to, meta.get("bbox_norm")),
            pack=lambda decoded: pad_stack(decoded, self.batch_size),
            run=make_classical_batch_fn(self),
            unpack=lambda out, decoded: out[: len(decoded)],
            chunk=self.batch_size,
            feature_type=self.feature_type,
            modality=self.modality,
            device=self.device,
        )


@register
class ImagePixels(BaseFeatureExtractor):
    """Normalized pixel grid (H, W, C) in [0, 1], decoded on the host."""

    name = "image_pixels"
    feature_type = "deep"
    modality = "image"

    def __init__(self, image_size: Optional[int] = None, grayscale: Optional[bool] = None,
                 resize_to=(64, 64), as_gray: Optional[bool] = None,
                 device: torch.device | str | None = None) -> None:
        # resize_to / as_gray are the reference's knob names; image_size /
        # grayscale are aliases
        self.resize_to = _pair(image_size if image_size is not None else resize_to)
        self.image_size = self.resize_to[0]
        self.grayscale = grayscale if grayscale is not None else (
            as_gray if as_gray is not None else True
        )
        self.device = resolve_device(device)

    def extract(self, sample_path, bbox_norm=None, **_kw) -> np.ndarray:
        if self.grayscale:
            return _load_gray(sample_path, self.resize_to, bbox_norm)[..., None]
        return _load_rgb(sample_path, self.resize_to, bbox_norm)


@register
class ImageMobileNetV2(BaseFeatureExtractor):
    """MobileNetV2 pooled embedding (1280,) from ``models/backbones.py``'s
    frozen embedder (see there for weights); input scaled to [-1, 1]."""

    name = "image_mobilenet_v2"
    feature_type = "deep"
    modality = "image"

    def __init__(self, image_size: Optional[int] = None, weights: Optional[str] = None,
                 batch_size: int = 32, input_size=(224, 224), trainable: bool = False,
                 device: torch.device | str | None = None) -> None:
        # trainable is accepted so reference configs load; the embedder is
        # frozen either way
        self.image_size = int(image_size if image_size is not None else _pair(input_size)[0])
        self.weights = weights
        self.batch_size = batch_size
        self.trainable = trainable
        self.device = resolve_device(device)

    def _embedder(self):
        from ..models.backbones import mobilenet_v2_embedder

        return mobilenet_v2_embedder(self.image_size, self.weights, device=self.device)

    def _preprocess(self, sample_path, bbox_norm):
        rgb = _load_rgb(sample_path, (self.image_size, self.image_size), bbox_norm)
        return rgb * 2.0 - 1.0

    def extract(self, sample_path, bbox_norm=None, **_kw) -> np.ndarray:
        x = torch.from_numpy(self._preprocess(sample_path, bbox_norm)[None]).to(self.device)
        with torch.inference_mode():
            return self._embedder()(x)[0].cpu().numpy().astype(np.float32)

    def extract_dataset(self, loader, max_samples=None):
        """Decode on host threads, embed in batches of ``batch_size``."""
        return _device_batched_dataset(
            loader,
            max_samples,
            decode=lambda p, meta: self._preprocess(p, meta.get("bbox_norm")),
            pack=lambda decoded: pad_stack(decoded, self.batch_size),
            run=self._embedder(),
            unpack=lambda out, decoded: out[: len(decoded)],
            chunk=self.batch_size,
            feature_type=self.feature_type,
            modality=self.modality,
            device=self.device,
        )
