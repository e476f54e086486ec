"""Registered video extractors: ``video_classical``, ``video_frame_seq`` and
``video_mobilenet_v2_seq``.

Same names, parameters, defaults and numerical contracts as the JAX
package's ``features/video.py``, plus a ``device`` argument: evenly sampled
frames decoded with cv2, per-frame classical descriptors aggregated over time
(with optional Farneback optical-flow statistics, on the host), raw frame
sequences, and per-frame MobileNetV2 embedding sequences. On a CUDA card,
``video_classical.extract_dataset`` runs the per-frame descriptors of a
chunk of videos as one batch on the card (``ops/imgdsp.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import BaseFeatureExtractor, _device_batched_dataset, auto_device_batch
from .image import _pair, classical_image_vector, make_classical_batch_fn
from .registry import register


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError("the video extractors decode with OpenCV (cv2), which is not installed") from exc
    return cv2


def _open_and_sample(path: Path, max_frames: int, size: tuple[int, int], gray: bool):
    """Decode up to max_frames evenly spaced frames -> (T, H, W[, 3]) float32 [0,1]."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"Cannot open video: {path}")
    n_total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
    if n_total <= 0:
        # streaming: read everything, then subsample
        frames_all = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames_all.append(frame)
        cap.release()
        if not frames_all:
            raise IOError(f"No frames decoded: {path}")
        idxs = np.linspace(0, len(frames_all) - 1, min(max_frames, len(frames_all))).astype(int)
        raw = [frames_all[i] for i in idxs]
    else:
        idxs = np.linspace(0, n_total - 1, min(max_frames, n_total)).astype(int)
        raw = []
        for i in idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
            ok, frame = cap.read()
            if ok:
                raw.append(frame)
        cap.release()
        if not raw:
            raise IOError(f"No frames decoded: {path}")
    out = []
    for frame in raw:
        frame = cv2.resize(frame, size)
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY if gray else cv2.COLOR_BGR2RGB)
        out.append(frame.astype(np.float32) / 255.0)
    return np.stack(out)


@register
class VideoClassicalExtractor(BaseFeatureExtractor):
    """Per-frame HOG+LBP+hist+GLCM, mean+std over time; optional Farneback
    optical-flow magnitude statistics."""

    name = "video_classical"
    feature_type = "classical"
    modality = "video"

    def __init__(self, max_frames: int = 16, frame_size: Optional[int] = None,
                 optical_flow: bool = False, resize_to=(64, 64),
                 hog_orientations: int = 9, hog_pixels_per_cell=(16, 16),
                 hog_cells_per_block=(2, 2), lbp_n_points: int = 24,
                 lbp_radius: float = 3.0, n_hist_bins: int = 64,
                 device: torch.device | str | None = None) -> None:
        # frame_size is a scalar alias of resize_to
        self.max_frames = max_frames
        self.resize_to = _pair(frame_size if frame_size is not None else resize_to)
        self.frame_size = self.resize_to[0]
        self.optical_flow = optical_flow
        self.hog_orientations = hog_orientations
        self.hog_pixels_per_cell = _pair(hog_pixels_per_cell)
        self.hog_cells_per_block = _pair(hog_cells_per_block)
        self.lbp_n_points = lbp_n_points
        self.lbp_radius = lbp_radius
        self.n_hist_bins = n_hist_bins
        self.device = resolve_device(device)

    def extract(self, sample_path, **_kw) -> np.ndarray:
        frames = _open_and_sample(sample_path, self.max_frames, self.resize_to, gray=True)
        per_frame = np.stack([
            classical_image_vector(
                f, orientations=self.hog_orientations, cell=self.hog_pixels_per_cell,
                block=self.hog_cells_per_block, lbp_points=self.lbp_n_points,
                lbp_radius=self.lbp_radius, n_hist_bins=self.n_hist_bins,
            )
            for f in frames
        ])  # (T, D)
        return self._finalize(per_frame, frames)

    def _finalize(self, per_frame: np.ndarray, frames: np.ndarray) -> np.ndarray:
        feat = np.concatenate([per_frame.mean(axis=0), per_frame.std(axis=0)])
        if self.optical_flow and len(frames) >= 2:
            cv2 = _cv2()
            mags = []
            prev = (frames[0] * 255).astype(np.uint8)
            for f in frames[1:]:
                cur = (f * 255).astype(np.uint8)
                flow = cv2.calcOpticalFlowFarneback(prev, cur, None, 0.5, 3, 15, 3, 5, 1.2, 0)
                mags.append(np.linalg.norm(flow, axis=-1))
                prev = cur
            m = np.stack(mags)
            flow_stats = np.array(
                [
                    m.mean(), m.std(), m.max(), np.median(m),
                    np.percentile(m, 90), np.percentile(m, 10),
                    m.mean(axis=(1, 2)).std(),  # temporal variation
                    float((m > m.mean()).mean()),
                    m.sum(axis=(1, 2)).max() / (m.shape[1] * m.shape[2]),
                    float(len(mags)),
                ],
                dtype=np.float32,
            )
            feat = np.concatenate([feat, flow_stats])
        return feat.astype(np.float32)

    # None = auto: the batched path on a CUDA device, the per-sample numpy
    # path on the CPU
    use_device_batch: Optional[bool] = None
    videos_per_chunk = 8  # frames per device batch = this * max_frames

    def extract_dataset(self, loader, max_samples=None):
        """cv2 decode on host threads, the per-frame descriptors of a chunk
        of videos as one batch on ``device``; the time statistics and the
        optical flow stay on the host, as in the per-sample path."""
        if not auto_device_batch(self.use_device_batch, self.device):
            return super().extract_dataset(loader, max_samples)
        chunk = self.videos_per_chunk

        def pack(decoded):
            # every video padded to max_frames (padded rows are discarded)
            padded = np.zeros((chunk, self.max_frames) + self.resize_to[::-1], np.float32)
            for j, f in enumerate(decoded):
                padded[j, : len(f)] = f
            return padded.reshape((-1,) + padded.shape[2:])

        def unpack(out, decoded):
            vecs = out.reshape(chunk, self.max_frames, -1)
            return [self._finalize(vecs[j, : len(f)], f) for j, f in enumerate(decoded)]

        return _device_batched_dataset(
            loader,
            max_samples,
            decode=lambda p, meta: _open_and_sample(p, self.max_frames, self.resize_to, gray=True),
            pack=pack,
            run=make_classical_batch_fn(self),
            unpack=unpack,
            chunk=chunk,
            feature_type=self.feature_type,
            modality=self.modality,
            device=self.device,
        )


@register
class VideoFrameSequence(BaseFeatureExtractor):
    """(T, H, W, C) normalized frame stack, zero-padded to max_frames."""

    name = "video_frame_seq"
    feature_type = "deep"
    modality = "video"

    def __init__(self, max_frames: int = 16, frame_size: Optional[int] = None,
                 grayscale: Optional[bool] = None, resize_to=(64, 64),
                 as_gray: Optional[bool] = None, device: torch.device | str | None = None) -> None:
        self.max_frames = max_frames
        self.resize_to = _pair(frame_size if frame_size is not None else resize_to)
        self.frame_size = self.resize_to[0]
        self.grayscale = grayscale if grayscale is not None else bool(as_gray)
        self.device = resolve_device(device)

    def extract(self, sample_path, **_kw) -> np.ndarray:
        frames = _open_and_sample(sample_path, self.max_frames, self.resize_to, gray=self.grayscale)
        if self.grayscale:
            frames = frames[..., None]
        if len(frames) < self.max_frames:
            pad = np.zeros((self.max_frames - len(frames),) + frames.shape[1:], frames.dtype)
            frames = np.concatenate([frames, pad])
        return frames.astype(np.float32)


@register
class VideoMobileNetV2Sequence(BaseFeatureExtractor):
    """(T, 1280) per-frame MobileNetV2 embeddings; the frames of a video run
    as one batch through the embedder on ``device``."""

    name = "video_mobilenet_v2_seq"
    feature_type = "deep"
    modality = "video"

    def __init__(self, max_frames: int = 16, image_size: Optional[int] = None,
                 weights: Optional[str] = None, input_size=(224, 224),
                 trainable: bool = False, device: torch.device | str | None = None) -> None:
        self.max_frames = max_frames
        self.image_size = int(image_size if image_size is not None else _pair(input_size)[0])
        self.weights = weights
        self.trainable = trainable
        self.device = resolve_device(device)

    def extract(self, sample_path, **_kw) -> np.ndarray:
        from ..models.backbones import mobilenet_v2_embedder

        embed = mobilenet_v2_embedder(self.image_size, self.weights, device=self.device)
        frames = _open_and_sample(sample_path, self.max_frames, (self.image_size, self.image_size), gray=False)
        x = frames * 2.0 - 1.0
        if len(x) < self.max_frames:
            x = np.concatenate([x, np.zeros((self.max_frames - len(x),) + x.shape[1:], x.dtype)])
        with torch.inference_mode():
            return embed(torch.from_numpy(x).to(self.device)).cpu().numpy().astype(np.float32)
