"""Core abstractions of the feature layer.

Same public surface as the JAX package's ``features/base.py`` (FeatureSet /
BaseFeatureExtractor / BaseDatasetLoader / BatchedAudioExtractor, and the
batched image and video path: ``auto_device_batch``, ``pad_stack``,
``_device_batched_dataset``). The batched paths decode on a host thread
pool while the previous chunk runs on the device, in fixed-shape chunks;
an audio chunk splits over the extractor's cards (``_device_batch``).
"""

from __future__ import annotations

import contextlib
import logging
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import cards, split_parts
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class FeatureSet:
    """Uniform feature container (labels None => unsupervised; -1 =>
    unlabelled in semi-supervised sets), field-compatible with the JAX
    package's container and its on-disk directory format."""

    features: np.ndarray  # (N, *feature_dims)
    feature_type: str  # "classical" | "deep"
    modality: str  # "audio" | "image" | "text" | "tabular" | "video"
    metadata: list[dict]
    labels: Optional[np.ndarray] = None
    label_names: Optional[list[str]] = None
    cluster_assignments: Optional[np.ndarray] = None

    @property
    def n_samples(self) -> int:
        return len(self.features)

    @property
    def feature_shape(self) -> tuple:
        return self.features.shape[1:]

    @property
    def is_supervised(self) -> bool:
        return self.labels is not None

    @property
    def n_classes(self) -> Optional[int]:
        if self.label_names is not None:
            return len(self.label_names)
        if self.labels is not None:
            return int(self.labels.max()) + 1
        return None

    def to_sklearn(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """(X, y): ground-truth labels, else cluster assignments, else None."""
        if self.labels is not None:
            return self.features, self.labels
        if self.cluster_assignments is not None:
            return self.features, self.cluster_assignments
        return self.features, None

    def to_torch(self, device: torch.device | str) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Tensors (features f32, labels int32 | None) on ``device``."""
        x = torch.as_tensor(self.features, dtype=torch.float32).to(device)
        y = None if self.labels is None else torch.as_tensor(self.labels, dtype=torch.int32).to(device)
        return x, y

    def __repr__(self) -> str:
        label_info = f"labels={self.n_classes} classes" if self.is_supervised else "unsupervised"
        return (
            f"FeatureSet(modality={self.modality!r}, feature_type={self.feature_type!r}, "
            f"n_samples={self.n_samples}, feature_shape={self.feature_shape}, {label_info})"
        )


class BaseDatasetLoader(ABC):
    """Iterating yields (sample_path | None, label | None, metadata dict)."""

    @abstractmethod
    def __iter__(self) -> Iterator[tuple[Optional[Path], Optional[str], dict]]: ...

    @abstractmethod
    def __len__(self) -> int: ...


def _collect(
    all_features: list[np.ndarray],
    all_labels: list[int],
    all_meta: list[dict],
    label_to_idx: dict[str, int],
    feature_type: str,
    modality: str,
) -> FeatureSet:
    if not all_features:
        raise RuntimeError("No features were successfully extracted.")
    features = np.stack(all_features)
    if all_labels and len(all_labels) != len(all_features):
        # a partially-labelled dataset would silently shift every label
        # after the first unlabelled sample onto the wrong row
        raise ValueError(
            f"{len(all_labels)} label(s) for {len(all_features)} samples — "
            "the dataset mixes labelled and unlabelled items; label all "
            "samples or none."
        )
    labels = np.array(all_labels, dtype=np.int32) if all_labels else None
    label_names = (
        [k for k, _ in sorted(label_to_idx.items(), key=lambda kv: kv[1])] if label_to_idx else None
    )
    return FeatureSet(
        features=features,
        feature_type=feature_type,
        modality=modality,
        metadata=all_meta,
        labels=labels,
        label_names=label_names,
    )


def _overlap_device(chunks, process):
    """Depth-1 software pipeline: yield ``(chunk, process(chunk))`` in
    order, running ``process`` (pack + device dispatch + blocking fetch) on
    a single-slot device thread. Advancing ``chunks`` — where the caller
    decodes — happens while the previous chunk computes, so host decode
    overlaps device work with at most ONE chunk in flight."""
    with ThreadPoolExecutor(max_workers=1) as device_thread:
        pending = None
        for good in chunks:
            fut = device_thread.submit(process, good)
            if pending is not None:
                yield pending[1], pending[0].result()
            pending = (fut, good)
        if pending is not None:
            yield pending[1], pending[0].result()


def auto_device_batch(flag: Optional[bool], device: torch.device) -> bool:
    """None = auto: the batched device path when ``device`` is a CUDA card,
    the per-sample numpy path on the CPU (the path the caller's device
    names, as in JAX where the CPU backend takes the numpy path)."""
    if flag is not None:
        return flag
    return device.type == "cuda"


def pad_stack(decoded: list[np.ndarray], batch: int) -> np.ndarray:
    """Stack per-item arrays and zero-pad the leading axis to ``batch`` so
    every device call sees one shape (padded rows are computed and
    discarded by the caller)."""
    x = np.stack(decoded)
    pad = batch - len(x)
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


def _device_batched_dataset(
    loader: BaseDatasetLoader,
    max_samples: Optional[int],
    decode,  # (path, meta) -> decoded array; raises to skip the sample
    pack,  # list[decoded] -> fixed-shape numpy input
    run,  # input tensor on ``device`` -> output tensor
    unpack,  # (numpy output, list[decoded]) -> per-item feature vectors
    chunk: int,
    feature_type: str,
    modality: str,
    device: torch.device,
    workers: int = 8,
) -> FeatureSet:
    """The chunked decode -> pad -> device -> collect loop of the batched
    extractor paths (image and video descriptors, backbone embeddings):
    host threads decode with skip-and-continue, the device runs each packed
    chunk while the next one decodes (``_overlap_device``), and labels
    intern in first-occurrence order as BaseFeatureExtractor.extract_dataset
    interns them."""
    samples = []
    for i, item in enumerate(loader):
        if max_samples is not None and i >= max_samples:
            break
        samples.append(item)

    feats: list[np.ndarray] = []
    labels: list[int] = []
    metas: list[dict] = []
    label_to_idx: dict[str, int] = {}

    def _decode(item):
        path, label, meta = item
        try:
            out = decode(path, meta)
        except Exception as exc:
            logger.warning("Skipping %s: %s", path, exc)
            return None, label, meta
        if out is None or (hasattr(out, "__len__") and len(out) == 0):
            logger.warning("Skipping %s: empty decode", path)
            return None, label, meta
        return out, label, meta

    def _process(good):
        decoded = [g for g, _, _ in good]
        x = torch.from_numpy(np.ascontiguousarray(pack(decoded))).to(device)
        with torch.inference_mode():
            out = run(x).cpu().numpy()
        return unpack(out, decoded)

    with ThreadPoolExecutor(max_workers=workers) as pool:

        def _chunks():
            for s in range(0, len(samples), chunk):
                out = list(pool.map(_decode, samples[s : s + chunk]))
                good = [(g, l, m) for g, l, m in out if g is not None]
                if good:
                    yield good

        for good, vecs in _overlap_device(_chunks(), _process):
            for vec, (_, label, meta) in zip(vecs, good):
                feats.append(np.asarray(vec, np.float32))
                metas.append(meta)
                if label is not None:
                    if label not in label_to_idx:
                        label_to_idx[label] = len(label_to_idx)
                    labels.append(label_to_idx[label])
    return _collect(feats, labels, metas, label_to_idx, feature_type, modality)


class BaseFeatureExtractor(ABC):
    """Extractor ABC. Subclasses set ``name`` / ``feature_type`` /
    ``modality`` and implement ``extract``. ``extract_dataset`` is the
    skip-and-continue loop with first-occurrence label interning."""

    name: str
    feature_type: str
    modality: str

    @abstractmethod
    def extract(self, sample_path: Optional[Path], **kwargs) -> np.ndarray: ...

    def extract_dataset(self, loader: BaseDatasetLoader, max_samples: Optional[int] = None) -> FeatureSet:
        all_features: list[np.ndarray] = []
        all_labels: list[int] = []
        all_meta: list[dict] = []
        label_to_idx: dict[str, int] = {}
        for i, (sample_path, label, meta) in enumerate(loader):
            if max_samples is not None and i >= max_samples:
                break
            try:
                feat = self.extract(sample_path, **meta)
            except Exception as exc:
                logger.warning("Skipping %s: %s", sample_path, exc)
                continue
            all_features.append(np.asarray(feat))
            all_meta.append(meta)
            if label is not None:
                if label not in label_to_idx:
                    label_to_idx[label] = len(label_to_idx)
                all_labels.append(label_to_idx[label])
        return _collect(all_features, all_labels, all_meta, label_to_idx, self.feature_type, self.modality)


class BatchedAudioExtractor(BaseFeatureExtractor):
    """Audio extractor with a batched device path on one device.

    Subclasses set ``self.device`` and implement:
      - ``target_samples()`` -> int | None  (fixed clip length, or None)
      - ``min_samples()`` -> int            (zero-pad floor per clip)
      - ``batch_feature(waves (B, n) f32, lengths (B,) int64 | None)`` ->
        (B, ...) tensor, both on ``self.device``; when lengths is not None
        the padded region must be masked out of per-clip reductions
      - ``frames_for(n_samples)`` -> per-clip time size (for trimming), or
        None for non-framed outputs

    ``extract_dataset`` pipelines host WAV decode + resample on a thread
    pool while the previous batch runs on the device.
    """

    modality = "audio"
    sample_rate: int
    device: torch.device
    duration: Optional[float] = None
    batch_size: int = 256
    decode_workers: int = 8
    # Masked padded batches are exact for per-frame features (mel, mfcc_seq:
    # per-frame ops + masked reductions). Features with cross-frame
    # couplings (savgol deltas, per-band sorts in the classical stack) are
    # contaminated near the valid/pad boundary, so those extractors set
    # exact_length_batching: clips are grouped by exact length and each
    # group runs unmasked.
    exact_length_batching: bool = False

    # -- subclass hooks -------------------------------------------------
    def target_samples(self) -> Optional[int]:
        if self.duration is None:
            return None
        return int(self.duration * self.sample_rate)

    def min_samples(self) -> int:
        return 1

    def frames_for(self, n_samples: int) -> Optional[int]:
        return None

    def batch_feature(self, waves: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    # -- single-sample API ----------------------------------------------
    def _load_clip(self, sample_path, start_time=None, end_time=None, min_duration: float = 0.1):
        from ..data.audio_io import load_audio

        offset = float(start_time) if start_time is not None else 0.0
        duration = None
        if end_time is not None:
            duration = max(float(end_time) - offset, min_duration)
        y, _ = load_audio(sample_path, sr=self.sample_rate, offset=offset, duration=duration)
        tgt = self.target_samples()
        if tgt is not None:
            y = y[:tgt] if len(y) >= tgt else np.pad(y, (0, tgt - len(y)))
        if len(y) < self.min_samples():
            y = np.pad(y, (0, self.min_samples() - len(y)))
        return y

    def extract(self, sample_path, start_time=None, end_time=None, **_kw) -> np.ndarray:
        y = self._load_clip(sample_path, start_time, end_time)
        return self._device_batch(y[None, :], None)[0].astype(np.float32)

    def _set_devices(self, device, devices=None) -> None:
        """``device`` and the ``devices`` a batch splits over: the given list
        (its first the ``device``), else ``[device]`` when the caller pins
        one, else every visible card (the JAX package shards the batch over
        every device)."""
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
            self.device = self.devices[0]
            return
        self.device = resolve_device(device)
        self.devices = cards() if device is None else [self.device]

    # -- batched dataset path -------------------------------------------
    def _device_batch(self, waves: np.ndarray, lengths: Optional[np.ndarray]) -> np.ndarray:
        """Copy one host batch to the device, run batch_feature, fetch; with
        several ``devices``, contiguous rows a device, each part computed
        under its own card (its own mel kernel launch), every part issued
        before any is fetched, the rows concatenated in order."""
        devices = getattr(self, "devices", None) or [self.device]
        # row ranges, sliced (views, no copy of the host batch)
        bounds = [(p[0], p[-1] + 1) for p in split_parts(len(waves), len(devices))] or [(0, 0)]
        outs = []
        with torch.inference_mode():
            for (lo, hi), dev in zip(bounds, [self.device] if len(bounds) == 1 else devices):
                waves_d = torch.from_numpy(np.ascontiguousarray(waves[lo:hi], dtype=np.float32)).to(dev)
                lengths_d = None if lengths is None else torch.from_numpy(np.asarray(lengths, np.int64)[lo:hi]).to(dev)
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    outs.append(self.batch_feature(waves_d, lengths_d))
            outs = [o.cpu().numpy() for o in outs]
            return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _exact_length_groups(self, good: list) -> list[np.ndarray]:
        """One unmasked device batch per distinct clip length in ``good``,
        its rows padded to a power of two capped at ``batch_size`` so that
        group sizes repeat from chunk to chunk. Only for extractors whose
        output shape does not depend on the length (flat vectors): framed
        outputs would be ragged across groups."""
        if self.frames_for(self.min_samples()) is not None:
            raise TypeError(
                f"{self.name}: exact_length_batching requires a "
                "length-independent output shape (frames_for must return None)"
            )
        feat_per_item: list = [None] * len(good)
        groups: dict[int, list[int]] = {}
        for j, (y, _, _) in enumerate(good):
            groups.setdefault(len(y), []).append(j)
        if len(groups) > 16 and not getattr(self, "_warned_lengths", False):
            self._warned_lengths = True
            logger.warning(
                "%s: %d distinct clip lengths in one batch, one device batch each. "
                "Pass duration=... (pad/trim) to fix the shape.",
                self.name, len(groups),
            )
        for length, idxs in sorted(groups.items()):
            rows = len(idxs)
            waves = np.zeros((max(rows, min(self.batch_size, 1 << (rows - 1).bit_length())), length), np.float32)
            for k, j in enumerate(idxs):
                waves[k] = good[j][0]
            feats = self._device_batch(waves, None).astype(np.float32)
            for k, j in enumerate(idxs):
                feat_per_item[j] = feats[k]
        return feat_per_item

    def _pad_bucket(self, n: int) -> int:
        """Round variable lengths up to 1 s steps to bound the shape count."""
        step = self.sample_rate
        return int(-(-n // step) * step)

    def extract_dataset(self, loader: BaseDatasetLoader, max_samples: Optional[int] = None) -> FeatureSet:
        samples = []
        for i, item in enumerate(loader):
            if max_samples is not None and i >= max_samples:
                break
            samples.append(item)

        all_features: list[np.ndarray] = []
        all_labels: list[int] = []
        all_meta: list[dict] = []
        label_to_idx: dict[str, int] = {}
        tgt = self.target_samples()

        def decode(item):
            path, label, meta = item
            try:
                y = self._load_clip(path, meta.get("start_time"), meta.get("end_time"))
                return y, label, meta, None
            except Exception as exc:  # skip-and-continue
                return None, label, meta, (path, exc)

        def process(good):
            """Pack + device dispatch + fetch for one decoded chunk; runs on
            the single-slot device thread so the main thread can decode the
            next chunk while this one computes."""
            if tgt is not None:
                # fixed (batch_size, tgt) shape for every chunk (short final
                # chunks are zero-row-padded): one shape per extractor config
                rows = len(good)
                waves = np.zeros((self.batch_size, tgt), np.float32)
                for j, (y, _, _) in enumerate(good):
                    waves[j, : len(y)] = y[:tgt]
                feats = self._device_batch(waves, None).astype(np.float32)[:rows]
                return list(feats)
            if self.exact_length_batching:
                return self._exact_length_groups(good)
            # rows fixed at batch_size; pad rows carry a FULL-length mask
            # over all-zero audio and are sliced away below. Sample dim
            # bucketed to 1 s steps
            max_n = self._pad_bucket(max(len(y) for y, _, _ in good))
            waves = np.zeros((self.batch_size, max_n), np.float32)
            lens = np.full(self.batch_size, max_n, np.int64)
            for j, (y, _, _) in enumerate(good):
                waves[j, : len(y)] = y
                lens[j] = len(y)
            feats = self._device_batch(waves, lens).astype(np.float32)
            feat_per_item = []
            for j in range(len(good)):
                f = feats[j]
                t = self.frames_for(int(lens[j]))
                if t is not None:
                    f = f[..., :t]
                elif f.ndim == 1 and f.shape[0] == waves.shape[1]:
                    f = f[: int(lens[j])]  # waveform features
                feat_per_item.append(f)
            return feat_per_item

        with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:

            def chunks():
                for start in range(0, len(samples), self.batch_size):
                    decoded = list(pool.map(decode, samples[start : start + self.batch_size]))
                    for y, l, m, err in decoded:
                        if err is not None:
                            logger.warning("Skipping %s: %s", err[0], err[1])
                    good = [(y, l, m) for y, l, m, err in decoded if y is not None]
                    if good:
                        yield good

            for good, feat_per_item in _overlap_device(chunks(), process):
                for feat, (_, label, meta) in zip(feat_per_item, good):
                    all_features.append(np.ascontiguousarray(feat))
                    all_meta.append(meta)
                    if label is not None:
                        if label not in label_to_idx:
                            label_to_idx[label] = len(label_to_idx)
                        all_labels.append(label_to_idx[label])

        return _collect(all_features, all_labels, all_meta, label_to_idx, self.feature_type, self.modality)
