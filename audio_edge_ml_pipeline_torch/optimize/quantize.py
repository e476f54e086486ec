"""Quantization emulation + model benchmarking utilities.

Counterpart of the JAX package's ``optimize/quantize.py``, with the same
artifacts bit for bit:

- deep (.npz flax bundles): per-tensor symmetric INT8 weights (dynamic), the
  same plus calibrated INT8 input quantization (static; 50-sample
  calibration), and fp16 / bf16 casts. Quantized artifacts are materialized
  on disk so reported sizes are real file sizes.
- classical (npz, or legacy joblib): generic fake quantization of every float
  array reachable from the trainer (support vectors, coefficients, PCA
  bases, kNN reference sets, ...), with artifact size accounted as original
  bytes minus the float-array savings.

The quantization arithmetic runs in numpy float64 on the host, as in JAX.
bfloat16 rounding goes through torch's round-to-nearest-even cast on the
host (numpy has no bfloat16); the artifact stores the bits as uint16.

``evaluate_model`` measures accuracy/f1 and mean per-sample latency over one
batched ``predict`` on the trainer's device.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models import get_model
from ..models.base import BaseTrainer
from ..models.deep import MODEL_FILENAME, load_any_model, load_model_bundle, save_model_bundle_flat
from ..train.evaluate import compute_metrics

logger = logging.getLogger(__name__)

CALIBRATION_SAMPLES = 50


def find_model_file(artifact_uri: str, model_name: str) -> Path:
    """Locate the serialized model inside a run's artifact/output dir."""
    base = Path(artifact_uri)
    candidates = [
        base / MODEL_FILENAME,
        base / f"{model_name}.joblib",
        base / f"{model_name}.npz",
    ]
    for c in candidates:
        if c.exists():
            return c
    for pattern in ("*.flax.npz", "*.joblib", "*.npz"):
        hits = sorted(base.glob(pattern))
        if hits:
            return hits[0]
    raise FileNotFoundError(f"No model file found under {base}")


def _is_deep_path(path: Path) -> bool:
    return path.name.endswith(".flax.npz") or path.name == MODEL_FILENAME


def load_trainer_any(path: Path, model_name: str, device: torch.device | str | None = None) -> BaseTrainer:
    """The trainer saved at ``path``, on ``device`` (None: the first CUDA
    card, raising without one)."""
    path = Path(path)
    if _is_deep_path(path):
        return load_any_model(path, device=device)
    return get_model(model_name).load(path, device=device)


# ---------------------------------------------------------------------------
# Fake quantization primitives
# ---------------------------------------------------------------------------


def fake_quant_int8(arr: np.ndarray) -> tuple[np.ndarray, float, int, np.ndarray]:
    """Per-tensor symmetric int8 fake quantization.
    Returns (dequantized array, scale, quantized nbytes, int8 tensor) — the
    dequantized view and the stored artifact derive from the SAME rounding,
    so measured accuracy is the deployed tensor's accuracy."""
    a = np.asarray(arr, dtype=np.float64)
    scale = float(np.max(np.abs(a))) / 127.0 if a.size else 0.0
    if scale == 0.0:
        return np.zeros_like(arr), 0.0, arr.size, np.zeros(arr.shape, np.int8)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    deq = (q.astype(np.float64) * scale).astype(arr.dtype, copy=False)
    return deq, scale, q.nbytes + 4, q


def bfloat16_bits(arr: np.ndarray) -> np.ndarray:
    """``arr`` rounded to bfloat16 (round to nearest, ties to even), as the
    uint16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bfloat16_values(bits: np.ndarray) -> np.ndarray:
    """float32 values of bfloat16 bit patterns (uint16): the high half of a
    float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def fake_cast(arr: np.ndarray, dtype) -> tuple[np.ndarray, int]:
    """Round-trip cast (fp16 / bf16) returning (dequantized, nbytes)."""
    if dtype == "bfloat16":
        rt = bfloat16_values(bfloat16_bits(arr)).astype(arr.dtype)
        return rt, arr.size * 2
    rt = arr.astype(np.float16).astype(arr.dtype)
    return rt, arr.size * 2


# ---------------------------------------------------------------------------
# Deep-bundle modes
# ---------------------------------------------------------------------------


class _InputQuantWrapper(BaseTrainer):
    """Static-int8 emulation: quantize inputs with a calibrated range before
    the (weight-quantized) model — the role of the reference's 50-sample
    CalibrationDataReader."""

    name = "static_int8_view"
    model_type = "deep"

    def __init__(self, inner: BaseTrainer, lo: float, hi: float):
        self._inner = inner
        self._lo, self._hi = lo, hi

    def _quant_input(self, X):
        scale = max((self._hi - self._lo) / 255.0, 1e-12)
        q = np.clip(np.round((X - self._lo) / scale), 0, 255)
        return (q * scale + self._lo).astype(np.float32)

    def fit(self, *a, **kw):  # pragma: no cover
        raise NotImplementedError

    def predict(self, X):
        return self._inner.predict(self._quant_input(np.asarray(X)))

    def predict_proba(self, X):
        return self._inner.predict_proba(self._quant_input(np.asarray(X)))

    def save(self, path):
        self._inner.save(path)

    @classmethod
    def load(cls, path):  # pragma: no cover
        raise NotImplementedError


def _quantize_deep_bundle(model_path: Path, mode: str, out_path: Path, calib_X: Optional[np.ndarray],
                          device: torch.device | str | None = None) -> BaseTrainer:
    """Build the quantized artifact for a deep bundle and return an
    evaluable trainer view on ``device``."""
    arch, flat, norm_mean, norm_var = load_model_bundle(model_path)
    new_flat: dict[str, np.ndarray] = {}
    store: dict[str, np.ndarray] = {}
    for k, arr in flat.items():
        if mode == "fp32":
            new_flat[k] = arr
            store[k] = arr.astype(np.float32)
        elif mode in ("dynamic_int8", "static_int8"):
            deq, scale, _, q = fake_quant_int8(arr)
            new_flat[k] = deq.astype(np.float32)
            store[k] = q
            store[k + "!scale"] = np.float32(scale)
        elif mode == "float16":
            deq, _ = fake_cast(arr, np.float16)
            new_flat[k] = deq.astype(np.float32)
            store[k] = arr.astype(np.float16)
        elif mode == "bfloat16":
            # store the bf16 bits themselves (uint16 view — np.savez has no
            # native bfloat16): the artifact holds EXACTLY the values whose
            # accuracy was measured; load_any_bundle views them back
            bits = bfloat16_bits(arr)
            new_flat[k] = bfloat16_values(bits)
            store[k] = bits
        else:
            raise ValueError(mode)
    meta = {**arch, "quantization": mode}
    if mode == "static_int8":
        if calib_X is None or len(calib_X) == 0:
            raise ValueError("static_int8 requires calibration data")
        calib = np.asarray(calib_X[:CALIBRATION_SAMPLES], dtype=np.float32)
        # persisted so deployment can reproduce the calibrated input grid
        meta["input_range"] = [float(calib.min()), float(calib.max())]
    # materialize the quantized artifact (real on-disk size)
    np.savez(
        out_path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        norm_mean=np.asarray(norm_mean), norm_var=np.asarray(norm_var),
        **{k.replace("!scale", ".scale"): v for k, v in store.items()},
    )
    # evaluable view: dequantized weights in a normal bundle
    view_path = out_path.with_suffix(".view.npz")
    save_model_bundle_flat(view_path, arch, new_flat, norm_mean, norm_var)
    trainer = load_any_model(view_path, device=device)
    view_path.unlink()
    if mode == "static_int8":
        trainer = _InputQuantWrapper(trainer, meta["input_range"][0], meta["input_range"][1])
    return trainer


def load_any_bundle(path: Path):
    """Read either a plain fp32 bundle or a Stage-6 quantized artifact
    (write side above / save_model_bundle_flat).

    Returns ``(arch, flat_fp32, norm_mean, norm_var, mode, qstore)`` where
    ``flat_fp32`` always carries float32 weights (int8/f16 tensors are
    dequantized exactly as the evaluated view was) and ``qstore`` maps param
    keys to ``(int8_array, scale)`` for int8 modes so codegen can keep the
    quantized tensors in flash."""
    data = np.load(Path(path), allow_pickle=False)
    arch = json.loads(bytes(data["__meta__"].tobytes()).decode())
    mode = arch.get("quantization", "fp32")
    flat: dict[str, np.ndarray] = {}
    qstore: dict[str, tuple[np.ndarray, float]] = {}
    for key in data.files:
        if not key.startswith(("p/", "c/")) or key.endswith(".scale"):
            continue
        arr = data[key]
        if arr.dtype == np.int8:
            scale = float(data[key + ".scale"])
            flat[key] = (arr.astype(np.float64) * scale).astype(np.float32)
            qstore[key] = (arr, scale)
        elif arr.dtype == np.float16:
            flat[key] = arr.astype(np.float32)
        elif arr.dtype == np.uint16:  # bfloat16 bits (write side above)
            flat[key] = bfloat16_values(arr)
        else:
            flat[key] = arr
    return arch, flat, data["norm_mean"], data["norm_var"], mode, qstore


# ---------------------------------------------------------------------------
# Classical (npz / joblib) modes — generic array walking
# ---------------------------------------------------------------------------


def _walk_float_arrays(obj, visit, _seen=None):
    """Recursively visit float ndarrays inside an estimator object graph;
    visit(arr) returns a replacement array. A floating torch tensor in the
    graph raises: it would escape quantization, and the report would give
    its fp32 accuracy under a quantized mode."""
    if _seen is None:
        _seen = set()
    oid = id(obj)
    if oid in _seen:
        return
    _seen.add(oid)
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            raise TypeError(
                f"a floating torch tensor {tuple(obj.shape)} on {obj.device} is reachable from the trainer; "
                "quantization walks numpy arrays only")
        return
    if hasattr(obj, "__dict__"):
        for key, val in list(vars(obj).items()):
            if isinstance(val, np.ndarray) and np.issubdtype(val.dtype, np.floating):
                setattr(obj, key, visit(val))
            else:
                _walk_float_arrays(val, visit, _seen)
    elif isinstance(obj, dict):
        for key, val in list(obj.items()):
            if isinstance(val, np.ndarray) and np.issubdtype(val.dtype, np.floating):
                obj[key] = visit(val)
            else:
                _walk_float_arrays(val, visit, _seen)
    elif isinstance(obj, list):
        for i, val in enumerate(obj):
            if isinstance(val, np.ndarray) and np.issubdtype(val.dtype, np.floating):
                obj[i] = visit(val)
            else:
                _walk_float_arrays(val, visit, _seen)
    elif isinstance(obj, tuple):
        for val in obj:
            _walk_float_arrays(val, visit, _seen)


def _quantize_classical(trainer: BaseTrainer, mode: str, model_path: Path, out_path: Path) -> tuple[BaseTrainer, float]:
    """Fake-quantize a classical trainer; returns (view, size_kb). The view
    is a deep copy: a trainer loaded from disk holds numpy state only."""
    original_size = model_path.stat().st_size
    view = copy.deepcopy(trainer)
    saved = {"orig": 0, "quant": 0}

    def visit(arr):
        saved["orig"] += arr.nbytes
        if mode == "dynamic_int8":
            # weight-only semantics, like onnxruntime quantize_dynamic: only
            # >=2-D weight matrices (SVs, dual/LDA coefs, PCA components) are
            # quantized — biases, Platt sigmoids, and scaler/PCA
            # normalization vectors stay float. Per-tensor int8 on a
            # scaler_scale spanning decades zeroes small stds and collapses
            # pca_svm/lda to chance accuracy, for a saving of a few hundred
            # bytes.
            if arr.ndim < 2:
                saved["quant"] += arr.nbytes
                return arr
            deq, _, nbytes, _q = fake_quant_int8(arr)
            saved["quant"] += nbytes
            return deq
        if mode == "float16":
            deq, nbytes = fake_cast(arr, np.float16)
            saved["quant"] += nbytes
            return deq
        saved["quant"] += arr.nbytes
        return arr

    target = getattr(view, "_estimator", view)
    _walk_float_arrays(target, visit)
    if mode != "fp32" and saved["orig"] == 0:
        # e.g. sklearn trees hold weights inside Cython objects without a
        # __dict__; reporting them as "quantized" would misstate the artifact
        raise ValueError(
            f"{type(target).__name__}: no quantizable float arrays reachable — skipping {mode}"
        )
    # size: original container minus float-array savings (arrays dominate)
    size_kb = max(original_size - saved["orig"] + saved["quant"], 256) / 1024
    view.save(out_path) if mode == "fp32" else _save_classical_quant(view, out_path)
    return view, size_kb


def _save_classical_quant(view: BaseTrainer, out_path: Path) -> None:
    try:
        view.save(out_path)
    except Exception:
        out_path.write_bytes(b"")


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def evaluate_model(trainer: BaseTrainer, X: np.ndarray, y: np.ndarray, label_names: list[str]) -> dict:
    """Accuracy / f1 / mean per-sample latency over one batched run on the
    trainer's device. A warm-up call on 8 rows comes first (first-call
    set-up, as in JAX). ``predict`` returns numpy, so the timed call has
    ended on the device when the clock stops: no separate synchronize."""
    trainer.predict(X[: min(len(X), 8)])
    t0 = time.perf_counter()
    y_pred = trainer.predict(X)
    latency_ms = (time.perf_counter() - t0) * 1000.0 / max(len(X), 1)
    m = compute_metrics(y, y_pred, label_names=label_names)
    return {"accuracy": m["val_accuracy"], "f1_macro": m["val_f1_macro"], "latency_ms": latency_ms}


DEEP_MODES = ("dynamic_int8", "static_int8", "float16", "bfloat16")
CLASSICAL_MODES = ("dynamic_int8", "float16")


def build_mode(
    trainer: BaseTrainer,
    model_path: Path,
    mode: str,
    model_dir: Path,
    calib_X: Optional[np.ndarray],
) -> tuple[BaseTrainer, Path, float]:
    """Materialize one optimization mode. Returns (view, artifact, size_kb);
    a deep view goes on the trainer's device."""
    out = model_dir / f"model_{mode}.npz"
    if _is_deep_path(model_path):
        if mode == "fp32":
            arch, flat, nm, nv = load_model_bundle(model_path)
            save_model_bundle_flat(out, arch, flat, nm, nv)
            return load_any_model(out, device=trainer.device), out, out.stat().st_size / 1024
        view = _quantize_deep_bundle(model_path, mode, out, calib_X, device=trainer.device)
        return view, out, out.stat().st_size / 1024
    # classical
    if mode == "static_int8":
        raise ValueError("static_int8 applies to deep bundles only")
    out = model_dir / (f"model_{mode}" + model_path.suffix)
    view, size_kb = _quantize_classical(trainer, mode, model_path, out)
    if mode == "fp32":
        size_kb = model_path.stat().st_size / 1024
    return view, out, size_kb
