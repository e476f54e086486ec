"""Export a pca_svm pipeline as a flat .npy bundle for the MicroPython/ulab
on-device runtime (the JAX package's ``deploy/export_svm.py``).

Bundle contents (one .npy per array so ulab's np.load can read them):
    scaler_mean.npy, scaler_scale.npy      StandardScaler parameters
    pca_components.npy, pca_mean.npy       PCA projection
    svm_coef.npy, svm_intercept.npy        linear one-vs-one decision funcs
    svm_classes.npy                        class indices
    mel_fb.npy                             slaney mel filterbank (precomputed)
    dct.npy                                orthonormal DCT-II matrix
    label_names.json, feature_params.json

The original project documents a 22,050 Hz training vs 16,000 Hz device-mic
mismatch hazard; feature_params.json carries the
training sample rate and this exporter warns when it is not a rate the
Nicla PDM mic supports (16 kHz / 32 kHz).

CLI: python -m audio_edge_ml_pipeline_torch.deploy.export_svm \
        --model <pca_svm.npz> --labels-from <featureset dir> --output svm_bundle/
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from ..ops.golden import librosa_ref as golden
from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)

_NICLA_RATES = (16000, 32000)

_KERNEL_ERR = (
    "The ulab runtime evaluates linear one-vs-one decision functions; "
    "got kernel={kernel!r}. Retrain pca_svm with kernel: linear."
)


def _arrays_from_npz_bundle(model_path: Path) -> dict:
    """Extract the export arrays from a pca_svm ``.npz`` bundle (written by
    either package's models/classical.py PCASVMTrainer): the OvO
    dual-coefficient matrix is collapsed to explicit linear decision
    functions in PCA space, on the host."""
    from ..models.classical import PCASVMTrainer
    from ..models.classical_core import linear_ovo_coef

    trainer = PCASVMTrainer.load(model_path, device="cpu")
    state = getattr(trainer, "_state", None)
    if not state or "pca_components" not in state or "svm_dual" not in state:
        raise ValueError("export_svm expects a pca_svm bundle (scaler -> pca -> svm)")
    kernel = str(state["svm_kernel"])
    if kernel != "linear":
        raise ValueError(_KERNEL_ERR.format(kernel=kernel))
    coef, intercept = linear_ovo_coef(state)
    return {
        "scaler_mean": np.asarray(state["scaler_mean"], np.float32),
        "scaler_scale": np.asarray(state["scaler_scale"], np.float32),
        # bundle layout is sklearn's components_ (k, D) rows
        "pca_components": np.asarray(state["pca_components"], np.float32).T.copy(),
        "pca_mean": np.asarray(state["pca_mean"], np.float32),
        "svm_coef": np.asarray(coef, np.float32),
        "svm_intercept": np.asarray(intercept, np.float32),
        "svm_classes": np.arange(int(state["svm_n_classes"]), dtype=np.int32),
    }


def _arrays_from_sklearn_pipeline(model_path: Path) -> dict:
    """Extract the export arrays from a legacy sklearn Pipeline joblib."""
    try:
        import joblib
    except ImportError as exc:
        raise ImportError(
            f"reading the legacy pca_svm pipeline {model_path.name} needs joblib, which is not installed; "
            "export an .npz pca_svm bundle instead") from exc

    pipeline = joblib.load(model_path)
    try:
        scaler = pipeline.named_steps["scaler"]
        pca = pipeline.named_steps["pca"]
        svm = pipeline.named_steps["svm"]
    except (AttributeError, KeyError) as exc:
        raise ValueError("export_svm expects a pca_svm Pipeline (scaler -> pca -> svm)") from exc
    if getattr(svm, "kernel", "rbf") != "linear":
        raise ValueError(_KERNEL_ERR.format(kernel=svm.kernel))
    return {
        "scaler_mean": scaler.mean_.astype(np.float32),
        "scaler_scale": scaler.scale_.astype(np.float32),
        "pca_components": pca.components_.astype(np.float32),
        "pca_mean": pca.mean_.astype(np.float32),
        "svm_coef": svm.coef_.astype(np.float32),
        "svm_intercept": svm.intercept_.astype(np.float32),
        "svm_classes": svm.classes_.astype(np.int32),
    }


def export_bundle(
    model_path: Path,
    output_dir: Path,
    label_names: list[str],
    sample_rate: int = 16000,
    n_mfcc: int = 20,
    n_mels: int = 32,
    n_fft: int = 512,
    hop_length: int = 160,
    duration: float = 1.0,
) -> Path:
    model_path = Path(model_path)
    if model_path.suffix == ".npz":
        arrays = _arrays_from_npz_bundle(model_path)
    else:
        arrays = _arrays_from_sklearn_pipeline(model_path)
    if sample_rate not in _NICLA_RATES:
        logger.warning(
            "sample_rate %d is not supported by the Nicla PDM mic (%s) — "
            "train/deploy rate mismatch degrades accuracy",
            sample_rate, _NICLA_RATES,
        )

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for name, arr in arrays.items():
        np.save(output_dir / f"{name}.npy", arr)
    np.save(output_dir / "mel_fb.npy", golden.mel_filterbank(sample_rate, n_fft, n_mels).astype(np.float32))
    np.save(output_dir / "dct.npy", golden.dct_ii_ortho_matrix(n_mfcc, n_mels).astype(np.float32))
    (output_dir / "label_names.json").write_text(json.dumps(label_names, indent=2))
    (output_dir / "feature_params.json").write_text(
        json.dumps(
            {
                "sample_rate": sample_rate, "n_mfcc": n_mfcc, "n_mels": n_mels,
                "n_fft": n_fft, "hop_length": hop_length, "duration": duration,
                "nicla_supported_rates": list(_NICLA_RATES),
            },
            indent=2,
        )
    )
    # ship the on-device runtime alongside the bundle
    from . import micropython_runtime

    (output_dir / "nicla_main.py").write_text(micropython_runtime.NICLA_MAIN_PY)
    logger.info("SVM bundle -> %s", output_dir)
    return output_dir


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(prog="python -m audio_edge_ml_pipeline_torch.deploy.export_svm")
    p.add_argument("--model", required=True, help="pca_svm .npz bundle (or a legacy .joblib pipeline)")
    p.add_argument("--output", required=True)
    p.add_argument("--labels", nargs="+", default=None)
    p.add_argument("--labels-from", default=None, help="FeatureSet dir with label_names.json")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--n-mfcc", type=int, default=20)
    p.add_argument("--n-mels", type=int, default=32)
    p.add_argument("--n-fft", type=int, default=512)
    p.add_argument("--hop-length", type=int, default=160)
    p.add_argument("--duration", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.labels:
        labels = args.labels
    elif args.labels_from:
        labels = json.loads((Path(args.labels_from) / "label_names.json").read_text())
    else:
        p.error("need --labels or --labels-from")
    export_bundle(
        Path(args.model), Path(args.output), labels,
        sample_rate=args.sample_rate, n_mfcc=args.n_mfcc, n_mels=args.n_mels,
        n_fft=args.n_fft, hop_length=args.hop_length, duration=args.duration,
    )


if __name__ == "__main__":
    main()
