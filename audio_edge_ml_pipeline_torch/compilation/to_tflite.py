"""Stage 7a — TFLite export CLI.

Counterpart of the JAX package's ``compilation/to_tflite.py``, with its
flags, YAML keys, output layout and ``compilation_report.json`` keys.
Converts a model bundle to TFLite in four modes (fp32, dynamic-range int8,
full-integer int8 calibrated on the training features, fp16), evaluates
each on a held-out validation FeatureSet with TensorFlow's interpreter,
selects the best (the smallest within ``--max-accuracy-drop`` of fp32)
unless ``--mode`` forces one, and writes:

    <output>/
        model_fp32.tflite
        model_dynamic.tflite
        model_int8.tflite
        model_float16.tflite
        deploy/
            model.tflite          best mode
            label_names.json      class names in label-index order
            mel_params.json       frontend geometry for the device runtime
            mel_filterbank.npy    (n_mels, 1 + n_fft//2) float32 (ops/golden)
        compilation_report.json

The forward is the bundle's normalised softmax forward written in TF ops
(``tf_forward.py``), where JAX traces its flax module with jax2tf. Each
conversion runs in a child process (one for all the modes; a new one for
the modes left when one dies): a converter that crashes, as TFLite's int8
conversion of a BiLSTM can, fails its mode, which is logged and skipped,
and never the CLI.

TensorFlow is needed for the conversion and the interpreter, and is
imported only there: without it the CLI, ``evaluate_tflite``, the edge
simulator's ``.tflite`` branch and ``compile_xla --tflite`` raise an
ImportError that names it. The model bundle is loaded as every port CLI
loads one: on the first CUDA card, or on the CPU with ``--device cpu``.

CLI:
    python -m audio_edge_ml_pipeline_torch.compilation.to_tflite \
        --model <bundle.npz> --features <calib dir> --features-val <val dir> \
        --output <dir> [--class-filter A B ...] [--max-accuracy-drop 0.02] \
        [--mode fp32|dynamic|int8|float16] [--sample-rate ...] [--config YAML] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np

from ..features.pipeline import FeaturePipeline
from ..models.deep import load_any_model, load_model_bundle, params_to_flax, save_model_bundle_flat
from ..ops.golden.librosa_ref import mel_filterbank
from ..train.tune import apply_class_filter_canonical, encode_labels_by_name
from ..utils.device import resolve_device
from ..utils.logging import setup_logging
from .tf_forward import concrete_function, tensorflow

logger = logging.getLogger(__name__)

MODES = ("fp32", "dynamic", "int8", "float16")
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]
_TF_LOG = ("I0000", "W0000", "E0000", "WARNING:absl", "WARNING: All log")   # TensorFlow's own log lines


def convert(concrete, mode: str, calib_X: Optional[np.ndarray]) -> bytes:
    """One TFLite conversion of ``concrete`` in this process: ``dynamic``
    and ``float16`` quantise the weights, ``int8`` the whole graph and its
    I/O, calibrated on up to 100 rows of ``calib_X`` one at a time."""
    tf = tensorflow()
    conv = tf.lite.TFLiteConverter.from_concrete_functions([concrete])
    if mode == "dynamic":
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
    elif mode == "int8":
        conv.optimizations = [tf.lite.Optimize.DEFAULT]

        def rep():
            for i in range(min(100, len(calib_X))):
                yield [calib_X[i : i + 1].astype(np.float32)]

        conv.representative_dataset = rep
        conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        conv.inference_input_type = tf.int8
        conv.inference_output_type = tf.int8
    elif mode == "float16":
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
        conv.target_spec.supported_types = [tf.float16]
    elif mode != "fp32":
        raise ValueError(f"unknown TFLite mode {mode!r} (modes: {MODES})")
    return conv.convert()


def _convert_child(work: str, modes: list[str]) -> None:
    """The child process of ``convert_modes``: builds the forward of
    ``work/model.npz`` and converts each mode into ``work/spec.json``'s
    output directory, reporting ``start`` / ``done`` / ``fail`` lines in
    ``work/status`` as it goes."""
    work_dir = Path(work)
    spec = json.loads((work_dir / "spec.json").read_text())
    arch, flat, norm_mean, norm_var = load_model_bundle(work_dir / "model.npz")
    calib_X = np.load(work_dir / "calib.npy")
    concrete = concrete_function(arch, flat, norm_mean, norm_var, tuple(spec["input_shape"]))
    with open(work_dir / "status", "a") as status:
        for mode in modes:
            status.write(f"start\t{mode}\n")
            status.flush()
            try:
                blob = convert(concrete, mode, calib_X)
                (Path(spec["out_dir"]) / f"model_{mode}.tflite").write_bytes(blob)
                status.write(f"done\t{mode}\n")
            except Exception as exc:
                status.write(f"fail\t{mode}\t{type(exc).__name__}: {str(exc).splitlines()[0] if str(exc) else ''}\n")
            status.flush()


def _run_child(work: Path, modes: list[str]) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_PACKAGE_ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    # the child uses no Keras: TensorFlow imports Keras 3's optimizers when it is imported (about 5 s) unless
    # told to take the legacy tf_keras package instead, whose absence it passes over
    env.setdefault("TF_USE_LEGACY_KERAS", "1")
    code = f"from {__package__}.to_tflite import _convert_child; _convert_child({str(work)!r}, {modes!r})"
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)


def convert_modes(trainer, input_shape, calib_X, out_dir: Path) -> dict:
    """Emit the TFLite artifacts of ``trainer``'s bundle into ``out_dir``;
    a failed mode is logged and skipped. The conversions run in a child
    process, and a child that dies (a converter's segmentation fault) fails
    the mode it was converting: the modes after it go on in a new child.
    Returns {mode: path} of the files written."""
    tensorflow()
    out_dir = Path(out_dir)
    paths: dict[str, Path] = {}
    with tempfile.TemporaryDirectory(prefix="aep-tflite-") as tmp:
        work = Path(tmp)
        flat = params_to_flax(trainer._net.state_dict())
        save_model_bundle_flat(work / "model.npz", trainer._arch_dict, flat,
                               trainer._norm_mean.cpu().numpy(), trainer._norm_var.cpu().numpy())
        np.save(work / "calib.npy", np.asarray(calib_X, np.float32))
        (work / "spec.json").write_text(json.dumps({"input_shape": [int(d) for d in input_shape],
                                                    "out_dir": str(out_dir.resolve())}))
        pending = list(MODES)
        while pending:
            (work / "status").write_text("")
            proc = _run_child(work, pending)
            lines = [line.split("\t") for line in (work / "status").read_text().splitlines()]
            started = [line[1] for line in lines if line[0] == "start"]
            for line in lines:
                if line[0] == "done":
                    paths[line[1]] = out_dir / f"model_{line[1]}.tflite"
                    logger.info("tflite %s: %.1f KB", line[1], paths[line[1]].stat().st_size / 1024)
                elif line[0] == "fail":
                    logger.warning("tflite mode %r failed: %s", line[1], line[2] if len(line) > 2 else "")
            if proc.returncode == 0:
                break
            said = [line for line in proc.stderr.splitlines() if line.strip() and not line.startswith(_TF_LOG)]
            tail = " | ".join(said[-3:])
            finished = {line[1] for line in lines if line[0] in ("done", "fail")}
            dead = [m for m in started if m not in finished]
            if not dead:   # it died before its first conversion: the modes left all fail
                logger.warning("tflite conversion process exited with %d before converting: %s", proc.returncode, tail)
                break
            logger.warning("tflite mode %r failed: the converter process died (exit %d): %s", dead[0],
                           proc.returncode, tail)
            pending = pending[pending.index(dead[0]) + 1 :]
    return paths


def evaluate_tflite(path: Path, X: np.ndarray, y: np.ndarray) -> dict:
    """Sample-by-sample interpreter evaluation with int8 quantize /
    dequantize at the I/O, as an edge device runs the file: {accuracy,
    latency_ms (a sample), size_kb}."""
    tf = tensorflow()
    interp = tf.lite.Interpreter(model_path=str(path))
    interp.allocate_tensors()
    inp = interp.get_input_details()[0]
    out = interp.get_output_details()[0]
    correct = 0
    t0 = time.perf_counter()
    for i in range(len(X)):
        x = X[i : i + 1].astype(np.float32)
        if inp["dtype"] == np.int8:
            scale, zp = inp["quantization"]
            x = np.clip(np.round(x / scale + zp), -128, 127).astype(np.int8)
        interp.set_tensor(inp["index"], x)
        interp.invoke()
        o = interp.get_tensor(out["index"])
        if out["dtype"] == np.int8:
            scale, zp = out["quantization"]
            o = (o.astype(np.float32) - zp) * scale
        if int(np.argmax(o)) == int(y[i]):
            correct += 1
    latency_ms = (time.perf_counter() - t0) * 1000.0 / max(len(X), 1)
    return {"accuracy": correct / max(len(X), 1), "latency_ms": latency_ms, "size_kb": path.stat().st_size / 1024}


def compile_model(
    model_path: Path,
    features_dir: Path,
    features_val_dir: Path,
    output_dir: Path,
    class_filter: Optional[list],
    mel_params: dict,
    max_accuracy_drop: float = 0.02,
    forced_mode: Optional[str] = None,
    device=None,
) -> dict:
    """Convert all modes, evaluate, pick the winner, write the deploy bundle.
    Calibration rows come from the *training* FeatureSet, evaluation from
    the held-out one, and the class filter uses the canonical name-sorted
    encoding so that both sets agree with the training-time label order."""
    device = resolve_device(device)
    tensorflow()
    output_dir.mkdir(parents=True, exist_ok=True)
    trainer = load_any_model(model_path, device=device)

    calib_fs = FeaturePipeline.load(features_dir)
    val_fs = FeaturePipeline.load(features_val_dir)
    if val_fs.labels is None:
        raise ValueError("Validation FeatureSet has no labels.")
    label_names = list(calib_fs.label_names or [])

    # a model trained on a filtered subset cannot be evaluated against the whole label set
    n_model_classes = int(trainer._arch_dict.get("n_classes", 0))
    if not class_filter and n_model_classes and label_names and n_model_classes != len(label_names):
        raise ValueError(
            f"Model has {n_model_classes} output classes but the feature set has "
            f"{len(label_names)}; pass --class-filter with the training-time classes."
        )

    if class_filter:
        if calib_fs.labels is not None:
            X_calib, _, filtered_labels = apply_class_filter_canonical(
                calib_fs.features, calib_fs.labels, label_names, class_filter, "tflite-calib"
            )
        else:
            X_calib = calib_fs.features
            filtered_labels = sorted(set(class_filter) & set(label_names)) or sorted(class_filter)
        # validation labels encoded BY NAME against the canonical (training-time) list: a list taken from the
        # validation set would shift every code whenever a filtered class is absent there
        keep, y_val = encode_labels_by_name(val_fs.labels, list(val_fs.label_names or []), filtered_labels)
        X_val = val_fs.features[keep]
    else:
        X_calib, filtered_labels = calib_fs.features, label_names
        X_val, y_val = val_fs.features, val_fs.labels
        val_names = list(val_fs.label_names or [])
        if val_names and label_names and val_names != label_names:
            # loaders may order labels differently: re-encode by class name
            keep, y_val = encode_labels_by_name(y_val, val_names, label_names)
            X_val = X_val[keep]

    X_calib = trainer._prepare_input(np.asarray(X_calib, np.float32))
    X_val = trainer._prepare_input(np.asarray(X_val, np.float32))
    logger.info("validation: %d samples, %d classes, shape %s", len(X_val), len(filtered_labels), X_val.shape[1:])

    paths = convert_modes(trainer, X_val.shape[1:], X_calib, output_dir)
    if "fp32" not in paths:
        raise RuntimeError("fp32 TFLite conversion failed — cannot proceed")

    results = {}
    for mode, path in paths.items():
        results[mode] = evaluate_tflite(path, X_val, y_val)
        logger.info("%-9s acc=%.4f latency=%.3f ms size=%.1f KB", mode, results[mode]["accuracy"],
                    results[mode]["latency_ms"], results[mode]["size_kb"])
    fp32_accuracy = results["fp32"]["accuracy"]

    if forced_mode:
        if forced_mode not in results:
            raise ValueError(f"--mode {forced_mode!r} unavailable; got {sorted(results)}")
        best_mode = forced_mode
    else:
        best_mode = "fp32"
        for mode in ("int8", "dynamic", "float16"):
            if mode not in results:
                continue
            if fp32_accuracy - results[mode]["accuracy"] <= max_accuracy_drop and \
                    results[mode]["size_kb"] < results[best_mode]["size_kb"]:
                best_mode = mode
    best = results[best_mode]
    logger.info("best mode: %s (acc=%.4f drop=%.4f size=%.1f KB)", best_mode, best["accuracy"],
                fp32_accuracy - best["accuracy"], best["size_kb"])

    deploy_dir = output_dir / "deploy"
    deploy_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy2(paths[best_mode], deploy_dir / "model.tflite")
    (deploy_dir / "label_names.json").write_text(json.dumps(filtered_labels, indent=2))
    (deploy_dir / "mel_params.json").write_text(json.dumps(mel_params, indent=2))
    fb = mel_filterbank(sr=mel_params["sample_rate"], n_fft=mel_params["n_fft"],
                        n_mels=mel_params["n_mels"]).astype(np.float32)
    np.save(deploy_dir / "mel_filterbank.npy", fb)
    logger.info("deployment bundle -> %s", deploy_dir)

    report = {
        "timestamp": datetime.now().isoformat(timespec="seconds"),
        "model_path": str(model_path),
        "features_dir": str(features_dir),
        "features_val_dir": str(features_val_dir),
        "class_filter": list(class_filter) if class_filter else None,
        "label_names": filtered_labels,
        "n_classes": len(filtered_labels),
        "n_val_samples": int(len(y_val)),
        "max_accuracy_drop": max_accuracy_drop,
        "fp32_accuracy": fp32_accuracy,
        "best_mode": best_mode,
        "best_accuracy": best["accuracy"],
        "best_accuracy_drop": float(fp32_accuracy - best["accuracy"]),
        "best_size_kb": best["size_kb"],
        "best_latency_ms": best["latency_ms"],
        "mel_params": mel_params,
        "modes": results,
        "deploy_dir": str(deploy_dir),
    }
    (output_dir / "compilation_report.json").write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.compilation.to_tflite",
        description="Stage 7a — TFLite export (fp32 / dynamic / int8 / float16)",
    )
    p.add_argument("--config", metavar="YAML", help="YAML config file.")
    p.add_argument("--model", metavar="PATH", help="Path to model bundle (.npz).")
    p.add_argument("--features", metavar="DIR", help="Calibration features dir.")
    p.add_argument("--features-val", metavar="DIR", help="Validation features dir.")
    p.add_argument("--output", metavar="DIR", help="Output directory.")
    p.add_argument("--class-filter", metavar="CLASS", nargs="+",
                   help="Class names to include (must match training-time filter).")
    p.add_argument("--max-accuracy-drop", type=float, default=None,
                   help="Max tolerated accuracy drop vs fp32 (default 0.02).")
    p.add_argument("--mode", metavar="MODE", choices=list(MODES),
                   help="Force a specific TFLite mode instead of auto-selecting.")
    p.add_argument("--sample-rate", type=int, default=None)
    p.add_argument("--n-mels", type=int, default=None)
    p.add_argument("--n-fft", type=int, default=None)
    p.add_argument("--hop-length", type=int, default=None)
    p.add_argument("--duration", type=float, default=None)
    p.add_argument("--device", default=None,
                   help="torch device the bundle loads on (default: the first CUDA card; 'cpu' to run without one)")
    args = p.parse_args(argv)

    cfg: dict = {}
    if args.config:
        import yaml

        cfg = yaml.safe_load(Path(args.config).read_text()) or {}

    def _get(key, cli_val, default=None):
        return cli_val if cli_val is not None else cfg.get(key, default)

    model = _get("model", args.model)
    features = _get("features", args.features)
    output = _get("output", args.output)
    if not (model and features and output):
        p.error("--model, --features and --output are required (via CLI or --config)")
    model_path = Path(model)
    features_dir = Path(features)
    # validation defaults to the calibration dir when not given separately
    features_val_dir = Path(_get("features_val", args.features_val, features))
    output_dir = Path(output)
    class_filter = args.class_filter or cfg.get("class_filter") or None
    max_drop = float(_get("max_accuracy_drop", args.max_accuracy_drop, 0.02))
    forced_mode = args.mode or cfg.get("mode") or None

    mel_params = {
        "sample_rate": int(_get("sample_rate", args.sample_rate, 16000)),
        "n_mels": int(_get("n_mels", args.n_mels, 40)),
        "n_fft": int(_get("n_fft", args.n_fft, 512)),
        "hop_length": int(_get("hop_length", args.hop_length, 160)),
        "duration": float(_get("duration", args.duration, 5.0)),
    }
    mel_params["input_shape"] = [
        mel_params["n_mels"],
        int(mel_params["duration"] * mel_params["sample_rate"] / mel_params["hop_length"]) + 1,
    ]

    for label, path in [("model", model_path), ("features", features_dir), ("features_val", features_val_dir)]:
        if not path.exists():
            logger.error("%s not found: %s", label, path)
            sys.exit(1)

    report = compile_model(
        model_path=model_path,
        features_dir=features_dir,
        features_val_dir=features_val_dir,
        output_dir=output_dir,
        class_filter=class_filter,
        mel_params=mel_params,
        max_accuracy_drop=max_drop,
        forced_mode=forced_mode,
        device=args.device,
    )
    print(json.dumps({"best_mode": report["best_mode"], **{k: v["size_kb"] for k, v in report["modes"].items()}},
                     indent=2))


if __name__ == "__main__":
    main()
