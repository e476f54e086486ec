"""Device-in-the-loop evaluation: play each frozen test-split clip (speaker
-> device mic) while the device runs EVAL_MODE firmware, collect PRED/SCORES
replies, and write a classification report + confusion matrix to the
tracking store (contract of reference tools/evaluate_device.py:1-45).

The host signals the device with 'R' per clip and (optionally) plays the
clip through the default audio output via `aplay`. With --no-playback the
device is assumed to be fed audio externally (e.g. a loopback test rig).

The port's counterpart of the repository's ``tools/evaluate_device.py``
(stage 8): its flags, label set, report, confusion matrix (a PNG without
matplotlib, ``train.evaluate.heatmap_png``) and tracking run, on the port's
``train.evaluate``, ``utils.tracking`` (file store or REST) and
``fsc22_metadata``.

Usage: python -m audio_edge_ml_pipeline_torch.tools.evaluate_device --port /dev/ttyACM0 \
           --dataset <audio_folder> --manifest split_manifest.json \
           [--split test] [--experiment device-eval] [--no-playback]
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np

from ..data.loaders import fsc22_metadata
from ..train.evaluate import compute_metrics, save_classification_report, save_confusion_matrix_png
from ..utils import tracking
from . import serial_proto


def evaluate(ser, clips: list[tuple[Path, str]], label_names: list[str],
             playback: bool = True, output_dir: Path = Path("data/device_eval")) -> dict:
    """Run the EVAL protocol over every clip; returns metrics."""
    # grow the label set with any device prediction outside it: dropping
    # out-of-set predictions would count only in-set answers and inflate
    # the reported accuracy
    label_names = list(label_names)
    name_to_idx = {n: i for i, n in enumerate(label_names)}
    y_true, y_pred = [], []
    for i, (path, true_label) in enumerate(clips):
        proc = None
        if playback:
            try:
                # start playback FIRST, then send 'R' while audio is still
                # playing: EVAL_MODE firmware begins recording only on 'R',
                # so a blocking play-then-send would capture silence
                proc = subprocess.Popen(["aplay", "-q", str(path)])
            except FileNotFoundError:
                print("aplay not found — use --no-playback with an external audio rig")
                raise SystemExit(2)
        pred, scores = serial_proto.eval_roundtrip(ser)
        if proc is not None:
            proc.wait(timeout=30)
        print(f"[{i + 1}/{len(clips)}] {path.name}: true={true_label} pred={pred}")
        for name in (true_label, pred):
            if name not in name_to_idx:
                name_to_idx[name] = len(label_names)
                label_names.append(name)
        y_true.append(name_to_idx[true_label])
        y_pred.append(name_to_idx[pred])
    if not y_true:
        raise SystemExit("no valid predictions collected")
    metrics = compute_metrics(np.array(y_true), np.array(y_pred), label_names=label_names)
    output_dir.mkdir(parents=True, exist_ok=True)
    save_classification_report(np.array(y_true), np.array(y_pred), label_names, output_dir / "classification_report.txt")
    save_confusion_matrix_png(metrics["confusion_matrix"], label_names, output_dir / "confusion_matrix.png")
    return metrics


def _fsc22_label_map(root: Path) -> dict[str, str]:
    """filename -> class name from the FSC22 metadata CSV (flat layout)."""
    try:
        _, df = fsc22_metadata(root)
    except FileNotFoundError as exc:
        raise SystemExit(str(exc))
    return {str(r["Dataset File Name"]): str(r["Class Name"]) for _, r in df.iterrows()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", default=None, help="serial port (default: auto-detect)")
    ap.add_argument("--baud", type=int, default=115200)
    ap.add_argument("--dataset", "--source-dir", dest="dataset", required=True, type=Path,
                    help="root of the audio dataset")
    ap.add_argument("--loader", default="audio_folder", choices=["audio_folder", "folder", "fsc22"],
                    help="audio_folder = class-per-subfolder; fsc22 = flat audio + CSV "
                         "(labels looked up by filename)")
    ap.add_argument("--manifest", type=Path, default=None)
    ap.add_argument("--split", default="test")
    ap.add_argument("--classes", nargs="+", default=None,
                    help="restrict evaluation to these class names "
                         "(auto-populated from --optimization-report)")
    ap.add_argument("--optimization-report", type=Path, default=None,
                    help="optimization_report.json — reads class_filter automatically")
    ap.add_argument("--experiment", default="device-eval")
    ap.add_argument("--run-name", default=None)
    ap.add_argument("--mlflow-uri", default=None, help="tracking store root (default mlruns/)")
    ap.add_argument("--no-mlflow", action="store_true", help="skip tracking, just print results")
    ap.add_argument("--output", type=Path, default=Path("data/device_eval"))
    ap.add_argument("--no-playback", action="store_true")
    ap.add_argument("--max-clips", type=int, default=None)
    args = ap.parse_args(argv)

    class_filter = set(args.classes or [])
    if args.optimization_report:
        cf = json.loads(args.optimization_report.read_text()).get("class_filter")
        if isinstance(cf, str):
            try:
                cf = json.loads(cf)
            except json.JSONDecodeError:
                cf = [cf]
        if cf and not class_filter:
            class_filter = set(cf)
            print(f"class filter from optimization report: {sorted(class_filter)}")

    fsc22_labels = _fsc22_label_map(args.dataset) if args.loader == "fsc22" else None

    def _label_for(rel: str) -> str:
        if fsc22_labels is not None:
            return fsc22_labels.get(Path(rel).name, "?")
        return Path(rel).parts[0]

    clips: list[tuple[Path, str]] = []
    if args.manifest:
        manifest = json.loads(args.manifest.read_text())
        for rel in manifest.get(args.split, []):
            p = args.dataset / rel
            if p.exists():
                clips.append((p, _label_for(rel)))
    elif fsc22_labels is not None:
        for f in sorted(args.dataset.glob("*.wav")):
            clips.append((f, fsc22_labels.get(f.name, "?")))
    else:
        for class_dir in sorted(p for p in args.dataset.iterdir() if p.is_dir()):
            for f in sorted(class_dir.glob("*.wav")):
                clips.append((f, class_dir.name))
    if class_filter:
        clips = [(p, c) for p, c in clips if c in class_filter]
    if args.max_clips:
        clips = clips[: args.max_clips]
    if not clips:
        raise SystemExit("no clips matched the manifest/split/class filter")
    label_names = sorted({c for _, c in clips})

    ser = serial_proto.open_serial(args.port or serial_proto.autodetect_port(),
                                   args.baud, timeout=60)
    metrics = evaluate(ser, clips, label_names, playback=not args.no_playback, output_dir=args.output)
    print(f"device accuracy: {metrics['val_accuracy']:.4f}  f1_macro: {metrics['val_f1_macro']:.4f}")

    if args.no_mlflow:
        return
    if args.mlflow_uri:
        tracking.set_tracking_uri(args.mlflow_uri)
    tracking.set_experiment(args.experiment)
    with tracking.start_run(run_name=args.run_name or f"device_eval_{args.split}") as run:
        run.log_param("split", args.split)
        run.log_param("n_clips", len(clips))
        if class_filter:
            run.log_param("class_filter", json.dumps(sorted(class_filter)))
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                run.log_metric(f"device_{k}", float(v))
        run.log_artifact(args.output / "classification_report.txt")
        run.log_artifact(args.output / "confusion_matrix.png")


if __name__ == "__main__":
    main()
