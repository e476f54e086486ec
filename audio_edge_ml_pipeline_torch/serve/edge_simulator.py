"""Edge device simulator.

Simulates a deployed device (contract of the JAX package's
``serve/edge_simulator.py``): repeatedly picks a random clip from a dataset
directory, extracts its log-mel on the torch device (the folded-mel kernel
on a CUDA card), runs the model (an ``.npz`` bundle, or a ``.tflite`` file
through TensorFlow's interpreter with int8 quantize / dequantize at its I/O
when the file is int8; TensorFlow must be installed for that), writes a
telemetry JSONL event, and — when confidence falls below the upload
threshold — POSTs the clip to the ingestion API (``serve/api.py``) for
later re-labeling, through ``urllib.request``. Aggregated stats land in
data/device_stats/<device>_stats.json; both feed the dashboard.

CLI: python -m audio_edge_ml_pipeline_torch.serve.edge_simulator \
        --model model.flax.npz|model.tflite --labels label_names.json \
        --dataset <audio_folder> [--device-id sim0] [--n 20] [--interval 0]
        [--api-url http://localhost:8000] [--upload-threshold 0.6]
        [--torch-device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import time
import urllib.request
import uuid
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..data.audio_io import load_audio
from ..utils.device import resolve_device
from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


def multipart_body(boundary: str, fields: dict[str, str], file_field: str, filename: str, content: bytes,
                   content_type: str) -> bytes:
    """A multipart/form-data body: the plain ``fields``, then one file part."""
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{file_field}"; filename="{filename}"'
                 f"\r\nContent-Type: {content_type}\r\n\r\n".encode() + content + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode()


class EdgeDeviceSimulator:
    def __init__(
        self,
        model_path: Path,
        labels: list[str],
        dataset_dir: Path,
        device_id: str = "sim0",
        api_url: str | None = None,
        upload_threshold: float = 0.6,
        telemetry_dir: Path = Path("data/telemetry"),
        stats_dir: Path = Path("data/device_stats"),
        mel_params: dict | None = None,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> None:
        self.model_path = Path(model_path)
        self.labels = labels
        self.dataset_dir = Path(dataset_dir)
        self.device_id = device_id
        self.api_url = api_url
        self.upload_threshold = upload_threshold
        self.telemetry_dir = Path(telemetry_dir)
        self.stats_dir = Path(stats_dir)
        self.mel = mel_params or {"sample_rate": 16000, "n_mels": 40, "n_fft": 512, "hop_length": 160, "duration": 5.0}
        self.rng = random.Random(seed)
        self.torch_device = resolve_device(device)
        self._clips = sorted(self.dataset_dir.rglob("*.wav"))
        if not self._clips:
            raise FileNotFoundError(f"No .wav clips under {self.dataset_dir}")
        self._infer = self._build_inference()
        self.stats = {"total_inferences": 0, "uploads": 0, "confidences": []}

    def _build_inference(self):
        if self.model_path.suffix == ".tflite":
            from ..compilation.tf_forward import tensorflow

            interp = tensorflow().lite.Interpreter(model_path=str(self.model_path))
            interp.allocate_tensors()
            inp = interp.get_input_details()[0]
            out = interp.get_output_details()[0]

            def run(feat: np.ndarray) -> np.ndarray:
                x = feat[None].astype(np.float32)
                if inp["dtype"] == np.int8:
                    scale, zp = inp["quantization"]
                    x = np.clip(np.round(x / scale + zp), -128, 127).astype(np.int8)
                interp.set_tensor(inp["index"], x)
                interp.invoke()
                o = interp.get_tensor(out["index"])[0]
                if out["dtype"] == np.int8:
                    scale, zp = out["quantization"]
                    o = (o.astype(np.float32) - zp) * scale
                return o

            return run
        from ..models.deep import load_any_model

        trainer = load_any_model(self.model_path, device=self.torch_device)

        def run(feat: np.ndarray) -> np.ndarray:
            return trainer.predict_proba(feat[None])[0]

        return run

    def _extract(self, wav_path: Path) -> np.ndarray:
        from ..ops import mel_kernel

        m = self.mel
        y, _ = load_audio(wav_path, sr=m["sample_rate"])
        target = int(m["duration"] * m["sample_rate"])
        y = y[:target] if len(y) >= target else np.pad(y, (0, target - len(y)))
        with torch.inference_mode():
            feat = mel_kernel.mel_spec_feature(
                torch.from_numpy(np.ascontiguousarray(y[None], np.float32)).to(self.torch_device),
                sr=m["sample_rate"], n_mels=m["n_mels"], n_fft=m["n_fft"], hop_length=m["hop_length"],
            )
        return feat[0].cpu().numpy()

    def _upload(self, wav_path: Path, prediction: str, confidence: float) -> bool:
        if not self.api_url:
            return False
        boundary = uuid.uuid4().hex
        fields = {"device_id": self.device_id, "prediction": prediction, "confidence": str(confidence)}
        try:
            body = multipart_body(boundary, fields, "file", wav_path.name, wav_path.read_bytes(), "audio/wav")
            req = urllib.request.Request(f"{self.api_url}/upload", data=body, method="POST",
                                         headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status == 200
        except OSError as exc:   # URLError / HTTPError (a status other than 2xx), a timeout, an unreadable clip
            logger.warning("upload failed: %s", exc)
            return False

    def step(self) -> dict:
        wav_path = self.rng.choice(self._clips)
        feat = self._extract(wav_path)
        probs = self._infer(feat)
        idx = int(np.argmax(probs))
        confidence = float(probs[idx])
        prediction = self.labels[idx] if idx < len(self.labels) else str(idx)
        uploaded = False
        if confidence < self.upload_threshold:
            uploaded = self._upload(wav_path, prediction, confidence)
        event = {
            "timestamp": datetime.now().isoformat(timespec="seconds"),
            "device_id": self.device_id,
            "clip": str(wav_path.name),
            "true_class": wav_path.parent.name,
            "prediction": prediction,
            "confidence": confidence,
            "uploaded": uploaded,
        }
        self.telemetry_dir.mkdir(parents=True, exist_ok=True)
        with open(self.telemetry_dir / f"{self.device_id}_telemetry.jsonl", "a") as f:
            f.write(json.dumps(event) + "\n")
        self.stats["total_inferences"] += 1
        self.stats["uploads"] += int(uploaded)
        self.stats["confidences"].append(confidence)
        self._write_stats()
        return event

    def _write_stats(self) -> None:
        self.stats_dir.mkdir(parents=True, exist_ok=True)
        confs = self.stats["confidences"]
        (self.stats_dir / f"{self.device_id}_stats.json").write_text(
            json.dumps(
                {
                    "device_id": self.device_id,
                    "total_inferences": self.stats["total_inferences"],
                    "uploads": self.stats["uploads"],
                    "avg_confidence": sum(confs) / len(confs) if confs else 0.0,
                    "updated_at": datetime.now().isoformat(timespec="seconds"),
                },
                indent=2,
            )
        )

    def run(self, n: int, interval: float = 0.0, duration: float | None = None) -> None:
        """Run *n* inferences, or until *duration* seconds elapse when given
        (reference edge_simulator.py:362 runs fleets on wall-clock time)."""
        deadline = time.monotonic() + duration if duration else None
        i = 0
        while (deadline is None and i < n) or (deadline is not None and time.monotonic() < deadline):
            event = self.step()
            logger.info(
                "[%s] %s -> %s (%.3f)%s",
                self.device_id, event["clip"], event["prediction"], event["confidence"],
                "  UPLOADED" if event["uploaded"] else "",
            )
            i += 1
            if interval:
                time.sleep(interval)


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(prog="python -m audio_edge_ml_pipeline_torch.serve.edge_simulator")
    p.add_argument("--model", "--model-path", dest="model", required=True)
    p.add_argument("--labels", required=True, help="label_names.json")
    p.add_argument("--dataset", "--data-dir", dest="dataset", required=True,
                   help="class-per-subfolder WAV dir")
    p.add_argument("--device-id", default="sim0")
    p.add_argument("--num-devices", type=int, default=1,
                   help="simulate a fleet: N concurrent devices on one host, "
                        "each running --n inferences "
                        "(ids <device-id>, <device-id>-1, ...)")
    p.add_argument("--n", type=int, default=20)
    p.add_argument("--duration", type=float, default=None,
                   help="run for this many seconds instead of a fixed --n")
    p.add_argument("--interval", type=float, default=0.0)
    p.add_argument("--api-url", default=None)
    p.add_argument("--upload-threshold", type=float, default=0.6)
    p.add_argument("--mel-params", default=None, help="mel_params.json path")
    p.add_argument("--torch-device", default=None,
                   help="torch device for extraction and inference (default: the first CUDA card)")
    args = p.parse_args(argv)
    labels = json.loads(Path(args.labels).read_text())
    mel = json.loads(Path(args.mel_params).read_text()) if args.mel_params else None

    def make_sim(device_id: str, seed: int) -> EdgeDeviceSimulator:
        return EdgeDeviceSimulator(
            Path(args.model), labels, Path(args.dataset), device_id=device_id,
            api_url=args.api_url, upload_threshold=args.upload_threshold, mel_params=mel,
            seed=seed, device=args.torch_device,
        )

    if args.num_devices <= 1:
        make_sim(args.device_id, 0).run(args.n, args.interval, duration=args.duration)
        return
    import threading

    # explicit "-N" suffix: "sim0" + concat would yield ambiguous ids (sim01)
    sims = [make_sim(args.device_id if i == 0 else f"{args.device_id}-{i}", i)
            for i in range(args.num_devices)]
    threads = [
        threading.Thread(
            target=s.run, args=(args.n, args.interval), kwargs={"duration": args.duration}
        )
        for s in sims
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


if __name__ == "__main__":
    main()
