"""Ingestion-side batch preprocessor.

Counterpart of the JAX package's ``serve/audio_processor.py``. Walks an
uploads directory of WAV files with JSON metadata sidecars (as the ingestion
API writes them) and extracts mel-spectrogram features to .npy through the
registered ``audio_mel_spec`` extractor on the torch device (the folded-mel
kernel on a CUDA card), so ingestion features equal pipeline features.

An upload that cannot be read (the WAV reader's ValueError, OSError or
EOFError) is logged and skipped, as in JAX. Anything else, a kernel that
does not build or launch among them, ends the run: JAX skips a file on any
exception, which here would turn a device failure into "Processed 0 uploads"
and exit code 0.

CLI: python -m audio_edge_ml_pipeline_torch.serve.audio_processor \
        --input data/raw/uploads --output data/processed/uploads [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..features import get
from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)

# what reading a bad upload raises: a malformed RIFF, a missing or unreadable file, a cut-off stream
UNREADABLE = (ValueError, OSError, EOFError)


class AudioPreprocessor:
    def __init__(self, sample_rate: int = 16000, n_mels: int = 40, n_fft: int = 512,
                 hop_length: int = 160, duration: float | None = 5.0,
                 device: torch.device | str | None = None) -> None:
        self.extractor = get("audio_mel_spec")(
            sample_rate=sample_rate, n_mels=n_mels, n_fft=n_fft,
            hop_length=hop_length, duration=duration, device=device,
        )

    def process_file(self, wav_path: Path, out_dir: Path) -> Path:
        feat = self.extractor.extract(wav_path)
        out = Path(out_dir) / (wav_path.stem + ".npy")
        np.save(out, feat)
        return out

    def process_dataset(self, input_dir: Path, output_dir: Path) -> int:
        input_dir, output_dir = Path(input_dir), Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        for wav in sorted(input_dir.glob("*.wav")):
            meta_path = wav.with_suffix(".json")
            meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
            try:
                out = self.process_file(wav, output_dir)
            except UNREADABLE as exc:
                logger.warning("skipping %s: %s", wav, exc)
                continue
            if meta:
                (output_dir / (wav.stem + ".json")).write_text(json.dumps(meta, indent=2))
            n += 1
            logger.info("processed %s -> %s", wav.name, out.name)
        return n


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(prog="python -m audio_edge_ml_pipeline_torch.serve.audio_processor")
    p.add_argument("--input", default="data/raw/uploads")
    p.add_argument("--output", default="data/processed/uploads")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--n-mels", type=int, default=40)
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--device", default=None,
                   help="torch device to extract on (default: the first CUDA card; 'cpu' runs the plain version)")
    args = p.parse_args(argv)
    proc = AudioPreprocessor(sample_rate=args.sample_rate, n_mels=args.n_mels, duration=args.duration,
                             device=args.device)
    n = proc.process_dataset(args.input, args.output)
    print(f"Processed {n} uploads -> {args.output}")


if __name__ == "__main__":
    main()
