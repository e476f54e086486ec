"""Generate tiny synthetic datasets for tests and end-to-end verification.

Layouts produced under <out_root>:
  fsc22/                    FSC22-style flat dir + metadata CSV
  audio_folder/             class-per-subfolder WAV tree
  text.csv, tabular.csv     text/tabular sample files
  images/                   class-per-subfolder PNG tree

Each audio class k is a distinguishable signal family (harmonic stack at a
class-specific f0 + class-specific noise level), so small models genuinely
separate them — keeping end-to-end train tests meaningful.

The port's counterpart of the repository's ``tools/make_synth_dataset.py``:
the same signals, seeds, names and writers, so every file is byte for byte
the JAX tool's. Host only (numpy, PIL for the PNG tree).

Usage: python -m audio_edge_ml_pipeline_torch.tools.make_synth_dataset /tmp/synth \
           [--classes 6] [--per-class 12] [--sr 16000]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.audio_io import write_wav

CLASS_NAMES = [
    "Chainsaw", "Fire", "Rain", "Thunder", "WaterDrops", "Wind",
    "Birdsong", "Axe", "Footsteps", "Whistle", "Engine", "Clapping",
]


def synth_clip(class_idx: int, item_idx: int, sr: int = 16000, seconds: float = 5.0) -> np.ndarray:
    rng = np.random.default_rng(1000 * class_idx + item_idx)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = 130.0 * (1.6 ** class_idx) % 3800 + 80
    y = np.zeros(n)
    for h in range(1, 4):
        y += (0.5 / h) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    # class-dependent amplitude modulation + noise floor
    y *= 0.5 + 0.5 * np.sin(2 * np.pi * (0.5 + 0.3 * class_idx) * t) ** 2
    y += (0.02 + 0.01 * class_idx) * rng.standard_normal(n)
    if class_idx % 3 == 0:  # transient bursts
        for _ in range(4):
            s = rng.integers(0, n - sr // 10)
            y[s : s + sr // 10] += 0.6 * rng.standard_normal(sr // 10)
    peak = np.abs(y).max()
    return (0.8 * y / peak).astype(np.float32)


def class_name(c: int) -> str:
    """Unique name per class index — wrapping CLASS_NAMES would merge two
    signal families under one label (and overwrite audio_folder files)."""
    base = CLASS_NAMES[c % len(CLASS_NAMES)]
    return base if c < len(CLASS_NAMES) else f"{base}{c // len(CLASS_NAMES) + 1}"


def make_fsc22(root: Path, n_classes: int, per_class: int, sr: int) -> None:
    audio_dir = root / "Audio Wise V1.0-20260101" / "Audio Wise V1.0"
    meta_dir = root / "Metadata-20260101" / "Metadata"
    audio_dir.mkdir(parents=True, exist_ok=True)
    meta_dir.mkdir(parents=True, exist_ok=True)
    rows = ["Source File Name,Dataset File Name,Class ID,Class Name"]
    for c in range(n_classes):
        for i in range(per_class):
            fname = f"{c + 1}_{i + 1}.wav"
            write_wav(audio_dir / fname, synth_clip(c, i, sr=sr), sr)
            rows.append(f"src_{fname},{fname},{c + 1},{class_name(c)}")
    (meta_dir / "Metadata V1.0 FSC22.csv").write_text("\n".join(rows) + "\n")


def make_audio_folder(root: Path, n_classes: int, per_class: int, sr: int) -> None:
    for c in range(n_classes):
        cdir = root / class_name(c)
        cdir.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            write_wav(cdir / f"clip_{i:03d}.wav", synth_clip(c, i, sr=sr), sr)


def make_text_csv(path: Path, n_classes: int = 3, per_class: int = 20) -> None:
    words = {
        0: ["forest", "tree", "leaf", "bark", "root", "moss"],
        1: ["river", "water", "stream", "flow", "wave", "rain"],
        2: ["engine", "motor", "gear", "steel", "fuel", "piston"],
    }
    rows = ["text,label"]
    rng = np.random.default_rng(7)
    for c in range(n_classes):
        for i in range(per_class):
            ws = rng.choice(words[c % 3], size=8)
            rows.append('"' + " ".join(ws) + f'",class_{c}')
    path.write_text("\n".join(rows) + "\n")


def make_tabular_csv(path: Path, n: int = 120) -> None:
    rng = np.random.default_rng(11)
    rows = ["f1,f2,category,when,label"]
    for i in range(n):
        c = i % 3
        f1 = rng.normal(c * 2.0, 0.5)
        f2 = rng.normal(-c, 0.3)
        cat = ["red", "green", "blue"][int(rng.integers(0, 3))]
        when = f"2026-0{c + 1}-1{i % 9} 0{c}:00:00"
        rows.append(f"{f1:.4f},{f2:.4f},{cat},{when},class_{c}")
    path.write_text("\n".join(rows) + "\n")


def make_images(root: Path, n_classes: int = 3, per_class: int = 8, size: int = 64) -> None:
    from PIL import Image

    rng = np.random.default_rng(5)
    for c in range(n_classes):
        cdir = root / f"shape_{c}"
        cdir.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            img = np.zeros((size, size, 3), np.uint8)
            img[:] = rng.integers(0, 60, 3)
            if c == 0:  # square
                img[16:48, 16:48] = (200, 50, 50)
            elif c == 1:  # stripes
                img[:, ::4] = (50, 200, 50)
            else:  # gradient
                img[:, :, 2] = np.linspace(0, 255, size, dtype=np.uint8)[None, :]
            noise = rng.integers(0, 30, (size, size, 3), dtype=np.uint8)
            Image.fromarray(np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)).save(
                cdir / f"img_{i:02d}.png"
            )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_root", type=Path)
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--per-class", type=int, default=12)
    ap.add_argument("--sr", type=int, default=16000)
    args = ap.parse_args(argv)
    root = args.out_root
    make_fsc22(root / "fsc22", args.classes, args.per_class, args.sr)
    make_audio_folder(root / "audio_folder", args.classes, args.per_class, args.sr)
    make_text_csv(root / "text.csv")
    make_tabular_csv(root / "tabular.csv")
    make_images(root / "images")
    print(f"Synthetic datasets written to {root}")


if __name__ == "__main__":
    main()
