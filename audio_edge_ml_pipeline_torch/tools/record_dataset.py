"""Record labelled clips from a device over serial into an audio_folder
layout (contract of reference tools/record_dataset.py): the device streams
magic-framed PCM captures (PCM_DUMP_MODE firmware); the operator names the
class being recorded and each capture is saved under
<out>/<class>/rec_NNN.wav. With --source-dir the host plays randomly chosen
clips of that class from an existing dataset through the speakers while the
device records (reference record_dataset.py:269-276), closing the
speaker->mic->device loop.

The port's counterpart of the repository's ``tools/record_dataset.py``: its
flags, files and clip choice (``random.Random(--seed)``), on the port's
``write_wav`` and ``fsc22_metadata``.

Usage: python -m audio_edge_ml_pipeline_torch.tools.record_dataset --port /dev/ttyACM0 \
           --class Chainsaw [--n 30] [--output data/raw/fsc22_device] \
           [--source-dir data/raw/fsc22] [--seed 7] [--sample-rate 16000]
"""

from __future__ import annotations

import argparse
import random
import subprocess
from pathlib import Path

from ..data.audio_io import write_wav
from ..data.loaders import fsc22_metadata
from . import serial_proto

_AUDIO_EXTS = {".wav", ".flac", ".ogg", ".mp3", ".aiff"}


def _source_clips(source_dir: Path, label: str) -> list[Path]:
    """Clips of *label* under an audio_folder (Class/file.wav) layout, or a
    flat FSC22 layout filtered through the metadata CSV — a flat dir without
    metadata cannot be class-filtered, so refuse rather than play (and
    mislabel) clips of every class."""
    class_dir = source_dir / label
    if class_dir.is_dir():
        return sorted(p for p in class_dir.iterdir() if p.suffix.lower() in _AUDIO_EXTS)
    try:
        audio_dir, df = fsc22_metadata(source_dir)
    except FileNotFoundError:
        raise SystemExit(
            f"{source_dir} has neither a {label}/ subdirectory nor an FSC22 "
            "metadata CSV — cannot select clips of one class from a flat dir"
        )
    names = set(df[df["Class Name"] == label]["Dataset File Name"].astype(str))
    root = audio_dir or source_dir
    return sorted(p for p in root.iterdir() if p.name in names)


def record(ser, out_dir: Path, label: str, count: int, sample_rate: int,
           interactive: bool = True, source_clips: list[Path] | None = None,
           rng: random.Random | None = None) -> list[Path]:
    class_dir = out_dir / label
    class_dir.mkdir(parents=True, exist_ok=True)
    # next index after the HIGHEST existing one — a count would re-use
    # indices (and overwrite captures) whenever numbering has gaps
    taken = [int(p.stem[4:]) for p in class_dir.glob("rec_*.wav") if p.stem[4:].isdigit()]
    existing = max(taken) + 1 if taken else 0
    saved = []
    for i in range(count):
        if source_clips:
            clip = (rng or random).choice(source_clips)
            print(f"[{label}] playing {clip.name} ({i + 1}/{count})")
            try:
                subprocess.run(["aplay", "-q", str(clip)], check=False, timeout=30)
            except FileNotFoundError:
                raise SystemExit("aplay not found — omit --source-dir and provide sound live")
        elif interactive:
            input(f"[{label}] press Enter to capture clip {i + 1}/{count} ...")
        pcm = serial_proto.read_pcm_frame(ser)
        path = class_dir / f"rec_{existing + i:03d}.wav"
        write_wav(path, pcm.astype("float32") / 32768.0, sample_rate)
        print(f"saved {path}  ({len(pcm)} samples, peak {abs(pcm).max()})")
        saved.append(path)
    return saved


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", default=None,
                    help="serial port (default: auto-detect)")
    ap.add_argument("--baud", type=int, default=115200)
    ap.add_argument("--out", "--output", dest="out", type=Path,
                    default=Path("data/raw/fsc22_device"))
    ap.add_argument("--label", "--class", dest="label", required=True,
                    help="class label to record (e.g. Chainsaw)")
    ap.add_argument("--count", "--n", dest="count", type=int, default=30)
    ap.add_argument("--source-dir", type=Path, default=None,
                    help="dataset root to play clips from; omitted = live sound")
    ap.add_argument("--seed", type=int, default=None, help="RNG seed for clip selection")
    ap.add_argument("--sample-rate", type=int, default=16000)
    ap.add_argument("--no-prompt", action="store_true")
    args = ap.parse_args(argv)

    port = args.port or serial_proto.autodetect_port()
    ser = serial_proto.open_serial(port, args.baud, timeout=120)
    clips = _source_clips(args.source_dir, args.label) if args.source_dir else None
    if args.source_dir and not clips:
        raise SystemExit(f"no audio for class {args.label!r} under {args.source_dir}")
    record(ser, args.out, args.label, args.count, args.sample_rate,
           interactive=not args.no_prompt, source_clips=clips,
           rng=random.Random(args.seed))


if __name__ == "__main__":
    main()
