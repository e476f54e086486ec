"""Receive magic-framed PCM dumps from a device running PCM_DUMP_MODE and
save them as WAV files (pairs with the firmware's PCM_DUMP_MODE; contract of
reference tools/receive_wav.py:105-115 including the
data/debug/<experiment>/wav/ layout and count=0 capture loop).

The port's counterpart of the repository's ``tools/receive_wav.py``: its
flags and files, written by the port's ``data.audio_io.write_wav``.

Usage: python -m audio_edge_ml_pipeline_torch.tools.receive_wav [--port /dev/ttyACM0]
           [--out out.wav | --experiment name] [--count 1] [--sample-rate 16000]
"""

from __future__ import annotations

import argparse
from datetime import datetime
from pathlib import Path

from ..data.audio_io import write_wav
from . import serial_proto


def receive(ser, out_dir: Path, count: int, sample_rate: int,
            out_path: Path | None = None) -> list[Path]:
    """Capture *count* PCM frames (0 = loop until interrupted)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    saved = []
    i = 0
    while count == 0 or i < count:
        pcm = serial_proto.read_pcm_frame(ser)
        path = out_path if (out_path and count == 1) else (
            out_dir / f"capture_{datetime.now().strftime('%Y%m%d_%H%M%S')}_{i:02d}.wav"
        )
        write_wav(path, pcm.astype("float32") / 32768.0, sample_rate)
        print(f"saved {path}  ({len(pcm)} samples)")
        saved.append(path)
        i += 1
    return saved


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", default=None, help="serial port (default: auto-detect)")
    ap.add_argument("--baud", type=int, default=115200)
    ap.add_argument("--out", type=Path, default=None,
                    help="output .wav path (count=1) or directory; default auto-named "
                         "under data/debug/<experiment>/wav/")
    ap.add_argument("--experiment", default="default",
                    help="experiment name — determines data/debug/<experiment>/wav/")
    ap.add_argument("--count", type=int, default=1,
                    help="number of recordings (default 1, 0 = loop forever)")
    ap.add_argument("--sample-rate", type=int, default=16000)
    args = ap.parse_args(argv)
    ser = serial_proto.open_serial(args.port or serial_proto.autodetect_port(),
                                   args.baud, timeout=30)
    if args.out and args.out.suffix.lower() == ".wav":
        out_dir, out_path = args.out.parent, args.out
    else:
        out_dir = args.out or Path("data/debug") / args.experiment / "wav"
        out_path = None
    receive(ser, out_dir, args.count, args.sample_rate, out_path=out_path)


if __name__ == "__main__":
    main()
