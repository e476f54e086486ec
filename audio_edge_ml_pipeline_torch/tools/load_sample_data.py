"""Upload sample WAV clips to a running ingestion API (role of reference
scripts/load_sample_data.py; the downloader counterpart is
scripts/download_data.py).

The port's counterpart of the repository's ``scripts/load_sample_data.py``:
the same multipart fields (``file``, ``true_class``, ``source``), posted
with ``urllib`` and the port's ``serve.edge_simulator.multipart_body``, so
it needs no ``requests``.

Usage: python -m audio_edge_ml_pipeline_torch.tools.load_sample_data --dataset <audio_folder>
           [--api-url http://localhost:8000] [--n 5]
"""

from __future__ import annotations

import argparse
import json
import urllib.error
import urllib.request
import uuid
from pathlib import Path

from ..serve.edge_simulator import multipart_body


def post_clip(api_url: str, clip: Path, timeout: float = 15) -> tuple[int, dict]:
    """POST one clip to ``<api_url>/upload``: (status code, the JSON reply)."""
    boundary = uuid.uuid4().hex
    body = multipart_body(boundary, {"true_class": clip.parent.name, "source": "load_sample_data"}, "file",
                          clip.name, clip.read_bytes(), "audio/wav")
    req = urllib.request.Request(f"{api_url}/upload", data=body, method="POST",
                                 headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:   # a reply with another status than 2xx, as requests returns it
        return exc.code, json.loads(exc.read())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", required=True, type=Path)
    ap.add_argument("--api-url", default="http://localhost:8000")
    ap.add_argument("--n", type=int, default=5)
    args = ap.parse_args(argv)

    clips = sorted(args.dataset.rglob("*.wav"))[: args.n]
    if not clips:
        raise SystemExit(f"no .wav under {args.dataset}")
    for clip in clips:
        status, reply = post_clip(args.api_url, clip)
        print(f"{clip.name}: {status} {reply}")


if __name__ == "__main__":
    main()
