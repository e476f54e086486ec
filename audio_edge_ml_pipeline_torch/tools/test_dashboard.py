"""Dashboard smoke test: write synthetic telemetry, render the page, and
optionally serve it (role of reference scripts/test_dashboard.py).

The port's counterpart of the repository's ``scripts/test_dashboard.py``,
on the port's ``serve/dashboard.py`` (stdlib HTTP; PNG panels where
matplotlib is installed). The module keeps the script's name; pytest
collects only ``tests/``, so it is not taken for a test.

Usage: python -m audio_edge_ml_pipeline_torch.tools.test_dashboard [--serve] [--port 8501]
"""

from __future__ import annotations

import argparse
import json
import tempfile
from datetime import datetime
from pathlib import Path

from ..serve.dashboard import create_server, load_stats, load_telemetry, render


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--port", type=int, default=8501)
    args = ap.parse_args(argv)

    root = Path(tempfile.mkdtemp(prefix="dash_smoke_"))
    tdir, sdir = root / "telemetry", root / "stats"
    tdir.mkdir()
    sdir.mkdir()
    events = [
        {"timestamp": datetime.now().isoformat(timespec="seconds"),
         "prediction": cls, "confidence": conf, "uploaded": conf < 0.6}
        for cls, conf in [("Fire", 0.91), ("Rain", 0.44), ("Wind", 0.77), ("Fire", 0.83)]
    ]
    (tdir / "smoke0_telemetry.jsonl").write_text("\n".join(json.dumps(e) for e in events))
    (sdir / "smoke0_stats.json").write_text(json.dumps(
        {"total_inferences": 4, "avg_confidence": 0.7375, "uploads": 1}))
    page = render(load_telemetry(tdir), load_stats(sdir))
    assert "smoke0" in page and "Fire" in page, "render failed"
    print(f"render OK ({len(page)} bytes of HTML)")
    if args.serve:
        server = create_server(tdir, sdir, args.port)
        print(f"serving smoke dashboard on http://localhost:{args.port} (Ctrl-C to stop)")
        server.serve_forever()


if __name__ == "__main__":
    main()
