"""Fleet monitoring dashboard.

Counterpart of the JAX package's ``serve/dashboard.py``, page for page.
Reads data/telemetry/*_telemetry.jsonl and data/device_stats/*_stats.json
(the formats the edge simulator writes) and serves an auto-refreshing HTML
dashboard: per-device stat tiles, prediction class distribution, confidence
histogram, and the recent event table. It is a stdlib HTTP server rendering
static HTML with matplotlib PNG chart panels embedded base64 (fleet overview
+ per-device timeline/histogram/distribution). matplotlib is imported only
when a page is rendered; without it the page is text only.

CLI: python -m audio_edge_ml_pipeline_torch.serve.dashboard [--port 8501]
        [--telemetry-dir data/telemetry] [--stats-dir data/device_stats]
"""

from __future__ import annotations

import argparse
import html
import json
import logging
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


def load_telemetry(telemetry_dir: Path) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    if not telemetry_dir.exists():
        return out
    for f in sorted(telemetry_dir.glob("*_telemetry.jsonl")):
        device = f.name.replace("_telemetry.jsonl", "")
        events = []
        for line in f.read_text().splitlines():
            line = line.strip()
            if line:
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        out[device] = events
    return out


def load_stats(stats_dir: Path) -> dict[str, dict]:
    out: dict[str, dict] = {}
    if not stats_dir.exists():
        return out
    for f in sorted(stats_dir.glob("*_stats.json")):
        device = f.name.replace("_stats.json", "")
        try:
            out[device] = json.loads(f.read_text())
        except json.JSONDecodeError:
            continue
    return out


def _bar(frac: float, width: int = 24) -> str:
    filled = int(round(max(0.0, min(1.0, frac)) * width))
    return "&#9608;" * filled + "&#9617;" * (width - filled)


# -- matplotlib PNG panels: Agg PNGs embedded base64 in the stdlib HTML page,
# -- with the text tables kept as the data fallback --

# dark-surface chart tokens: one accent hue per single-series panel (no
# categorical palette to cycle), recessive grid, text in ink — marks carry
# identity, text stays neutral
_CH = {
    "surface": "#101418",
    "panel": "#161b22",
    "ink": "#d8dee9",
    "muted": "#9aa5b1",
    "grid": "#2a2f36",
    "accent": "#79a8ff",  # single-series mark hue (light blue, reads on dark)
    "threshold": "#e06c75",  # status/serious: dashed + text label, never bare
}


def _mpl():
    """matplotlib.pyplot with the Agg backend, or None when not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def _style_axes(ax) -> None:
    ax.set_facecolor(_CH["panel"])
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_CH["grid"])
    ax.tick_params(colors=_CH["muted"], labelsize=7)
    ax.yaxis.grid(True, color=_CH["grid"], linewidth=0.6)
    ax.set_axisbelow(True)
    ax.title.set_color(_CH["ink"])
    ax.title.set_fontsize(9)
    ax.xaxis.label.set_color(_CH["muted"])
    ax.yaxis.label.set_color(_CH["muted"])


def _fig_to_img(fig, alt: str) -> str:
    import base64
    import io

    buf = io.BytesIO()
    fig.savefig(buf, format="png", facecolor=_CH["surface"], bbox_inches="tight", dpi=110)
    import matplotlib.pyplot as plt

    plt.close(fig)
    data = base64.b64encode(buf.getvalue()).decode("ascii")
    return f"<img alt='{html.escape(alt)}' src='data:image/png;base64,{data}' style='max-width:100%'>"


def _parse_ts(events: list[dict]) -> list:
    """Event timestamps as datetimes; falls back to None entries."""
    from datetime import datetime

    out = []
    for e in events:
        try:
            out.append(datetime.fromisoformat(str(e.get("timestamp", ""))))
        except ValueError:
            out.append(None)
    return out


def _bucket_counts(times: list, values: list, width_s: int = 10):
    """(bucket_start, count, mean_value) per width_s window, time-ordered."""
    pairs = sorted((t, v) for t, v in zip(times, values) if t is not None)
    if not pairs:
        return [], [], []
    t0 = pairs[0][0]
    buckets: dict[int, list] = {}
    for t, v in pairs:
        buckets.setdefault(int((t - t0).total_seconds() // width_s), []).append(v)
    keys = sorted(buckets)
    xs = [k * width_s for k in keys]
    counts = [len(buckets[k]) for k in keys]
    means = [sum(buckets[k]) / len(buckets[k]) for k in keys]
    return xs, counts, means


def render_fleet_charts(telemetry: dict[str, list[dict]], threshold: float = 0.25) -> str:
    """Fleet overview PNG: inferences/10 s, avg confidence/10 s (with the
    upload threshold marked), accuracy by device, avg confidence by device."""
    plt = _mpl()
    all_events = [e for evs in telemetry.values() for e in evs]
    if plt is None or not all_events:
        return ""
    times = _parse_ts(all_events)
    confs = [float(e.get("confidence", 0.0)) for e in all_events]
    xs, counts, mean_conf = _bucket_counts(times, confs)

    fig, axes = plt.subplots(2, 2, figsize=(9.2, 5.2))
    fig.patch.set_facecolor(_CH["surface"])
    ax = axes[0][0]
    _style_axes(ax)
    ax.set_title("inferences per 10 s")
    if xs:
        ax.plot(xs, counts, color=_CH["accent"], linewidth=2)
        ax.set_xlabel("seconds since first event")
    ax.set_ylim(bottom=0)

    ax = axes[0][1]
    _style_axes(ax)
    ax.set_title("avg confidence per 10 s")
    if xs:
        ax.plot(xs, mean_conf, color=_CH["accent"], linewidth=2)
        ax.set_xlabel("seconds since first event")
    ax.axhline(threshold, color=_CH["threshold"], linestyle="--", linewidth=1.2)
    ax.text(
        0.99, threshold, f" upload threshold {threshold:g}", color=_CH["threshold"],
        fontsize=7, ha="right", va="bottom", transform=ax.get_yaxis_transform(),
    )
    ax.set_ylim(0, 1)

    devices = sorted(telemetry)
    ax = axes[1][0]
    _style_axes(ax)
    ax.set_title("accuracy by device (%)")
    accs, names = [], []
    for d in devices:
        evs = [e for e in telemetry[d] if e.get("true_class") is not None]
        if evs:
            names.append(d)
            accs.append(100.0 * sum(e.get("prediction") == e.get("true_class") for e in evs) / len(evs))
    if names:
        ax.bar(names, accs, color=_CH["accent"], width=0.6)
        ax.set_ylim(0, 100)
        ax.tick_params(axis="x", rotation=20)
    else:
        ax.text(0.5, 0.5, "no labeled telemetry", color=_CH["muted"], ha="center", transform=ax.transAxes)

    ax = axes[1][1]
    _style_axes(ax)
    ax.set_title("avg confidence by device")
    means = [
        (sum(float(e.get("confidence", 0.0)) for e in telemetry[d]) / max(1, len(telemetry[d])))
        for d in devices
    ]
    ax.bar(devices, means, color=_CH["accent"], width=0.6)
    ax.set_ylim(0, 1)
    ax.tick_params(axis="x", rotation=20)

    fig.tight_layout()
    return _fig_to_img(fig, "fleet overview charts")


def render_device_charts(device: str, events: list[dict]) -> str:
    """Per-device PNG row: prediction timeline, confidence histogram, class
    distribution."""
    plt = _mpl()
    if plt is None or not events:
        return ""
    preds = [str(e.get("prediction", "?")) for e in events]
    confs = [float(e.get("confidence", 0.0)) for e in events]
    classes = sorted(set(preds))
    class_idx = {c: i for i, c in enumerate(classes)}

    fig, axes = plt.subplots(1, 3, figsize=(10.5, 2.6))
    fig.patch.set_facecolor(_CH["surface"])

    ax = axes[0]
    _style_axes(ax)
    ax.set_title("prediction timeline")
    ax.step(range(len(preds)), [class_idx[p] for p in preds], where="post",
            color=_CH["accent"], linewidth=1.6)
    ax.set_yticks(range(len(classes)))
    ax.set_yticklabels(classes, fontsize=6)
    ax.set_xlabel("event #")

    ax = axes[1]
    _style_axes(ax)
    ax.set_title("confidence histogram")
    ax.hist(confs, bins=20, range=(0.0, 1.0), color=_CH["accent"])
    ax.set_xlabel("confidence")

    ax = axes[2]
    _style_axes(ax)
    ax.set_title("class distribution")
    counts = Counter(preds)
    names = [c for c, _ in counts.most_common()][::-1]
    ax.barh(names, [counts[c] for c in names], color=_CH["accent"], height=0.6)
    ax.tick_params(axis="y", labelsize=6)

    fig.tight_layout()
    return _fig_to_img(fig, f"{device} charts")


def render(telemetry: dict[str, list[dict]], stats: dict[str, dict]) -> str:
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        "<meta http-equiv='refresh' content='5'>",
        "<title>Edge fleet dashboard</title>",
        "<style>body{font-family:monospace;margin:2em;background:#101418;color:#d8dee9}"
        "table{border-collapse:collapse}td,th{border:1px solid #333;padding:4px 10px}"
        "h2{color:#88c0d0}.tile{display:inline-block;border:1px solid #444;"
        "padding:10px 18px;margin:6px;border-radius:6px;background:#161b22}"
        ".big{font-size:1.6em;color:#a3be8c}</style></head><body>",
        "<h1>Edge fleet dashboard</h1>",
    ]
    if not telemetry and not stats:
        parts.append("<p>No telemetry yet. Waiting for devices...</p>")
    fleet_img = render_fleet_charts(telemetry)
    if fleet_img:
        parts.append("<h2>fleet overview</h2>")
        parts.append(fleet_img)
    for device in sorted(set(telemetry) | set(stats)):
        events = telemetry.get(device, [])
        st = stats.get(device, {})
        parts.append(f"<h2>{html.escape(device)}</h2>")
        n_inf = st.get("total_inferences", len(events))
        avg_conf = st.get("avg_confidence")
        if avg_conf is None and events:
            confs = [e.get("confidence", 0.0) for e in events]
            avg_conf = sum(confs) / len(confs)
        uploads = st.get("uploads", sum(1 for e in events if e.get("uploaded")))
        parts.append("<div>")
        parts.append(f"<span class='tile'>inferences<br><span class='big'>{n_inf}</span></span>")
        parts.append(
            f"<span class='tile'>avg confidence<br><span class='big'>{(avg_conf or 0.0):.3f}</span></span>"
        )
        parts.append(f"<span class='tile'>uploads<br><span class='big'>{uploads}</span></span>")
        parts.append("</div>")
        if events:
            dev_img = render_device_charts(device, events)
            if dev_img:
                parts.append(dev_img)
            counts = Counter(e.get("prediction", "?") for e in events)
            total = sum(counts.values())
            parts.append("<h3>class distribution</h3><table>")
            for cls, cnt in counts.most_common():
                parts.append(
                    f"<tr><td>{html.escape(str(cls))}</td><td>{cnt}</td>"
                    f"<td>{_bar(cnt / total)}</td></tr>"
                )
            parts.append("</table><h3>recent events</h3><table>")
            parts.append("<tr><th>time</th><th>prediction</th><th>confidence</th><th>uploaded</th></tr>")
            for e in events[-12:][::-1]:
                parts.append(
                    f"<tr><td>{html.escape(str(e.get('timestamp', '')))}</td>"
                    f"<td>{html.escape(str(e.get('prediction', '')))}</td>"
                    f"<td>{e.get('confidence', 0.0):.3f}</td>"
                    f"<td>{'yes' if e.get('uploaded') else ''}</td></tr>"
                )
            parts.append("</table>")
    parts.append("</body></html>")
    return "".join(parts)


class DashboardHandler(BaseHTTPRequestHandler):
    telemetry_dir = Path("data/telemetry")
    stats_dir = Path("data/device_stats")

    def do_GET(self):  # noqa: N802
        page = render(load_telemetry(self.telemetry_dir), load_stats(self.stats_dir)).encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(page)))
        self.end_headers()
        self.wfile.write(page)

    def log_message(self, fmt, *args):
        logger.debug(fmt, *args)


def create_server(telemetry_dir="data/telemetry", stats_dir="data/device_stats", port: int = 8501):
    handler = type(
        "Handler", (DashboardHandler,),
        {"telemetry_dir": Path(telemetry_dir), "stats_dir": Path(stats_dir)},
    )
    return ThreadingHTTPServer(("0.0.0.0", port), handler)


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(prog="python -m audio_edge_ml_pipeline_torch.serve.dashboard")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--telemetry-dir", default="data/telemetry")
    p.add_argument("--stats-dir", default="data/device_stats")
    args = p.parse_args(argv)
    server = create_server(args.telemetry_dir, args.stats_dir, args.port)
    logger.info("Dashboard on :%d", args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
