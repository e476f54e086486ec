"""Stage 7 — deployment CLI.

The JAX package's ``deploy/deploy.py``: route the model file to the C
generator, resolve labels (--labels / FeatureSet dir / auto class_filter
from an optimization_report.json) and mel frontend parameters
(optimization_report feature_params -> info.json shape inversion
n_samples = (n_frames - 1) * hop -> CLI overrides), then generate the
PlatformIO project. Host only: nothing runs on a device.

CLI:
    python -m audio_edge_ml_pipeline_torch.deploy.deploy \
        --model <model.flax.npz> --output deploy_out \
        [--labels a b c | --features-dir <featureset dir>] \
        [--report <optimization_report.json>] [--board nicla_vision] \
        [--sample-rate 16000] [--n-mels 40] [--n-fft 512] [--hop-length 160] \
        [--duration 5.0] [--max-ram 180]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from ..utils.logging import setup_logging
from .codegen import BOARDS, ModelToC

logger = logging.getLogger(__name__)


def load_labels(args) -> list[str]:
    if args.labels:
        return list(args.labels)
    if args.features_dir:
        names_path = Path(args.features_dir) / "label_names.json"
        if names_path.exists():
            names = json.loads(names_path.read_text())
            if args.class_filter:
                # explicit CLI filter wins over the report's;
                # canonical class-name-sorted encoding (tune.py contract)
                wanted = set(args.class_filter)
                kept = sorted(n for n in names if n in wanted)
                if not kept:
                    raise SystemExit(f"--class-filter matched none of {names}")
                unknown = sorted(wanted.difference(names))
                if unknown:
                    logger.warning(
                        "--class-filter entries not in label_names.json "
                        "(typo?): %s", unknown,
                    )
                logger.info("Labels filtered by --class-filter: %s", kept)
                return kept
            if args.report:
                report = json.loads(Path(args.report).read_text())
                cf = report.get("class_filter")
                if isinstance(cf, str):
                    try:
                        cf = json.loads(cf)
                    except json.JSONDecodeError:
                        cf = [cf]
                if cf:
                    # canonical class-name-sorted encoding (tune.py contract)
                    names = sorted(n for n in names if n in set(cf))
                    logger.info("Labels filtered by report class_filter: %s", names)
            return names
    raise SystemExit("Need --labels or --features-dir with label_names.json")


def resolve_feature_params(args) -> dict:
    """report feature_params -> info.json inversion -> CLI overrides."""
    params = {
        "sample_rate": None, "n_mels": None, "n_fft": None,
        "hop_length": None, "duration": None,
    }
    if args.report and Path(args.report).exists():
        fp = json.loads(Path(args.report).read_text()).get("feature_params") or {}
        for k in params:
            if fp.get(k) is not None:
                params[k] = fp[k]
    if args.features_dir and any(v is None for v in params.values()):
        info_path = Path(args.features_dir) / "info.json"
        if info_path.exists():
            info = json.loads(info_path.read_text())
            shape = info.get("feature_shape") or []
            if len(shape) == 2:
                n_mels, n_frames = shape
                params["n_mels"] = params["n_mels"] or int(n_mels)
                hop = params["hop_length"] or args.hop_length
                sr = params["sample_rate"] or args.sample_rate
                # invert n_frames = 1 + n_samples // hop
                n_samples = (int(n_frames) - 1) * hop
                params["duration"] = params["duration"] or n_samples / sr
    # CLI overrides / defaults win last
    params["sample_rate"] = args.sample_rate if params["sample_rate"] is None else params["sample_rate"]
    params["n_mels"] = args.n_mels if params["n_mels"] is None else params["n_mels"]
    params["n_fft"] = args.n_fft if params["n_fft"] is None else params["n_fft"]
    params["hop_length"] = args.hop_length if params["hop_length"] is None else params["hop_length"]
    params["duration"] = args.duration if params["duration"] is None else params["duration"]
    if getattr(args, "n_mfcc", None) is not None:
        params["n_mfcc"] = args.n_mfcc
    return params


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.deploy.deploy",
        description="Stage 7 — generate a PlatformIO C project from a model bundle",
    )
    p.add_argument("--model", default=None,
                   help=".npz bundle (fp32 or Stage-6 quantized artifact); defaults to "
                        "the --report's optimized_model_path so the selected quantized "
                        "model is what ships")
    p.add_argument("--output", required=True)
    p.add_argument("--labels", nargs="+", default=None)
    p.add_argument("--class-filter", nargs="+", default=None, metavar="CLASS",
                   help="restrict label_names.json to these classes")
    p.add_argument("--features-dir", default=None)
    p.add_argument("--report", default=None, help="optimization_report.json for auto class_filter / params")
    p.add_argument("--board", default="nicla_vision", choices=sorted(BOARDS))
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--n-mels", type=int, default=40)
    p.add_argument("--n-mfcc", type=int, default=None,
                   help="recorded in the frontend params for MFCC-consuming runtimes "
                        "(the mel C frontend ignores it)")
    p.add_argument("--n-fft", type=int, default=512)
    p.add_argument("--hop-length", type=int, default=160)
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--max-ram", type=float, default=180.0, help="arena budget in KB (0 disables the check)")
    args = p.parse_args(argv)

    model_path = args.model
    if not model_path:
        if not args.report:
            p.error("need --model, or --report with an optimized_model_path")
        report = json.loads(Path(args.report).read_text())
        model_path = report.get("optimized_model_path") or report.get("original_model_path")
        if not model_path:
            p.error(f"{args.report} has no optimized_model_path/original_model_path")
        logger.info("Deploying the report's optimized artifact: %s", model_path)

    labels = load_labels(args)
    fp = resolve_feature_params(args)
    logger.info("Frontend params: %s", fp)
    gen = ModelToC(
        model_path, labels,
        sample_rate=int(fp["sample_rate"]), n_mels=int(fp["n_mels"]), n_fft=int(fp["n_fft"]),
        hop_length=int(fp["hop_length"]), duration=float(fp["duration"]),
        board=args.board, max_ram_kb=(args.max_ram or None),
    )
    out = gen.generate(args.output)
    print(f"Generated project: {out}")
    print(gen.arena.table())
    print("Flash with: pio run --target upload  (from the project directory)")


if __name__ == "__main__":
    main()
