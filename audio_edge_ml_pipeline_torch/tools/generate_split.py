"""Generate a frozen stratified split manifest (train/val/test) for an audio
dataset — the leakage guard consumed by AudioFolderLoader and the
augmentation stage.

Contract of reference tools/generate_split.py:1-210: 70/15/15 stratified
split with seed 42, folder or fsc22 layouts, relative "Class/file.wav"
paths, and a re-run drift guard: if a manifest already exists and any file
would move between splits, the tool warns and refuses unless --force.

The port's counterpart of the repository's ``tools/generate_split.py``, with
its flags, manifest and exit codes, on the port's
``data.loaders.stratified_split_indices`` and ``fsc22_metadata``.

Usage:
    python -m audio_edge_ml_pipeline_torch.tools.generate_split --dataset <audio_folder_root> \
        [--layout folder|fsc22] [--output <root>/split_manifest.json] \
        [--train 0.7 --val 0.15] [--seed 42] [--force]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.loaders import fsc22_metadata, stratified_split_indices

_AUDIO_EXTS = {".wav", ".flac", ".ogg", ".mp3", ".aiff"}


def collect_folder(root: Path) -> list[tuple[str, str]]:
    """[(relative_path, class_name)] for class-per-subfolder layout."""
    out = []
    for class_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        for f in sorted(class_dir.iterdir()):
            if f.suffix.lower() in _AUDIO_EXTS:
                out.append((f"{class_dir.name}/{f.name}", class_dir.name))
    return out


def collect_fsc22(root: Path) -> list[tuple[str, str]]:
    _, df = fsc22_metadata(root)
    return [(str(r["Dataset File Name"]), str(r["Class Name"])) for _, r in df.iterrows()]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", "--input", dest="dataset", required=True, type=Path,
                    help="root of the dataset directory")
    ap.add_argument("--layout", "--loader", dest="layout",
                    choices=["folder", "audio_folder", "fsc22"], default="folder",
                    help="folder/audio_folder = class-per-subfolder; fsc22 = flat audio + CSV")
    ap.add_argument("--output", type=Path, default=None)
    ap.add_argument("--train", type=float, default=0.70)
    ap.add_argument("--val", type=float, default=0.15)
    ap.add_argument("--test", type=float, default=None,
                    help="test fraction (informational; the remainder after train+val)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.test is not None and abs(args.train + args.val + args.test - 1.0) > 1e-6:
        raise SystemExit(f"--train + --val + --test must sum to 1 (got {args.train + args.val + args.test})")
    samples = collect_fsc22(args.dataset) if args.layout == "fsc22" else collect_folder(args.dataset)
    if not samples:
        raise SystemExit(f"No audio files found under {args.dataset}")
    labels = [c for _, c in samples]
    split_names = stratified_split_indices(labels, args.train, args.val, args.seed)
    manifest = {"train": [], "val": [], "test": []}
    key_map = {"train": "train", "validation": "val", "test": "test"}
    for (rel, _), sp in zip(samples, split_names):
        manifest[key_map[sp]].append(rel)

    out = args.output or args.dataset / "split_manifest.json"
    if out.exists():
        old = json.loads(out.read_text())
        old_assign = {f: s for s in ("train", "val", "test") for f in old.get(s, [])}
        new_assign = {f: s for s in ("train", "val", "test") for f in manifest[s]}
        drifted = [f for f in old_assign if f in new_assign and old_assign[f] != new_assign[f]]
        if drifted and not args.force:
            print(f"DRIFT GUARD: {len(drifted)} file(s) would change split (e.g. {drifted[:3]}).")
            print("A changed split leaks evaluation data into training. Re-run with --force to overwrite.")
            raise SystemExit(1)
        if drifted:
            print(f"WARNING: overwriting manifest; {len(drifted)} file(s) changed split (--force).")

    out.write_text(json.dumps(manifest, indent=2))
    print(
        f"Manifest written: {out}\n"
        f"  train: {len(manifest['train'])}  val: {len(manifest['val'])}  test: {len(manifest['test'])}"
    )


if __name__ == "__main__":
    main()
