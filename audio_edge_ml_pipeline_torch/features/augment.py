"""Stage 1b — audio augmentation CLI.

Counterpart of the JAX package's ``features/augment.py``, with the same
YAML schema, validation, defaults, per-file seeds, output tree and output
bytes. Contract of reference augment.py:88-419: seven augmentors (volume_scale,
gaussian_noise, time_stretch, pitch_shift, time_shift, polarity_inversion,
pdm_hiss), compound application with independently re-sampled parameters,
level_match_db fixed gain applied to originals and copies, per-class
augmentation overrides, manifest-filtered train-only input, preserve_length
trim/pad, class-per-subfolder WAV output consumed by the audio_folder
loader.

Two backends: ``host`` (the default) is numpy over the float64 oracle
``ops/golden/effects.py`` in a process pool, and needs no card; ``device``
batches the vocoder stages (time_stretch, pitch_shift) on the card through
``ops/effects_device.py``, with the host backend's parameter streams.

CLI: python -m audio_edge_ml_pipeline_torch.features.augment --config augmentation.yaml [--device cpu]
(``--device`` places the device backend: the first CUDA card by default,
raising without one; ``cpu`` runs it on the CPU.)
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import yaml

from ..data.audio_io import load_audio, write_wav
from ..ops.golden import effects
from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Augmentors: each is a draw(rng, cur_len, **params) + apply(y, sr, drawn)
# pair, composed into the public (y, sr, rng, **params) callable. The split
# single-sources the arithmetic for BOTH backends: the host path draws and
# applies per copy, the device path pre-draws every copy's parameters in
# the identical rng order (_predraw_params) and batch-applies stage-major,
# so the two backends share bit-identical parameter streams by
# construction, not by parallel maintenance.
# ---------------------------------------------------------------------------


def _draw_volume_scale(rng, cur_len, min_gain=0.7, max_gain=1.3):
    return rng.uniform(min_gain, max_gain)


def _apply_volume_scale(y, sr, g):
    return (y * g).astype(y.dtype)


def volume_scale(y, sr, rng, min_gain: float = 0.7, max_gain: float = 1.3):
    return _apply_volume_scale(y, sr, _draw_volume_scale(rng, len(y), min_gain, max_gain))


def _draw_gaussian_noise(rng, cur_len, min_amplitude=0.001, max_amplitude=0.008):
    return rng.uniform(min_amplitude, max_amplitude), rng.standard_normal(cur_len)


def _apply_gaussian_noise(y, sr, drawn):
    amplitude, white = drawn
    noise = white.astype(y.dtype) * amplitude
    return np.clip(y + noise, -1.0, 1.0).astype(y.dtype)


def gaussian_noise(y, sr, rng, min_amplitude: float = 0.001, max_amplitude: float = 0.008):
    return _apply_gaussian_noise(y, sr, _draw_gaussian_noise(rng, len(y), min_amplitude, max_amplitude))


def _draw_time_stretch(rng, cur_len, min_rate=0.85, max_rate=1.15):
    return rng.uniform(min_rate, max_rate)


def time_stretch(y, sr, rng, min_rate: float = 0.85, max_rate: float = 1.15):
    rate = _draw_time_stretch(rng, len(y), min_rate, max_rate)
    return effects.time_stretch(np.asarray(y, np.float64), rate).astype(np.float32)


def _draw_pitch_shift(rng, cur_len, min_steps=-3.0, max_steps=3.0):
    return rng.uniform(min_steps, max_steps)


def pitch_shift(y, sr, rng, min_steps: float = -3.0, max_steps: float = 3.0):
    n_steps = _draw_pitch_shift(rng, len(y), min_steps, max_steps)
    return effects.pitch_shift(np.asarray(y, np.float64), sr, n_steps).astype(np.float32)


def _draw_time_shift(rng, cur_len, max_fraction=0.2):
    return rng.uniform(-max_fraction, max_fraction)


def _apply_time_shift(y, sr, frac):
    return np.roll(y, int(frac * len(y))).astype(y.dtype)


def time_shift(y, sr, rng, max_fraction: float = 0.2):
    return _apply_time_shift(y, sr, _draw_time_shift(rng, len(y), max_fraction))


def _draw_polarity_inversion(rng, cur_len):
    return None


def _apply_polarity_inversion(y, sr, _):
    return (-y).astype(y.dtype)


def polarity_inversion(y, sr, rng):
    return _apply_polarity_inversion(y, sr, None)


def _draw_pdm_hiss(rng, cur_len, min_amplitude=0.02, max_amplitude=0.08, notch_freq=4000.0):
    white = rng.standard_normal(cur_len)  # white is drawn BEFORE amplitude
    return white, rng.uniform(min_amplitude, max_amplitude), notch_freq


def _apply_pdm_hiss(y, sr, drawn):
    white, amplitude, notch_freq = drawn
    n = len(y)
    fft = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(n, d=1.0 / sr)
    freqs[0] = 1.0
    fft /= np.sqrt(freqs)
    fft[np.abs(np.fft.rfftfreq(n, d=1.0 / sr) - notch_freq) < (sr / n * 2)] = 0.0
    pink = np.fft.irfft(fft, n=n).astype(np.float32)
    pink /= np.sqrt(np.mean(pink**2)) + 1e-9
    return np.clip(y + pink * amplitude, -1.0, 1.0).astype(y.dtype)


def pdm_hiss(y, sr, rng, min_amplitude: float = 0.02, max_amplitude: float = 0.08, notch_freq: float = 4000.0):
    """Pink-tinted noise floor with a hardware-style notch at notch_freq —
    simulates the device PDM microphone (reference augment.py:135-168)."""
    return _apply_pdm_hiss(y, sr, _draw_pdm_hiss(rng, len(y), min_amplitude, max_amplitude, notch_freq))


AUGMENTORS = {
    "volume_scale": volume_scale,
    "gaussian_noise": gaussian_noise,
    "time_stretch": time_stretch,
    "pitch_shift": pitch_shift,
    "time_shift": time_shift,
    "polarity_inversion": polarity_inversion,
    "pdm_hiss": pdm_hiss,
}

# draw/apply halves by name, for the device backend's pre-draw + stage apply
_DRAWERS = {
    "volume_scale": _draw_volume_scale,
    "gaussian_noise": _draw_gaussian_noise,
    "time_stretch": _draw_time_stretch,
    "pitch_shift": _draw_pitch_shift,
    "time_shift": _draw_time_shift,
    "polarity_inversion": _draw_polarity_inversion,
    "pdm_hiss": _draw_pdm_hiss,
}
_APPLIERS = {  # non-vocoder stages only; vocoder stages batch on device
    "volume_scale": _apply_volume_scale,
    "gaussian_noise": _apply_gaussian_noise,
    "time_shift": _apply_time_shift,
    "polarity_inversion": _apply_polarity_inversion,
    "pdm_hiss": _apply_pdm_hiss,
}


def validate_aug_specs(aug_specs: list[dict], where: str = "augmentations") -> None:
    """Fail fast on unknown types OR unknown parameters: a bad kwarg would
    otherwise TypeError per-file mid-run after hours of valid output."""
    import inspect

    for spec in aug_specs:
        if not isinstance(spec, dict):
            raise ValueError(
                f"{where}: each augmentation must be a mapping with a 'type' key, "
                f"got {spec!r} (write '- type: {spec}' instead of '- {spec}')"
            )
        aug_type = spec.get("type")
        if aug_type not in AUGMENTORS:
            raise ValueError(f"Unknown augmentation type {aug_type!r} in {where}. Valid: {sorted(AUGMENTORS)}")
        valid = set(inspect.signature(AUGMENTORS[aug_type]).parameters) - {"y", "sr", "rng"}
        extra = set(spec) - {"type"} - valid
        if extra:
            raise ValueError(
                f"{where}: {aug_type} got unknown parameter(s) {sorted(extra)}; valid: {sorted(valid)}"
            )


def apply_augmentations(y: np.ndarray, sr: int, aug_specs: list[dict], rng: np.random.Generator) -> np.ndarray:
    out = y.copy()
    for spec in aug_specs:
        aug_type = spec["type"]
        if aug_type not in AUGMENTORS:
            raise ValueError(f"Unknown augmentation type {aug_type!r}. Valid: {sorted(AUGMENTORS)}")
        params = {k: v for k, v in spec.items() if k != "type"}
        out = AUGMENTORS[aug_type](out, sr, rng, **params)
    return out


def preserve_length(y_aug: np.ndarray, original_length: int) -> np.ndarray:
    if len(y_aug) > original_length:
        return y_aug[:original_length]
    if len(y_aug) < original_length:
        return np.pad(y_aug, (0, original_length - len(y_aug)))
    return y_aug


# ---------------------------------------------------------------------------
# Config + dataset iteration
# ---------------------------------------------------------------------------


def load_config(path: Path) -> dict:
    cfg = yaml.safe_load(Path(path).read_text()) or {}
    if "output_dir" not in cfg:
        raise ValueError("augmentation.yaml must include 'output_dir'.")
    cfg.setdefault("n_augments", 4)
    cfg.setdefault("preserve_length", True)
    cfg.setdefault("seed", 42)
    cfg.setdefault("sample_rate", None)
    # normalize None (an empty 'augmentations:'/'class_overrides:' yaml key
    # parses as null) so downstream .get()/iteration can't AttributeError
    cfg["augmentations"] = cfg.get("augmentations") or []
    cfg["class_overrides"] = cfg.get("class_overrides") or {}
    cfg.setdefault("loader", "audio_folder")
    cfg.setdefault("split", "train")
    cfg.setdefault("level_match_db", 0.0)
    cfg.setdefault("backend", "host")  # device = batch vocoder stages on the card
    cfg.setdefault("device_batch", 64)
    if cfg["backend"] not in ("host", "device"):
        raise ValueError(f"backend must be 'host' or 'device', got {cfg['backend']!r}")
    # parallelism can only come from real cores (the vocoder is GIL-bound
    # numpy: on a 1-core host a pool is pure overhead)
    import os

    cfg.setdefault("workers", min(8, os.cpu_count() or 1))
    validate_aug_specs(cfg["augmentations"])
    # per-class overrides get the same None normalization: `dog:` (null
    # override) and `dog: {augmentations: }` (null list, meaning "no augs
    # for dog") are both valid YAML that must not TypeError downstream
    normalized = {}
    for cls, override in cfg["class_overrides"].items():
        override = dict(override or {})
        if "augmentations" in override:
            override["augmentations"] = override.get("augmentations") or []
        validate_aug_specs(override.get("augmentations", []), where=f"class_overrides[{cls!r}]")
        normalized[cls] = override
    cfg["class_overrides"] = normalized
    return cfg


def _iter_samples(cfg: dict):
    loader_name = cfg["loader"]
    if loader_name == "fsc22":
        from ..data.loaders import FSC22Loader

        dataset_root = cfg.get("dataset")
        if not dataset_root:
            raise ValueError("augmentation.yaml must include 'dataset' when loader=fsc22.")
        loader = FSC22Loader(dataset_root, split=cfg.get("split", "train"), seed=cfg.get("seed", 42))
        for path, class_name, _ in loader:
            yield path, class_name
    elif loader_name == "audio_folder":
        raw_root = cfg.get("audio_folder") or cfg.get("dataset")
        if not raw_root:
            # (guarding the raw value: Path("") stringifies to "." — a
            # truthy CWD scan that silently augments 0 files)
            raise ValueError("augmentation.yaml must include 'audio_folder' when loader=audio_folder.")
        root = Path(raw_root)
        allowed = None
        if cfg.get("manifest"):
            manifest = json.loads(Path(cfg["manifest"]).read_text())
            allowed = set(manifest.get(cfg.get("split", "train"), []))
            logger.info("manifest filter %r: %d files allowed", cfg.get("split"), len(allowed))
        exts = {".wav", ".flac", ".mp3", ".ogg", ".aiff"}
        for class_dir in sorted(p for p in root.iterdir() if p.is_dir()):
            for f in sorted(class_dir.iterdir()):
                if f.suffix.lower() not in exts:
                    continue
                if allowed is not None and f"{class_dir.name}/{f.name}" not in allowed:
                    continue
                yield f, class_dir.name
    else:
        raise ValueError(f"Unknown loader {loader_name!r}. Valid: ['audio_folder', 'fsc22']")


def _decode_and_write_original(path, class_name, output_dir, target_sr, level_scale):
    """Decode one source file (skip-and-continue on failure, like the
    extraction path), level-match, and write the original copy. Shared by
    both backends so their output trees cannot drift. Returns
    (y, sr, class_dir) or None if skipped."""
    try:
        y, sr = load_audio(path, sr=target_sr)
    except Exception as exc:
        # e.g. a non-WAV file admitted by the extension list that the
        # decoder rejects
        logger.warning("Skipping %s: %s", path, exc)
        return None
    y = np.clip(y * level_scale, -1.0, 1.0)
    class_dir = output_dir / class_name
    class_dir.mkdir(parents=True, exist_ok=True)
    # outputs are WAV data regardless of the source container
    write_wav(class_dir / f"{path.stem}.wav", y, sr)
    return y, sr, class_dir


def _augment_file(task) -> int:
    """Process one source file: level-matched original + n augmented copies.
    Module-level (picklable) worker for the process pool; returns 1 if the
    file was processed, 0 if skipped."""
    (path, class_name, child_seed, output_dir, n_augments, preserve,
     target_sr, level_scale, aug_specs) = task
    decoded = _decode_and_write_original(path, class_name, output_dir, target_sr, level_scale)
    if decoded is None:
        return 0
    y, sr, class_dir = decoded
    rng = np.random.default_rng(child_seed)
    for i in range(1, n_augments + 1):
        y_aug = apply_augmentations(y, sr, aug_specs, rng)
        if preserve:
            y_aug = preserve_length(y_aug, len(y))
        write_wav(class_dir / f"{path.stem}_aug{i:03d}.wav", np.clip(y_aug, -1, 1), sr)
    return 1


# ---------------------------------------------------------------------------
# Device backend: batch the vocoder stages on the accelerator
# ---------------------------------------------------------------------------


def _predraw_params(rng: np.random.Generator, aug_specs: list[dict], init_len: int) -> list[tuple]:
    """Mirror apply_augmentations' rng consumption EXACTLY (same draws, same
    order, including data-length-dependent noise vectors), returning
    (type, params) per spec. Both backends call the SAME _draw_* halves, so
    the parameter streams are bit-identical by construction — the only
    output difference is the vocoder's f32-vs-f64 numerics (~1e-3)."""
    drawn = []
    cur = init_len
    for spec in aug_specs:
        t = spec["type"]
        p = {k: v for k, v in spec.items() if k != "type"}
        params = _DRAWERS[t](rng, cur, **p)
        drawn.append((t, params))
        if t == "time_stretch":
            cur = int(round(cur / params))  # golden time_stretch length contract
    return drawn


_DEVICE_MIN_GROUP = 4  # smaller equal-(length, sr) groups use the oracle


def _vocoder_stage(copies: list[np.ndarray], t: str, params: list,
                   srs: list[int], device, counts: dict[str, int]) -> list[np.ndarray]:
    """Apply time_stretch / pitch_shift across copies as batches on
    ``device`` (ops/effects_device handles mixed lengths via 4096-sample
    padding buckets). pitch_shift's resample-back ratio depends on the
    clip's sr, so copies group by sr; groups under _DEVICE_MIN_GROUP use the
    float64 oracle (identical parameters either way). ``counts`` adds the
    copies of each route ("batched", "oracle")."""
    from ..ops import effects_device
    from ..ops.golden import effects as golden_effects

    by_sr: dict[int, list[int]] = {}
    for i in range(len(copies)):
        by_sr.setdefault(srs[i] if t == "pitch_shift" else 0, []).append(i)
    out: list[np.ndarray | None] = [None] * len(copies)
    for sr_key, idxs in by_sr.items():
        route = "batched" if len(idxs) >= _DEVICE_MIN_GROUP else "oracle"
        counts[route] = counts.get(route, 0) + len(idxs)
        if route == "batched":
            ys = [np.asarray(copies[i], np.float32) for i in idxs]
            vals = np.asarray([params[i] for i in idxs], np.float64)
            if t == "time_stretch":
                outs = effects_device.time_stretch_batch(ys, vals, device=device)
            else:
                outs = effects_device.pitch_shift_batch(ys, sr_key, vals, device=device)
            for i, o in zip(idxs, outs):
                out[i] = np.asarray(o, np.float32)
        else:
            for i in idxs:
                if t == "time_stretch":
                    out[i] = golden_effects.time_stretch(
                        np.asarray(copies[i], np.float64), float(params[i])
                    ).astype(np.float32)
                else:
                    out[i] = golden_effects.pitch_shift(
                        np.asarray(copies[i], np.float64), srs[i], float(params[i])
                    ).astype(np.float32)
    return out


def _flush_device_batch(buf: list[dict], aug_specs: list[dict], preserve: bool, device,
                        counts: dict[str, int]) -> None:
    """Apply the shared spec list stage-major across the buffered copies
    (vocoder stages device-batched), then trim/pad and write."""
    if not buf:
        return
    # Draws are deferred to flush time: buffering full-length float64 noise
    # vectors (gaussian_noise/pdm_hiss, ~640 KB/stage for a 5 s clip) across
    # device_batch x n_spec_keys pending copies was a multi-GB transient.
    # Each copy re-creates its rng from the state snapshot taken when it was
    # enqueued, so the parameter stream is still bit-identical to the host
    # backend's.
    for c in buf:
        r = np.random.default_rng()
        r.bit_generator.state = c["rng_state"]
        c["drawn"] = _predraw_params(r, aug_specs, c["orig_len"])
    copies = [c["y"] for c in buf]
    for k, spec in enumerate(aug_specs):
        t = spec["type"]
        if t in ("time_stretch", "pitch_shift"):
            copies = _vocoder_stage(copies, t, [c["drawn"][k][1] for c in buf],
                                    [c["sr"] for c in buf], device, counts)
        else:
            copies = [
                _APPLIERS[t](y, c["sr"], c["drawn"][k][1]) for y, c in zip(copies, buf)
            ]
    for y_aug, c in zip(copies, buf):
        if preserve:
            y_aug = preserve_length(y_aug, c["orig_len"])
        write_wav(c["out_path"], np.clip(y_aug, -1, 1), c["sr"])
    buf.clear()


def _run_device_tasks(tasks: list, n_augments: int, preserve: bool, device_batch: int,
                      device) -> tuple[int, dict[str, int]]:
    """Serial decode/write with device-batched augmentation copies. Copies
    buffer per spec-list until `device_batch` accumulate, then flush as one
    stage-major batch. Returns (files done, vocoder copies by route)."""
    counts = {"batched": 0, "oracle": 0}
    buffers: dict[str, list[dict]] = {}
    specs_of: dict[str, list[dict]] = {}
    done = 0
    for task in tasks:
        (path, class_name, child_seed, output_dir, _n, _p, target_sr,
         level_scale, aug_specs) = task
        decoded = _decode_and_write_original(path, class_name, output_dir, target_sr, level_scale)
        if decoded is None:
            continue
        y, sr, class_dir = decoded
        rng = np.random.default_rng(child_seed)
        key = json.dumps(aug_specs, sort_keys=True)
        specs_of[key] = aug_specs
        buf = buffers.setdefault(key, [])
        for i in range(1, n_augments + 1):
            # snapshot the rng BEFORE this copy's draws, then advance it by
            # actually drawing (PCG64.advance can't be used: the ziggurat
            # gaussian consumes a data-dependent number of raw outputs); the
            # throwaway draw is ~0.5 ms/copy, the flush re-draw is the real
            # one. y is shared, not copied: no applier mutates its input.
            state = rng.bit_generator.state
            _predraw_params(rng, aug_specs, len(y))
            buf.append({
                "y": y, "sr": sr, "orig_len": len(y), "rng_state": state,
                "out_path": class_dir / f"{path.stem}_aug{i:03d}.wav",
            })
        if len(buf) >= device_batch:
            _flush_device_batch(buf, aug_specs, preserve, device, counts)
        done += 1
    for key, buf in buffers.items():
        _flush_device_batch(buf, specs_of[key], preserve, device, counts)
    return done, counts


def run(cfg: dict, device=None) -> None:
    """Augment the files ``cfg`` names. ``device`` places the device
    backend's vocoder (None: the first CUDA card, raising without one);
    the host backend ignores it."""
    output_dir = Path(cfg["output_dir"])
    n_augments = int(cfg["n_augments"])
    preserve = bool(cfg["preserve_length"])
    target_sr = cfg["sample_rate"]
    default_augs = cfg["augmentations"]
    class_overrides = cfg["class_overrides"]
    level_scale = 10.0 ** (float(cfg["level_match_db"]) / 20.0)

    # re-validate here (not only in load_config): programmatic cfgs may skip
    # load_config, and an unknown type must fail BEFORE any output is
    # written — the device backend would otherwise KeyError mid-run after
    # originals were already on disk
    validate_aug_specs(default_augs)
    for cls, override in class_overrides.items():
        specs = (override or {}).get("augmentations") or []
        validate_aug_specs(specs, where=f"class_overrides[{cls!r}]")
    if cfg.get("backend", "host") == "device":
        # no card and no --device cpu: fail before any output is written
        from ..utils.device import resolve_device

        device = resolve_device(device)

    output_dir.mkdir(parents=True, exist_ok=True)
    samples = list(_iter_samples(cfg))
    if not samples:
        logger.warning(
            "No input files found (loader=%r, root=%r, split=%r) — check the "
            "path and any manifest filter.",
            cfg["loader"], cfg.get("audio_folder") or cfg.get("dataset"), cfg.get("split"),
        )
    logger.info("Augmenting %d files x %d copies -> %s", len(samples), n_augments, output_dir)

    # Files are independent, so the stage parallelizes over a PROCESS pool
    # on multi-core hosts (the phase vocoder is GIL-bound small-array
    # numpy, so threads gain nothing; the reference's librosa loop is
    # serial). The default worker count is capped at os.cpu_count(), which
    # degrades to the serial path on a 1-core host. Reproducibility: every
    # file gets its own child seed spawned SEQUENTIALLY from the config
    # seed, so the output is a pure function of (config, file list)
    # regardless of worker count or completion order.
    # Distinct source files mapping to one output path (same stem in one
    # class, e.g. '0.wav' + '0.WAV') were a silent serial overwrite and
    # would be a scheduling-dependent write race under the pool — reject
    # them so the byte-identical-at-any-worker-count contract holds.
    by_out: dict[tuple, Path] = {}
    for path, class_name in samples:
        key = (class_name, path.stem)
        prev = by_out.setdefault(key, path)
        if prev != path:
            raise ValueError(
                f"two inputs write the same output {class_name}/{path.stem}.wav: "
                f"{prev} and {path}; rename one"
            )

    child_seeds = np.random.SeedSequence(int(cfg["seed"])).spawn(len(samples))
    tasks = [
        (
            path, class_name, child, output_dir, n_augments, preserve, target_sr,
            level_scale,
            # tolerate programmatic cfgs that skipped load_config's None
            # normalization: a null override or null augmentations list
            # means "no augs for this class", never a crash
            ((class_overrides.get(class_name) or {}).get("augmentations", default_augs)) or [],
        )
        for (path, class_name), child in zip(samples, child_seeds)
    ]

    if cfg.get("backend", "host") == "device":
        # Accelerator path: the vocoder stages (the only expensive math —
        # 45-80 ms/clip on one host core in the JAX package) run as batched
        # passes on the card (ops/effects_device); parameter streams are
        # bit-identical to the host backend (see _predraw_params), so outputs
        # match the host path exactly for non-vocoder stages and to ~1e-3
        # where the f32 vocoder replaced the float64 oracle.
        n_orig, counts = _run_device_tasks(tasks, n_augments, preserve,
                                           int(cfg.get("device_batch") or 64), device)
        logger.info(
            "Done (device backend on %s): %d originals + %d augmented = %d files; "
            "vocoder copies: %d batched, %d on the oracle.",
            device, n_orig, n_orig * n_augments, n_orig * (1 + n_augments),
            counts["batched"], counts["oracle"],
        )
        return

    import os

    # same cpu_count-capped default as load_config, so a programmatic cfg
    # that skips load_config cannot oversubscribe a small host
    workers = min(int(cfg.get("workers") or min(8, os.cpu_count() or 1)),
                  max(len(tasks), 1))
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        import torch

        # forked, as in the JAX package, unless this process has started
        # CUDA, which a forked child inherits broken: then spawned (each
        # worker then pays its own interpreter and imports)
        context = multiprocessing.get_context("spawn" if torch.cuda.is_initialized() else "fork")
        with ProcessPoolExecutor(max_workers=workers, mp_context=context) as pool:
            n_orig = sum(pool.map(_augment_file, tasks, chunksize=4))
    else:
        n_orig = sum(map(_augment_file, tasks))
    logger.info(
        "Done: %d originals + %d augmented = %d files.",
        n_orig, n_orig * n_augments, n_orig * (1 + n_augments),
    )


def main(argv=None) -> None:
    setup_logging()
    parser = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.features.augment",
        description="Stage 1b — audio augmentation",
    )
    parser.add_argument("--config", required=True, metavar="YAML")
    parser.add_argument("--device", default=None,
                        help="torch device of the device backend (default: the first CUDA card; 'cpu' runs it "
                             "on the CPU); the host backend ignores it")
    args = parser.parse_args(argv)
    run(load_config(Path(args.config)), device=args.device)


if __name__ == "__main__":
    main()
