#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (audio_edge_ml_pipeline_torch).

Drives the port's main path on one CUDA card, through the entry points a
user calls, and checks each phase; any failed check ends the run with a
non-zero exit code. Builds the hand-written kernels from csrc/ itself.

  1. the card's name and power limit (nvidia-smi);
  2. build every kernel (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version on the card, through
     both entries, ``mel_power_folded`` and ``mel_power_unfolded``, with the
     launches of each route and template instantiation counted: the FFT mel
     kernel at n_fft 512 (two shapes), 1024 / 512 / 128 mels at 22.05 kHz
     and n_fft 320, 400 and 640 (folded) or 400 (unfolded), and no dense
     launch; its four-pass plans (n_fft 480 and 2048) through both entries
     and in float64; each entry's dense kernel on its route (n_fft 482),
     one launch each; the float64 instantiations (``precise=True``) of
     ``mel_rfft`` at n_fft 1024, 512, 400, 480 and 2048 (also at hop 1024,
     where its tiles shrink) and of the dense folded kernel at 482 and 2050,
     also per bin; a sweep of even n_fft from 4 to 4096 in both precisions,
     none of which may raise; the unfolded entry's refusal of odd n_fft; and
     the mel feature against the float64 golden copy;
  3c. the MFCC and classical features on the card (``mfcc_seq_feature``,
     raw ``mfcc``, ``classical_feature_vector``, ``waveform_feature``) on 4
     five-second clips at 22.05 kHz against the float64 golden copy, with
     both TF32 flags on (the DSP must pin its own precision), at n_fft 1024
     and, for the MFCC sequence and the classical vector, at 2048 (the FFT
     route) and 2050 (the dense float64 route); each MFCC call must launch
     the mel kernel of its route once, in float64; and ``mel_spec_feature``
     at n_fft 511 (no fold, no kernel) and 2048 against golden;
  4. the feature-extraction CLI on a 27-class x 5-clip fsc22-style WAV tree
     (5 s, 16 kHz), which must launch the FFT mel kernel and not the dense
     one, and the FFT kernel's mel power on the tree's clips against the
     float64 golden mel power; then the unfolded kernel's entry point
     (``mel_power_unfolded``, which no CLI calls, as no JAX path calls
     ``mel_power_pallas``) on the same clips, which must launch the FFT
     kernel and not its dense one, against the same, and at n_fft 482 its
     dense kernel;
  4c. the shipped ``configs/feature_extraction.yaml`` through the extraction
     CLI on the same tree (its own splits, train and validation; its
     dataset and outputs moved to the temporary directory): all four
     experiments, each FeatureSet's shape and labels, 3 rows of each
     against golden (the 22.05 kHz features on the clips as ``load_audio``
     resamples them), and each experiment's kernel launches;
  4d. the sizes this slice repaired, through the extraction CLI on the same
     tree (a copy of the shipped config's mel and MFCC-sequence experiments
     at n_fft 480, 2048 and 482 / 2050): each experiment must launch the
     template instantiation of its route, and 3 rows against golden;
  5. serving: the flagship CNN [16, 64, 64] (strides 4, 2; 27 classes) from
     a seeded generator, saved as a flax-layout bundle, loaded back, and
     8 edge-simulator requests; logits on the card against the CPU;
  5b. training: the train CLI on the card on phase 4's FeatureSet (the
     flagship CNN at full width, 3 epochs, stratified split), its bundle
     served by the edge simulator, and one training step on the card
     against the same step on the CPU at dropout 0, both from phase 5's
     seeded bundle;
  5c. all five runs of ``configs/training.yaml`` (cnn, mlp, rnn, svm, knn)
     through the train CLI on the card, on phase 4c's FeatureSets, at the
     file's params with the deep runs' epochs cut to 3: the shortlist holds
     the five runs, each bundle is served on the card against the CPU (the
     classical ones through their trainers' ``load``: equal predictions, svm
     decision values within 1e-5 of their largest, equal kNN counts), the
     svm run's CV folds are read back from the tracking store (the 4 train
     rows a class lower the file's 5), and one train step of the mlp and of
     the rnn on the card against the CPU from seeded bundles;
  5d. the classical core (``models/classical_core.py``, kNN and k-means) on
     the card against the CPU at fsc22 scale (27 classes x 75 clips of 302
     seeded dims, the shipped 70 % train split, then the CLI's 20 %
     validation: 1133 fit rows, 284 query rows), with both TF32 flags on:
     svm (C 10, gamma scale, 800 iterations) alpha, b and decision values,
     Platt A and B, LDA coefficients, the PCA (50 components) projector,
     kNN counts (k 5), k-means (k 27, 10 restarts) centres and inertia;
  5e. the tuning stage: fsc22-sized FeatureSets (27 classes x 75 synthetic
     5 s clips made on the card, their mel features extracted there by
     ``mel_spec_feature``, the shipped 70 % train and 15 % validation
     splits; 5d's seeded 302-d vectors, 70 % train) through the tune CLI on
     the card: ``configs/tuning.yaml`` with its cnn study cut to 6 trials of
     3 epochs (its pca_svm grid whole: 8 cells, cv 5, 400 CV iterations,
     the 800-iteration refit), and a batched study (8 trials in rounds of
     tune_parallel 4, the cnn fixed at its published widths). Checks: both
     runs in the shortlist, no failed trial (completed + pruned = trials),
     no failure logged but the pca_svm run's test-set evaluation (its
     ``features_test: null`` inherits the mel set), the bundles served; one
     pca_svm cell's fold-batched decision values card (TF32 on) vs CPU
     within 1e-4 of their largest; one cnn trial group's first epoch (4
     trials, dropout 0, float64) card vs CPU, losses 1e-5 and parameters
     1e-4 relative;
  5f. the post-training stages on 5c's five trained runs, through the
     port's CLIs on the card: the select CLI (pre-opt) on 5c's experiment
     writes the five-candidate shortlist; the optimize CLI over it (the
     cnn evaluated on its run's mel validation set, the others on their
     calibration FeatureSet, as the shortlist's features_eval_dir says)
     writes five reports with the JAX package's schema keys, every deep
     one with all five modes and every classical one with dynamic_int8 and
     float16, each accuracy drop within 0.05; each deep int8 artifact's
     tensors and scales equal a plain numpy per-tensor rounding of the fp32
     bundle and each bfloat16 artifact's bits a plain round-to-nearest-even,
     bit for bit; each report's fp32 accuracy equals the card's predict on
     the same rows; select --post-opt writes best_model.json and
     --max-size-kb 0.001 writes none; the deploy CLI generates the cnn's
     project from its report (the chosen mode) and from its fp32,
     dynamic_int8 and static_int8 artifacts, each compiled with gcc -O2
     -std=c99: the host harness's scores on 2 validation features within
     1e-4 of the evaluated view's predict_proba on the card (same argmax),
     and its C mel on a tree clip within 5e-5 of the card's
     mel_spec_feature (one mel_rfft<256, float> launch a project) and of
     the float64 oracle;
  6. timing with CUDA events at B=512 five-second clips (at n_fft 512 each
     entry's FFT route beside its dense kernel, in turns, and the plain
     versions; at n_fft 400 the FFT kernel beside both dense kernels, in
     turns; each kernel's share of the bound, which is worked out from this
     run's shapes; the stages and waveform -> mel -> CNN), one training
     step at B=32 and B=512, and at B=512 five-second clips at 22.05 kHz the
     FFT kernel at the MFCC front end (1024 / 512 / 128 mels) against its
     bound and its plain version, ``mfcc_seq_feature`` and
     ``classical_feature_vector`` with its MFCC block, magnitude STFT and
     spectral groups alone; the four-pass plans in both types (n_fft 480 at
     16 kHz, 2048 at 22.05 kHz) and the dense kernels at n_fft 482 and 2050
     beside their bounds and plain versions; an mlp and an rnn train step at
     B=32 and B=512; at 5d's fsc22 scale an svm fit eager and captured in a
     CUDA graph (which must give what eager gives, bit for bit), the
     kernels an APG step launches, svm predict and predict_proba on the 284
     rows, a kNN predict, an LDA fit, a pca_svm fit and a k-means fit; at
     5e's sizes one svm CV cell fold-batched and fold by fold, each pca_cv,
     the grid's total in the CLI, and a group of 4 cnn trials for one epoch
     against the 4 trials one at a time; from 5f, each optimize mode's
     latency_ms on the card (the CLI's timed call and a second full call),
     the optimize CLI's wall time a candidate, and codegen and gcc a
     project;
  7. one JSON line per kernel, then the result line.

Matmuls and cuDNN convolutions run in full float32 throughout (TF32 off),
but for phases 3c and 5d, which turn TF32 on: the features must stay within
1e-5 of the float64 oracle, and the classical core must pin full float32
itself.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SR, N_MELS, N_FFT, HOP = 16000, 40, 512, 160
CLIP = 5 * SR                      # fsc22 clips: 5 s at 16 kHz
SR22, MFCC_N_FFT, MFCC_HOP, MFCC_MELS = 22050, 1024, 512, 128   # the MFCC and classical extractors' defaults
CLIP22 = 5 * SR22
N_CLASSES, PER_CLASS = 27, 5        # 5 a class: 27 val rows, so the train CLI's split stratifies
F32_PEAK = 67e12                   # H100 SXM float32 FLOP/s outside the tensor cores, 700 W
F64_PEAK = 67e12                   # H100 SXM float64 FLOP/s, its peak on the tensor cores (NVIDIA's data sheet), 700 W
F64_ELEMENT_TOL = 1e-6             # float64 kernel vs plain mel power, relative to each bin: a float32 kernel misses it
HBM_RATE = 3.35e12                 # H100 SXM bytes/s
KERNEL_REL_TOL = 1e-6              # kernel vs plain mel power, relative to each clip's peak power
FEATURE_TOL = 1e-5                 # the repo's DSP parity gate (max|delta| vs float64)
LOGIT_TOL = 1e-4                   # CNN logits card vs CPU, float32 convolutions in other orders
GOLDEN_REL_TOL = 1e-5              # unfolded mel power vs float64 golden, relative to each clip's peak
STEP_LOSS_TOL = 1e-5               # train-step loss card vs CPU, relative
RAW_MFCC_TOL = 1e-3                # raw MFCC (dB scale) vs float64, max|delta| (tests/test_dsp_parity.py)
CLASSICAL_REL_TOL = 1e-4           # classical vector vs float64, per dimension over max(|golden|, 1)
WAVEFORM_TOL = 1e-6                # peak-normalized waveform vs float64
GRAD_TOL = 1e-4                    # train-step gradients card vs CPU, max|d| over each tensor's max|g|:
                                   # float32 reductions over 32 x 40 x 501 inputs in other orders, and
                                   # cuDNN's backward may sum in a run-dependent order
TRAIN_EPOCHS = 3
DENSE_N_FFT = 482                  # M = 241 has no FFT plan: the dense kernels' route at 16 kHz
DENSE_N_FFT_22 = 2050              # M = 1025 = 5^2 x 41: the dense route at the 22.05 kHz front end
NEW_PLANS = (480, 2048)            # the four-pass plans: M = 240 = 4 4 3 5, M = 1024 = 8 8 4 4
SWEEP_N_FFT = (4, 6, 130, 256, 482, 1026, 1678, 2050, 3000, 4096)  # even n_fft tried in both precisions
FSC22_CLIPS, CLASSICAL_DIM = 75, 302   # fsc22: 75 clips a class; the classical vector's width
SVM_C, SVM_ITERS, KNN_K, PCA_COMPONENTS = 10.0, 800, 5, 50   # configs/training.yaml's svm and knn, the pca_svm default
SVM_TOL = 1e-4                     # card vs CPU: alpha over max(u), b and decision values over their largest
                                   # (float32 sums in other orders, carried through 800 projected-gradient steps)
PLATT_TOL = 1e-3                   # Platt A and B card vs CPU, relative (a Newton fit on those decisions)
LDA_TOL = 1e-4                     # LDA coefficients card vs CPU, relative to the largest
PCA_TOL = 1e-4                     # PCA projector (components times their transpose) card vs CPU, relative
KMEANS_TOL, INERTIA_TOL = 1e-4, 1e-5   # k-means centres over their largest, inertia relative
DECISION_TOL = 1e-5                # a served classical bundle's decision values card vs CPU, over their largest
TUNE_TRIALS, TUNE_EPOCHS = 6, 3    # configs/tuning.yaml's cnn study cut from 30 trials of 40 epochs
BATCHED_TRIALS, BATCHED_K = 8, 4   # the batched study: 8 trials in rounds of tune_parallel 4
CV_TOL = 1e-4                      # a pca_svm cell's fold-batched decision values card vs CPU, over their largest
GROUP_LOSS_TOL, GROUP_PARAM_TOL = 1e-5, 1e-4   # a cnn trial group's first epoch card vs CPU, relative
C_SCORE_TOL = 1e-4                 # generated C scores vs predict_proba (tests/test_codegen_ext.py)
C_MEL_TOL = 5e-5                   # the generated C mel frontend, float32, vs the float64 oracle (tests/test_codegen.py)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def synth_clips(rng: np.random.Generator, batch: int, n: int = CLIP, sr: int = SR) -> np.ndarray:
    """fsc22-like clips: a harmonic stack, noise floor, transient bursts."""
    t = np.arange(n) / sr
    out = np.empty((batch, n), np.float32)
    for i in range(batch):
        f0 = rng.uniform(90.0, 3000.0)
        y = sum((0.5 / h) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)) for h in range(1, 4))
        y = y * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 3.0) * t) ** 2)
        y = y + rng.uniform(0.01, 0.1) * rng.standard_normal(n)
        for _ in range(3):
            s = int(rng.integers(0, n - sr // 10))
            y[s : s + sr // 10] += 0.6 * rng.standard_normal(sr // 10)
        out[i] = 0.8 * y / np.abs(y).max()
    return out


def class_clips_on_card(gen, dev, c: int, n: int):
    """n five-second 16 kHz clips of class c on the card, from the torch
    generator ``gen``: three harmonics of a class pitch (110 Hz up a
    semitone a class, +-3 % a clip), slow amplitude modulation, noise."""
    import torch

    t = torch.arange(CLIP, device=dev, dtype=torch.float32) / SR
    f0 = 110.0 * 2.0 ** (c / 12) * (1 + 0.06 * (torch.rand(n, 1, device=dev, generator=gen) - 0.5))
    y = sum((0.5 / h) * torch.sin(2 * np.pi * h * f0 * t + 2 * np.pi * torch.rand(n, 1, device=dev, generator=gen))
            for h in range(1, 4))
    y = y * (0.5 + 0.5 * torch.sin(2 * np.pi * (0.3 + 2.7 * torch.rand(n, 1, device=dev, generator=gen)) * t) ** 2)
    y = y + 0.05 * torch.randn(n, CLIP, device=dev, generator=gen)
    return 0.8 * y / y.abs().amax(1, keepdim=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log: str) -> list[str]:
    """'<kernel><template args>: <spill stores>, <registers>' for each kernel in nvcc's -Xptxas -v output."""
    kernels: list[list[str]] = []
    for ln in log.splitlines():
        name = re.search(r"Compiling entry function '\w*?\d+(mel_\w+?_kernel)(?:I((?:Li\d+E|[fd])+)E)?", ln)
        if name:
            args = [n or {"f": "float", "d": "double"}[t] for n, t in re.findall(r"Li(\d+)E|([fd])", name.group(2) or "")]
            kernels.append([name.group(1) + (f"<{', '.join(args)}>" if args else "")])
        elif kernels and (m := re.search(r"Used (\d+ registers)|(\d+ bytes spill stores)", ln)):
            kernels[-1].append(m.group(1) or m.group(2))
    return [f"{k[0]}: {', '.join(k[1:])}" for k in kernels]


def mel_folded_bound(batch: int, n: int, n_fft: int, mel_nonzeros: int, hop: int = HOP, n_mels: int = N_MELS,
                     peak: float = F32_PEAK) -> tuple[float, str, float, float, float]:
    """Least time of the mel-power function on this card, in ms, and what
    bounds it: the larger of its bytes (each clip read once, the mel power
    written once) over HBM_RATE and its operations at their least over
    ``peak``, the rate of their type (F32_PEAK, or F64_PEAK for the float64
    instantiation). Per frame those are the Hann window (n_fft multiplies), a
    real FFT at the nominal 2.5 n_fft log2(n_fft) FLOP, the power (3 per
    bin) and the mel product over the bank's nonzeros only (2 per nonzero).

    Also returns the ms at ``peak`` of those least operations alone (the
    FFT kernel's formulation) and at F32_PEAK of each dense kernel's own formulation:
    the folded dense DFT (per frame 2 adds per fold pair, two (n_fft/2 x
    n_freq) multiply-add products, the center term, the power and the same
    band-only mel product) and the unfolded dense DFT (two (n_fft x n_freq)
    multiply-add products, the power and the mel product)."""
    half, n_freq = n_fft // 2, 1 + n_fft // 2
    frames = batch * (1 + n // hop)
    fft_flops = frames * (n_fft + 2.5 * n_fft * np.log2(n_fft) + 3 * n_freq + 2 * mel_nonzeros)
    folded_flops = frames * (2 * half + 4 * half * n_freq + 2 * n_freq + 3 * n_freq + 2 * mel_nonzeros)
    unfolded_flops = frames * (4 * n_fft * n_freq + 3 * n_freq + 2 * mel_nonzeros)
    nbytes = 4 * (batch * n + frames * n_mels)
    t_ops, t_bytes = fft_flops / peak, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", 1e3 * t_ops,
            1e3 * folded_flops / F32_PEAK, 1e3 * unfolded_flops / F32_PEAK)


def write_wav_tree(root: Path, rng: np.random.Generator) -> tuple[Path, Path, list[str]]:
    """fsc22 layout (flat dir + metadata CSV) and a class-per-subfolder tree."""
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav

    audio_dir = root / "fsc22" / "Audio Wise V1.0-20260101" / "Audio Wise V1.0"
    meta_dir = root / "fsc22" / "Metadata-20260101" / "Metadata"
    folder = root / "audio_folder"
    audio_dir.mkdir(parents=True)
    meta_dir.mkdir(parents=True)
    names = [f"class{c:02d}" for c in range(N_CLASSES)]
    rows = ["Source File Name,Dataset File Name,Class ID,Class Name"]
    for c, name in enumerate(names):
        clips = synth_clips(rng, PER_CLASS)
        (folder / name).mkdir(parents=True)
        for i, y in enumerate(clips):
            fname = f"{c + 1}_{i + 1}.wav"
            write_wav(audio_dir / fname, y, SR)
            rows.append(f"src_{fname},{fname},{c + 1},{name}")
            if i == 0:
                write_wav(folder / name / fname, y, SR)
    (meta_dir / "Metadata V1.0 FSC22.csv").write_text("\n".join(rows) + "\n")
    return root / "fsc22", folder, names


def shipped_config_copy(dataset: Path, out_root: Path) -> tuple[Path, list[dict]]:
    """configs/feature_extraction.yaml with its dataset and outputs moved
    under ``out_root``, written as JSON (a YAML document too); its
    experiments as the file lists them."""
    import yaml

    doc = yaml.safe_load((REPO / "configs" / "feature_extraction.yaml").read_text())
    doc["dataset"] = str(dataset)
    for exp in doc["experiments"]:
        exp["output"] = str(out_root / Path(exp["output"]).name)
    path = out_root / "feature_extraction.yaml"
    out_root.mkdir(parents=True)
    path.write_text(json.dumps(doc, indent=1))
    return path, doc["experiments"]


CNN_PARAMS = {"filters": [16, 64, 64], "first_stride": 4, "second_stride": 2}


def training_config_copy(features_root: Path, out_root: Path) -> tuple[Path, list[dict]]:
    """The five runs of configs/training.yaml (cnn, mlp, rnn, svm, knn) at the
    file's params with the deep runs' epochs cut to TRAIN_EPOCHS, their
    FeatureSets and output moved to ``features_root`` (phase 4c's outputs, by
    directory name) and ``out_root``; written as JSON, with its runs as
    written."""
    import yaml

    doc = yaml.safe_load((REPO / "configs" / "training.yaml").read_text())

    def moved(path):
        return None if path is None else str(features_root / Path(path).name)

    doc["features_dir"], doc["features_test_dir"] = moved(doc["features_dir"]), moved(doc["features_test_dir"])
    doc["output_dir"] = str(out_root / "models")
    check([r["model"] for r in doc["runs"]] == ["cnn", "mlp", "rnn", "svm", "knn"], "configs/training.yaml's runs")
    for run in doc["runs"]:
        run.setdefault("name", run["model"])
        if "epochs" in run["params"]:
            run["params"]["epochs"] = TRAIN_EPOCHS
        if "features_dir" in run:
            run["features_dir"] = moved(run["features_dir"])
    out_root.mkdir(parents=True)
    path = out_root / "training.yaml"
    path.write_text(json.dumps(doc, indent=1))
    return path, [{**r, "features_dir": r.get("features_dir") or doc["features_dir"]} for r in doc["runs"]]


def repaired_sizes_config(dataset: Path, out_root: Path) -> tuple[Path, list[dict]]:
    """The shipped config's mel and MFCC-sequence training experiments at the
    n_fft this slice repaired: the four-pass plans (480, 2048) and the dense
    route (DENSE_N_FFT for the mel, DENSE_N_FFT_22 for the MFCC sequence,
    which runs the dense kernel's float64 instantiation). Written as JSON
    under ``out_root``; its experiments as written."""
    import yaml

    shipped = {e["extractor"]: e for e in yaml.safe_load((REPO / "configs" / "feature_extraction.yaml").read_text())
               ["experiments"] if e["split"] == "train" and e["extractor"] != "audio_classical"}
    experiments = []
    for extractor, sizes in (("audio_mel_spec", (*NEW_PLANS, DENSE_N_FFT)),
                             ("audio_mfcc_seq", (*NEW_PLANS, DENSE_N_FFT_22))):
        for n_fft in sizes:
            name = f"{shipped[extractor]['name']}_nfft{n_fft}"
            experiments.append({**shipped[extractor], "name": name, "output": str(out_root / name),
                                "extractor_params": {**shipped[extractor].get("extractor_params", {}), "n_fft": n_fft}})
    out_root.mkdir(parents=True)
    path = out_root / "feature_extraction.yaml"
    path.write_text(json.dumps({"dataset": str(dataset), "loader": "fsc22", "experiments": experiments}, indent=1))
    return path, experiments


def fsc22_classical_train(rng: np.random.Generator):
    """Seeded classical vectors at fsc22 scale: 27 classes x 75 clips of 302
    dims (class means plus unit noise, each column on its own scale within
    half a decade, so that the LDA's within-class scatter keeps a condition
    number near 30 and its smallest eigenvalue far above the rank cutoff:
    a float32 solve near that cutoff differs from itself in float64 by more
    than the tolerance), the shipped 70 % train split: (X_train, y_train)."""
    from audio_edge_ml_pipeline_torch.train.train import stratified_train_val_split

    y = np.repeat(np.arange(N_CLASSES), FSC22_CLIPS).astype(np.int32)
    means = 0.5 * rng.standard_normal((N_CLASSES, CLASSICAL_DIM))
    X = ((means[y] + rng.standard_normal((len(y), CLASSICAL_DIM))) * 10.0 ** rng.uniform(-0.25, 0.25, CLASSICAL_DIM))
    X_train, _, y_train, _ = stratified_train_val_split(X.astype(np.float32), y, 0.3)
    return X_train, y_train


def fsc22_classical(rng: np.random.Generator):
    """``fsc22_classical_train``, then the train CLI's 20 % validation split
    of it: (X_fit, y_fit, X_val, y_val)."""
    from audio_edge_ml_pipeline_torch.train.train import stratified_train_val_split

    X_fit, X_val, y_fit, y_val = stratified_train_val_split(*fsc22_classical_train(rng), 0.2)
    return X_fit, y_fit, X_val, y_val


def tuning_config_copies(mel_train: Path, mel_val: Path, classical_train: Path, out_root: Path):
    """configs/tuning.yaml with its FeatureSets moved to phase 5e's and its
    cnn budget cut to TUNE_TRIALS trials of TUNE_EPOCHS epochs (every other
    knob as shipped: the median pruner, the search space, the pca_svm grid,
    cv 5), and a batched study beside it: the cnn search space with the
    architecture fixed at the published widths, BATCHED_TRIALS trials in
    rounds of tune_parallel BATCHED_K. Written as JSON under ``out_root``,
    their outputs to ``out_root``/tuned and /tuned_batched: (shipped path,
    batched path, the shipped document)."""
    import yaml

    doc = yaml.safe_load((REPO / "configs" / "tuning.yaml").read_text())
    check([r["model"] for r in doc["runs"]] == ["cnn", "pca_svm"], "configs/tuning.yaml's runs")
    doc.update(output_dir=str(out_root / "tuned"), features_dir=str(mel_train), features_test=str(mel_val),
               n_trials=TUNE_TRIALS, sweep_epochs=TUNE_EPOCHS)
    doc["runs"][1]["features_dir"] = str(classical_train)
    cnn_run = doc["runs"][0]
    batched = {**doc, "experiment": doc["experiment"] + "-batched", "output_dir": str(out_root / "tuned_batched"),
               "n_trials": BATCHED_TRIALS, "tune_parallel": BATCHED_K,
               "runs": [{**cnn_run, "search_space": {**cnn_run["search_space"], **{k: [v] for k, v in CNN_PARAMS.items()}}}]}
    out_root.mkdir(parents=True)
    paths = out_root / "tuning.yaml", out_root / "tuning_batched.yaml"
    for path, d in zip(paths, (doc, batched)):
        path.write_text(json.dumps(d, indent=1))
    return paths[0], paths[1], doc


def classical_core_run(dev, X, y, Xq) -> dict:
    """5d's fits of the classical core on ``dev``, as numpy: the svm solver's
    (alpha, b, f) and box bounds u, its state's Platt sigmoids and decision
    values on ``Xq``, LDA coefficients, the PCA projector, kNN counts of
    ``Xq`` and k-means centres and inertia."""
    from audio_edge_ml_pipeline_torch.models import classical as tcl
    from audio_edge_ml_pipeline_torch.models import classical_core as cc

    solved = {}
    solver = cc.svm_fit

    def seen(*args, **kwargs):
        out = solver(*args, **kwargs)
        solved.update(zip(("alpha", "b", "f"), (t.cpu().numpy() for t in out)), u=args[3].cpu().numpy())
        return out

    cc.svm_fit = seen
    try:
        state = cc.fit_svm_np(X, y, N_CLASSES, C=SVM_C, gamma="scale", iters=SVM_ITERS, device=dev)
    finally:
        cc.svm_fit = solver
    pca = cc.fit_scaler_pca_np(X, PCA_COMPONENTS, dev)["pca_components"]
    centres, inertia = tcl.KMeansTrainer(n_clusters=N_CLASSES, device=dev)._lloyd(X, N_CLASSES)
    return {**solved, "platt_a": state["svm_platt_a"], "platt_b": state["svm_platt_b"],
            "dec": cc.svm_decision_np(Xq, state, dev), "pred": cc.predict_svm_np(Xq, state, dev),
            "lda": cc.fit_lda_np(X, y, N_CLASSES, dev)["lda_coef"], "pca": pca @ pca.T,
            "knn": tcl._knn_counts(Xq, X, y, KNN_K, N_CLASSES, "minkowski", dev),
            "centres": centres, "inertia": inertia}


def phase_5e(dev) -> dict:
    """Phase 5e: configs/tuning.yaml (cut) and a batched study through the
    tune CLI on the card, on fsc22-sized FeatureSets made here (the mel set
    extracted on the card by ``mel_spec_feature``), with its checks; then one
    pca_svm cell's fold-batched decision values and one cnn trial group's
    first epoch, card against CPU. Returns what phase 6 times."""
    import logging

    import torch

    from audio_edge_ml_pipeline_torch.data.loaders import stratified_split_indices
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.features.base import FeatureSet
    from audio_edge_ml_pipeline_torch.models import get_model
    from audio_edge_ml_pipeline_torch.models.deep import MODEL_FILENAME, CNNTrainer, load_any_model
    from audio_edge_ml_pipeline_torch.ops import mel_kernel
    from audio_edge_ml_pipeline_torch.train import search_cv, tune, tune_batched

    print(f"[5e] cuts: configs/tuning.yaml's cnn study {TUNE_TRIALS} trials of {TUNE_EPOCHS} epochs (30 of 40 in "
          f"the file); its pca_svm grid whole (8 cells, cv 5, {search_cv._DEFAULT_ITERS} CV iterations, the "
          f"800-iteration refit); a batched study beside it ({BATCHED_TRIALS} trials of {TUNE_EPOCHS} epochs in "
          f"rounds of tune_parallel {BATCHED_K}, the cnn's architecture fixed at {CNN_PARAMS}); synthetic clips "
          f"(27 classes x {FSC22_CLIPS}, 5 s, 16 kHz, made on the card) for the mel FeatureSets and 5d's seeded "
          "302-d vectors for the classical one")
    names5e = [f"class{c:02d}" for c in range(N_CLASSES)]
    gen = torch.Generator(device=dev).manual_seed(5)
    mel_kernel.counter.reset()
    mel_kernel.counter_dense.reset()
    t0 = time.perf_counter()
    X_mel = np.concatenate([mel_kernel.mel_spec_feature(class_clips_on_card(gen, dev, c, FSC22_CLIPS)).cpu().numpy()
                            for c in range(N_CLASSES)])
    mel5e_s = time.perf_counter() - t0
    mel5e_launches = (mel_kernel.counter.launches, mel_kernel.counter_dense.launches)
    y_mel = np.repeat(np.arange(N_CLASSES), FSC22_CLIPS).astype(np.int32)
    split = np.array(stratified_split_indices([names5e[c] for c in y_mel], 0.70, 0.15, 42))
    X_ct, y_ct = fsc22_classical_train(np.random.default_rng(22))
    check(X_mel.shape == (N_CLASSES * FSC22_CLIPS, N_MELS, 1 + CLIP // HOP) and bool(np.isfinite(X_mel).all()),
          f"5e mel features {X_mel.shape}")
    check(mel5e_launches == (N_CLASSES, 0), f"5e's extraction launched (all, dense) {mel5e_launches}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp5e:
        tmp5e = Path(tmp5e)
        sets = {"fsc22_mel_train": (X_mel[split == "train"], y_mel[split == "train"], "audio_mel_spec"),
                "fsc22_mel_val": (X_mel[split == "validation"], y_mel[split == "validation"], "audio_mel_spec"),
                "fsc22_classical_train": (X_ct, y_ct, "classical")}
        for set_name, (Xs, ys, ftype) in sets.items():
            pipeline.FeaturePipeline.save(FeatureSet(features=Xs, feature_type=ftype, modality="audio",
                                                     metadata=[{} for _ in ys], labels=ys, label_names=names5e),
                                          tmp5e / set_name)
        cfg5e, cfg5e_batched, doc5e = tuning_config_copies(tmp5e / "fsc22_mel_train", tmp5e / "fsc22_mel_val",
                                                           tmp5e / "fsc22_classical_train", tmp5e / "tuning")
        messages5e: list[str] = []
        handler = logging.Handler(logging.INFO)
        handler.emit = lambda record: messages5e.append(record.getMessage())
        cell_s: list[float] = []
        grid_s: dict[str, float] = {}
        eval_cell, grid_fn = search_cv._CVEngine.eval_cell, search_cv.grid_search_cv_device

        def timed_cell(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = eval_cell(self, *args, **kwargs)   # ends on the host
            cell_s.append(time.perf_counter() - t0)
            return out

        def timed_grid(*args, **kwargs):
            t0 = time.perf_counter()
            out = grid_fn(*args, **kwargs)
            torch.cuda.synchronize()
            grid_s["grid"] = time.perf_counter() - t0
            return out

        logging.getLogger("audio_edge_ml_pipeline_torch").addHandler(handler)
        search_cv._CVEngine.eval_cell, search_cv.grid_search_cv_device = timed_cell, timed_grid
        os.environ["MLFLOW_TRACKING_URI"] = str(tmp5e / "mlruns")
        cwd = os.getcwd()
        os.chdir(tmp5e)   # the CLI archives its config under ./config/experiments
        tune_s = {}
        try:
            for label, cfg_path in (("shipped", cfg5e), ("batched", cfg5e_batched)):
                t0 = time.perf_counter()
                tune.main(["--config", str(cfg_path)])
                torch.cuda.synchronize()
                tune_s[label] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            os.environ.pop("MLFLOW_TRACKING_URI")
            search_cv._CVEngine.eval_cell, search_cv.grid_search_cv_device = eval_cell, grid_fn
            logging.getLogger("audio_edge_ml_pipeline_torch").removeHandler(handler)
        tuned = tmp5e / "tuning" / "tuned"
        shortlist5e = json.loads((tuned / "shortlist.json").read_text())
        summaries = {label: json.loads((tuned.parent / out / "cnn" / "trial_summary.json").read_text())
                     for label, out in (("shipped", "tuned"), ("batched", "tuned_batched"))}
        failures = [m for m in messages5e if "failed" in m and "Test-set evaluation failed" not in m]
        inherited = [m for m in messages5e if "Test-set evaluation failed" in m]
        print(f"[5e] mel FeatureSets on the card: {len(X_mel)} clips in {mel5e_s:.2f} s, mel_rfft launches "
              f"{mel5e_launches[0] - mel5e_launches[1]}, dense {mel5e_launches[1]}; train {int((split == 'train').sum())}, "
              f"validation {int((split == 'validation').sum())} rows; classical train {len(X_ct)} x {CLASSICAL_DIM}")
        print(f"[5e] tune CLI on the card: configs/tuning.yaml (cut) in {tune_s['shipped']:.2f} s, the pca_svm grid "
              f"{grid_s['grid']:.2f} s (cells {', '.join(f'{t:.3f}' for t in cell_s)} s, then the refit); the batched "
              f"study in {tune_s['batched']:.2f} s; shortlist "
              f"{[(c['rank'], c['model'], round(c['val_f1_macro'], 4), c['best_params']) for c in shortlist5e['candidates']]}")
        for label, sm in summaries.items():
            print(f"[5e] {label} cnn study: n_trials {sm['n_trials']}, completed {sm['n_completed']}, pruned "
                  f"{sm['n_pruned']}, best trial {sm['best_trial']} (val_f1_macro {sm['best_val_f1_macro']:.4f}, "
                  f"{sm['best_params']})")
        print(f"[5e] logged failures: {failures or 'none'}; the pca_svm run's test set (`features_test: null` inherits "
              f"the mel validation set, which its model cannot read): {inherited}")
        check(sorted(c["model"] for c in shortlist5e["candidates"]) == ["cnn", "pca_svm"],
              f"5e: the shortlist holds {[c['model'] for c in shortlist5e['candidates']]}")
        for label, sm in summaries.items():
            want = TUNE_TRIALS if label == "shipped" else BATCHED_TRIALS
            check(sm["n_trials"] == want and sm["n_completed"] + sm["n_pruned"] == want,
                  f"5e: the {label} study has failed trials: {sm['n_completed']} completed, {sm['n_pruned']} pruned of {want}")
        check(not failures, f"5e: the tune CLI logged failures: {failures}")
        check(len(cell_s) == 8, f"5e: the pca_svm grid ran {len(cell_s)} cells")
        check(any(f"batched rounds of {BATCHED_K}" in m for m in messages5e), "5e: the batched study did not batch")
        # the bundles load on the card and predict
        Xc_fit, Xc_val, yc_fit, yc_val = tune._split(X_ct, y_ct, 0.2)
        cand = {c["model"]: c for c in shortlist5e["candidates"]}
        svm_tuned = get_model("pca_svm").load(tuned / "pca_svm" / "pca_svm.npz")
        svm_acc = float((svm_tuned.predict(Xc_val) == yc_val).mean())
        X_mv, y_mv = sets["fsc22_mel_val"][:2]
        bundle_acc = {}
        for label, out in (("shipped", "tuned"), ("batched", "tuned_batched")):
            best_dir = tuned.parent / out / "cnn" / f"trial_{summaries[label]['best_trial']:02d}"
            cnn_tuned = load_any_model(best_dir / MODEL_FILENAME)
            check(cnn_tuned.device.type == "cuda", "5e: the tuned cnn is not on the card")
            proba = cnn_tuned.predict_proba(X_mv)
            check(proba.shape == (len(X_mv), N_CLASSES) and bool(np.isfinite(proba).all()), f"5e: {label} cnn predictions")
            bundle_acc[label] = float((proba.argmax(1) == y_mv).mean())
        print(f"[5e] bundles served on the card: pca_svm {svm_tuned.n_components} components, C {svm_tuned.C:g}, "
              f"{svm_tuned.kernel}, validation accuracy {svm_acc:.4f} (shortlist {cand['pca_svm']['val_accuracy']:.4f}); "
              f"the winning cnn trials on the {len(X_mv)} mel validation rows: accuracy "
              + ", ".join(f"{k} {v:.4f}" for k, v in bundle_acc.items()))
        check(svm_acc == cand["pca_svm"]["val_accuracy"], "5e: the pca_svm bundle does not predict what the CLI scored")

    # 5e. one pca_svm cell's fold-batched decision values card vs CPU (TF32 allowed), and one cnn trial group's
    # first epoch card vs CPU at dropout 0
    fold_of = search_cv.stratified_fold_ids(yc_fit.astype(np.int64), doc5e["cv"], 42)
    cell5e = {"n_components": 50, "C": 1.0, "kernel": "rbf"}
    engines5e, dec5e = {}, {}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            eng = search_cv._CVEngine(Xc_fit, yc_fit, fold_of, N_CLASSES, device=where)
            t0 = time.perf_counter()
            dec5e[side] = eng.svm_decisions(cell5e, eng.pca_features(cell5e))
            engines5e[side] = (eng, time.perf_counter() - t0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    cv_gap = float(np.abs(dec5e["card"] - dec5e["cpu"]).max() / np.abs(dec5e["cpu"]).max())
    eng_card = engines5e["card"][0]
    print(f"[5e] pca_svm cell {cell5e} fold-batched on {len(Xc_fit)} rows, {doc5e['cv']} folds x "
          f"{eng_card._ovo_cached()[1].shape[1]} pairs (M {eng_card._ovo_cached()[1].shape[2]}), "
          f"{search_cv._DEFAULT_ITERS} iterations: card with both TF32 flags on ({engines5e['card'][1]:.2f} s) vs CPU "
          f"({engines5e['cpu'][1]:.2f} s), decision values of all rows and folds max|d|/max|dec| {cv_gap:.3e} "
          f"(tol {CV_TOL:g})")
    check(cv_gap <= CV_TOL, f"5e: the fold-batched svm CV on the card disagrees with the CPU: {cv_gap:.3e}")

    Xm_fit, _, ym_fit, _ = tune._split(sets["fsc22_mel_train"][0], sets["fsc22_mel_train"][1], 0.2, 42)
    proto = CNNTrainer(**CNN_PARAMS, device=dev)
    Xg = proto._prepare_input(Xm_fit).astype(np.float32)
    g_mean, g_std = tune_batched._group_norm_stats(Xg)
    Xg = (Xg - g_mean) / g_std
    arch5e = {**proto._arch(Xg.shape[1:], N_CLASSES), "dropout": 0.0}
    states5e = tune_batched.init_states(arch5e, BATCHED_K, 42)
    lrs5e = [3e-4, 1e-3, 3e-3, 9e-3]   # inside the shipped search space's [2e-4, 1e-2]
    steps5e = len(Xg) // 32
    idx5e = np.random.default_rng(42).permutation(len(Xg))[: steps5e * 32].reshape(steps5e, 32)
    Xg_d, yg_d = torch.from_numpy(Xg).to(dev), torch.from_numpy(ym_fit.astype(np.int64)).to(dev)
    # in float64: in float32 Adam lifts roundoff on near-zero gradients to whole steps, and one epoch on
    # the CPU moves a tensor's parameters by up to 0.21 of its largest when the input moves 1e-7; in float64
    # by 6e-12 when it moves 1e-14 (scripts/torch_tune_sensitivity.py), so the two devices are held to each other
    groups5e, losses5e = {}, {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        g5 = tune_batched.TrialGroup(arch5e, states5e, lrs5e, [0.0] * BATCHED_K, where, torch.float64)
        losses5e[side] = g5.epoch(Xg_d.to(where, torch.float64), yg_d.to(where), idx5e).cpu()
        groups5e[side] = g5
    group_loss_gap = float(((losses5e["card"] - losses5e["cpu"]).abs() / losses5e["cpu"].abs()).max())
    group_param_gap, group_worst = max(
        (float((groups5e["card"].params[k].detach().cpu() - p.detach()).abs().max() / p.detach().abs().max()), k)
        for k, p in groups5e["cpu"].params.items())
    print(f"[5e] cnn trial group ({BATCHED_K} trials, {CNN_PARAMS}, lr {lrs5e}, dropout 0, batch 32) first epoch "
          f"({steps5e} steps on {len(Xg)} rows) card vs CPU: losses {losses5e['card'].numpy()} vs "
          f"{losses5e['cpu'].numpy()} (max rel {group_loss_gap:.3e}, tol {GROUP_LOSS_TOL:g}); parameters "
          f"max|d|/max|p| {group_param_gap:.3e} ({group_worst}; tol {GROUP_PARAM_TOL:g}), in float64")
    check(group_loss_gap <= GROUP_LOSS_TOL, "5e: the cnn trial group's losses on the card disagree with the CPU")
    check(group_param_gap <= GROUP_PARAM_TOL, "5e: the cnn trial group's parameters on the card disagree with the CPU")
    return {"mel_launches": mel5e_launches[0], "engine": eng_card, "cell": cell5e, "grid_s": grid_s["grid"],
            "n_components": sorted(set(doc5e["runs"][1]["grid"]["n_components"])), "rows": len(Xc_fit),
            "arch": arch5e, "states": states5e, "lrs": lrs5e, "X": Xg_d, "y": yg_d, "idx": idx5e}


def tuning_times(t5e: dict, card: str, in_turns) -> None:
    """Phase 6's tuning times at 5e's sizes: one svm CV cell fold-batched and
    fold by fold, each pca_cv, the grid's total (from 5e's CLI run), and a
    trial group of BATCHED_K cnn trials for one epoch against as many
    trials one at a time; with the card's name and power limit."""
    import torch

    from audio_edge_ml_pipeline_torch.models import classical_core
    from audio_edge_ml_pipeline_torch.train import search_cv, tune_batched

    eng_card, cell5e, arch5e, states5e, lrs5e = (t5e[k] for k in ("engine", "cell", "arch", "states", "lrs"))
    Xg_d, yg_d, idx5e = t5e["X"], t5e["y"], t5e["idx"]
    dev = Xg_d.device
    Z5e = eng_card.pca_features(cell5e)
    _, idx5, ypm5, cw5 = eng_card._ovo_cached()
    u5 = torch.from_numpy((cell5e["C"] * cw5).astype(np.float32)).to(dev)
    W5 = eng_card._W_dev
    n_folds5 = W5.shape[0]

    def cv_cell():
        return classical_core.svm_cv(Z5e, W5, idx5, ypm5, u5, 0.0, "rbf", "scale", search_cv._DEFAULT_ITERS)

    def cv_by_fold():
        return torch.cat([classical_core.svm_cv(Z5e[f : f + 1], W5[f : f + 1], idx5[f : f + 1], ypm5[f : f + 1],
                                                u5[f : f + 1], 0.0, "rbf", "scale", search_cv._DEFAULT_ITERS)
                          for f in range(n_folds5)])

    by_fold_gap = float((cv_by_fold() - cv_cell()).abs().max() / cv_cell().abs().max())
    (ms_cv_cell, ms_cv_by_fold), cv_turns = in_turns(cv_cell, cv_by_fold, timer=lambda fn: host_ms(fn, reps=1))
    ms_pca_cv = {k: host_ms(lambda k=k: classical_core.pca_cv(eng_card._X_dev, W5, k), reps=3)
                 for k in t5e["n_components"]}

    def group_epoch(members):
        def run():
            g = tune_batched.TrialGroup(arch5e, [states5e[i] for i in members], [lrs5e[i] for i in members],
                                        [0.3] * len(members), dev)
            return g.epoch(Xg_d, yg_d, idx5e)
        return run

    (ms_group, ms_group_seq), group_turns = in_turns(
        group_epoch(range(BATCHED_K)), lambda: [group_epoch([i])() for i in range(BATCHED_K)],
        timer=lambda fn: host_ms(fn, reps=1))
    print(f"[6] svm CV cell {cell5e} at 5e's size ({t5e["rows"]} rows, {n_folds5} folds x {idx5.shape[1]} pairs, M "
          f"{idx5.shape[2]}, {search_cv._DEFAULT_ITERS} iterations, captured): fold-batched {ms_cv_cell:.1f} ms "
          f"({ms_turns(cv_turns[0])}), fold by fold {ms_cv_by_fold:.1f} ms ({ms_turns(cv_turns[1])}), "
          f"{ms_cv_by_fold / ms_cv_cell:.2f}x; the two agree to {by_fold_gap:.3e} of the largest decision; pca_cv "
          + ", ".join(f"{k} components {v:.1f} ms" for k, v in ms_pca_cv.items())
          + f"; the whole pca_svm grid in the CLI {1e3 * t5e["grid_s"]:.1f} ms (8 cells and the refit) on {card}")
    print(f"[6] cnn trial group at 5e's size ({len(Xg_d)} rows, batch 32, {len(idx5e)} steps, dropout 0.3): "
          f"{BATCHED_K} trials batched {ms_group:.1f} ms an epoch ({ms_turns(group_turns[0])}), {ms_group / BATCHED_K:.1f} "
          f"ms a trial; one at a time {ms_group_seq:.1f} ms ({ms_turns(group_turns[1])}), {ms_group_seq / BATCHED_K:.1f} "
          f"ms a trial; batched {ms_group_seq / ms_group:.2f}x on {card}")
    check(by_fold_gap <= CV_TOL, f"the svm CV cell fold by fold disagrees with the fold-batched one: {by_fold_gap:.3e}")
    check(all(np.isfinite([ms_cv_cell, ms_cv_by_fold, ms_group, ms_group_seq, *ms_pca_cv.values()])), "tuning timing")


REPORT_KEYS = ("run_id", "run_name", "model_name", "original_model_path", "optimized_model_path", "original_size_kb",
               "optimized_size_kb", "compression_ratio", "quantization_method", "target_device",
               "val_accuracy_original", "val_accuracy_optimized", "accuracy_drop", "latency_ms", "timestamp",
               "benchmark_results")   # the JAX package's schema (tests/test_optimize.py)


def int8_plain(arr: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """Per-tensor symmetric int8 rounding in float64: (int8 tensor, float32 scale)."""
    a = np.asarray(arr, np.float64)
    scale = np.abs(a).max() / 127.0 if a.size else 0.0
    if scale == 0.0:
        return np.zeros(a.shape, np.int8), np.float32(0.0)
    return np.clip(np.rint(a / scale), -127, 127).astype(np.int8), np.float32(scale)


def bf16_plain(arr: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) of finite float32 values, rounded to nearest,
    ties to even, on the integer bits."""
    u = np.asarray(arr, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def captured_stdout(fn, *args) -> str:
    """Run ``fn(*args)``, print what it printed, and return it."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    print(buf.getvalue(), end="")
    return buf.getvalue()


def phase_5f(dev, runs: Path, experiment: str, clip: np.ndarray) -> dict:
    """5f: the post-training stages on 5c's trained runs (``runs``: the train
    CLI's output root, its tracking store under mlruns/) through the port's
    CLIs: pre-opt select, optimize on the card, the artifacts against plain
    numpy, post-opt select, deploy of the cnn (its report's mode, fp32,
    dynamic_int8, static_int8) with each host harness compiled by gcc and
    held against the card: scores on validation features, the C mel on
    ``clip`` against the card's mel feature. Returns what phase 6 prints."""
    import shutil

    import torch

    from audio_edge_ml_pipeline_torch.deploy import deploy
    from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
    from audio_edge_ml_pipeline_torch.models.deep import load_model_bundle
    from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel
    from audio_edge_ml_pipeline_torch.optimize import optimize
    from audio_edge_ml_pipeline_torch.optimize import quantize as qz
    from audio_edge_ml_pipeline_torch.train import select
    from audio_edge_ml_pipeline_torch.utils import profiling, tracking

    t_start = time.perf_counter()
    gcc = shutil.which("gcc")
    check(gcc is not None, "5f: gcc is not on PATH; the generated C cannot be compiled")
    gcc_version = subprocess.run([gcc, "--version"], capture_output=True, text=True, timeout=60).stdout.splitlines()[0]
    print(f"[5f] host compiler: {gcc_version}")
    out = runs / "post"
    shortlist_path, opt_dir = out / "shortlist.json", out / "optimized"
    t5f: dict = {"gcc": gcc_version}
    try:
        # 1. pre-opt select on 5c's experiment
        printed = captured_stdout(select.main, ["--experiment", experiment, "--mlflow-uri", str(runs / "mlruns"),
                                                "--output", str(shortlist_path)])
        shortlist = json.loads(shortlist_path.read_text())
        cands = shortlist["candidates"]
        check(shortlist["n_candidates"] == 5 and sorted(c["model"] for c in cands) == ["cnn", "knn", "mlp", "rnn", "svm"]
              and "Shortlist #1" in printed, f"5f: the pre-opt shortlist {[c['model'] for c in cands]}")
        print(f"[5f] select (pre-opt) on {experiment}: {[(c['rank'], c['run_name'], c['model']) for c in cands]}; "
              f"features_eval_dir {[c['features_eval_dir'] and Path(c['features_eval_dir']).name for c in cands]}")
        # The runs of configs/training.yaml after the cnn set `features_test_dir: null`, which inherits the
        # top-level mel validation set: both packages' train CLIs log it as their features_eval_dir, its rows
        # fit none of those models, and both optimize CLIs then fail those candidates (ROADMAP §3 f). As a user
        # would, clear it where the shapes differ: the CLI then evaluates on the calibration FeatureSet.
        def shape(fs_dir):
            return json.loads((Path(fs_dir) / "info.json").read_text())["feature_shape"]

        cleared = [c["run_name"] for c in cands
                   if c["features_eval_dir"] and shape(c["features_eval_dir"]) != shape(c["features_dir"])]
        for c in cands:
            if c["run_name"] in cleared:
                c["features_eval_dir"] = None
        shortlist_path.write_text(json.dumps(shortlist, indent=2))
        print(f"[5f] features_eval_dir cleared where its rows do not fit the model: {cleared}")
        check(sorted(c["model"] for c in cands if c["run_name"] in cleared) == ["knn", "mlp", "rnn", "svm"],
              f"5f: the inherited mel validation set should misfit the mlp, rnn, svm and knn, not {cleared}")

        # 2. optimize on the card, each candidate timed by its stage timer
        profiling.reset()
        t0 = time.perf_counter()
        optimize.main(["--shortlist", str(shortlist_path), "--output", str(opt_dir), "--max-accuracy-drop", "0.05",
                       "--mlflow-uri", str(out / "mlruns"), "--experiment", "chip-smoke-optimization"])
        torch.cuda.synchronize()
        t5f["optimize_s"] = time.perf_counter() - t0
        t5f["optimize_by_candidate_s"] = {k.split(":", 1)[1]: v["total_s"] for k, v in profiling.timing_report().items()}
        reports = {c["run_name"]: json.loads((opt_dir / c["run_name"] / "optimization_report.json").read_text())
                   for c in cands}
        for c in cands:
            rep = reports[c["run_name"]]
            deep = c["model"] in ("cnn", "mlp", "rnn")
            modes = sorted(("fp32", *(qz.DEEP_MODES if deep else qz.CLASSICAL_MODES)))
            print(f"[5f] optimize {c['run_name']} ({c['model']}) on the card: best {rep['quantization_method']}, "
                  f"{rep['optimized_size_kb']:.2f} KB of {rep['original_size_kb']:.2f}, accuracy "
                  f"{rep['val_accuracy_original']:.4f} -> {rep['val_accuracy_optimized']:.4f} (drop "
                  f"{rep['accuracy_drop']:g}); modes " + ", ".join(
                      f"{m} {b['size_kb']:.2f} KB acc {b['accuracy']:.4f}" for m, b in rep["benchmark_results"].items()))
            check(all(k in rep for k in REPORT_KEYS), f"5f: {c['run_name']}'s report misses {set(REPORT_KEYS) - set(rep)}")
            check(sorted(rep["benchmark_results"]) == modes, f"5f: {c['run_name']}'s modes {sorted(rep['benchmark_results'])}")
            check(rep["accuracy_drop"] <= 0.05 + 1e-9, f"5f: {c['run_name']}'s accuracy drop {rep['accuracy_drop']}")

        # 3. the artifacts against their plain versions, and the fp32 accuracy against the card's predict
        latencies = {}
        for c in cands:
            rep, mdir = reports[c["run_name"]], opt_dir / c["run_name"]
            fs = FeaturePipeline.load(c["features_dir"])
            X_cal, y_cal, names = fs.features, fs.labels, fs.label_names
            X_ev, y_ev = (optimize._load_eval_set(c["features_eval_dir"], names, None, c["run_name"])
                          if c["features_eval_dir"] else (X_cal, y_cal))
            bundle = Path(rep["original_model_path"])
            trainer = qz.load_trainer_any(bundle, c["model"], device=dev)
            check(getattr(trainer, "device", None) is not None and trainer.device.type == "cuda",
                  f"5f: {c['run_name']} did not load onto the card")
            acc = float((trainer.predict(X_ev) == y_ev).mean())
            check(acc == rep["val_accuracy_original"],
                  f"5f: {c['run_name']}'s fp32 accuracy {rep['val_accuracy_original']} is not the card's {acc}")
            checked = []
            if c["model"] in ("cnn", "mlp", "rnn"):
                _, flat, _, _ = load_model_bundle(bundle)
                for mode in ("dynamic_int8", "static_int8"):
                    art = np.load(mdir / f"model_{mode}.npz")
                    for k, arr in flat.items():
                        q, s = int8_plain(arr)
                        check(art[k].dtype == np.int8 and np.array_equal(art[k], q) and art[k + ".scale"] == s,
                              f"5f: {c['run_name']} {mode} {k} is not the plain int8 rounding")
                    checked.append(f"{mode} {len(flat)} tensors")
                art = np.load(mdir / "model_bfloat16.npz")
                for k, arr in flat.items():
                    check(art[k].dtype == np.uint16 and np.array_equal(art[k], bf16_plain(arr)),
                          f"5f: {c['run_name']} bfloat16 {k} is not the plain round-to-nearest-even")
                checked.append(f"bfloat16 {len(flat)} tensors")
            # each mode's view on the card: the CLI's evaluation (first timed call), then a second full call
            (out / "views" / c["run_name"]).mkdir(parents=True, exist_ok=True)
            for mode, bench in rep["benchmark_results"].items():
                view, _, _ = qz.build_mode(trainer, bundle, mode, out / "views" / c["run_name"], X_cal)
                m = qz.evaluate_model(view, X_ev, y_ev, names)
                t0 = time.perf_counter()
                view.predict(X_ev)
                second = (time.perf_counter() - t0) * 1000.0 / len(X_ev)
                latencies[c["run_name"], mode] = (m["latency_ms"], second, bench["latency_ms"], len(X_ev),
                                                  m["accuracy"] == bench["accuracy"])
            print(f"[5f] {c['run_name']}: fp32 accuracy {acc:.4f} from the card's predict on {len(X_ev)} rows equals "
                  f"the report's; artifacts equal their plain numpy versions bit for bit: "
                  f"{', '.join(checked) or 'no int8 or bfloat16 artifact (classical)'}")
        t5f["latency"] = latencies

        # 4. post-opt select
        printed = captured_stdout(select.main, ["--post-opt", "--shortlist", str(shortlist_path),
                                                "--opt-dir", str(opt_dir)])
        best = json.loads((opt_dir / "best_model.json").read_text())
        check("Best post-optimisation model" in printed and best["model"] in ("cnn", "mlp", "rnn", "svm", "knn"),
              f"5f: post-opt select {best}")
        printed = captured_stdout(select.main, ["--post-opt", "--shortlist", str(shortlist_path), "--opt-dir",
                                                str(opt_dir), "--max-size-kb", "0.001", "--output",
                                                str(out / "gated.json")])
        check("No model qualified" in printed and not (out / "gated.json").exists(), "5f: the --max-size-kb gate")
        print(f"[5f] select --post-opt: best {best['run_name']} ({best['model']}, {best['quantization_method']}, "
              f"{best['optimized_size_kb']:.2f} KB, accuracy {best['val_accuracy_optimized']:.4f}); "
              "--max-size-kb 0.001 qualifies none and writes no file")
    finally:
        tracking.set_tracking_uri(None)

    # 5. deploy the cnn: its report's mode, and fp32 / dynamic_int8 / static_int8, each compiled and run on the host
    (cnn,) = (c for c in cands if c["model"] == "cnn")
    cnn_dir, cnn_report = opt_dir / cnn["run_name"], opt_dir / cnn["run_name"] / "optimization_report.json"
    chosen = reports[cnn["run_name"]]["quantization_method"]
    val = FeaturePipeline.load(cnn["features_eval_dir"])
    train_fs = FeaturePipeline.load(cnn["features_dir"])
    cnn_bundle = Path(reports[cnn["run_name"]]["original_model_path"])
    cnn_trainer = qz.load_trainer_any(cnn_bundle, "cnn", device=dev)
    (out / "clip.f32").write_bytes(np.asarray(clip, np.float32).tobytes())
    gold = golden.mel_spec_feature(clip)
    deployed = {}
    mel_kernel.counter.reset()
    for label, mode, args in (("--report", chosen, ["--report", str(cnn_report)]),
                              *((mode, mode, ["--model", str(cnn_dir / f"model_{mode}.npz")])
                                for mode in ("fp32", "dynamic_int8", "static_int8"))):
        proj = out / "deploy" / label.strip("-")
        t0 = time.perf_counter()
        captured_stdout(deploy.main, [*args, "--features-dir", cnn["features_dir"], "--output", str(proj)])
        gen_s = time.perf_counter() - t0
        cg = json.loads((proj / "codegen_report.json").read_text())
        check(cg["quantization"] == mode and Path(cg["bundle"]).name == f"model_{mode}.npz",
              f"5f: deploy {label} shipped {cg['bundle']} ({cg['quantization']}), not model_{mode}.npz")
        exe = proj / "host_runner"
        t0 = time.perf_counter()
        cc_run = subprocess.run([gcc, "-O2", "-std=c99", f"-I{proj / 'src'}", "-o", str(exe), str(proj / "host_main.c"),
                                 *map(str, sorted((proj / "src").glob("*.c"))), "-lm"],
                                capture_output=True, text=True, timeout=600)
        cc_s = time.perf_counter() - t0
        check(cc_run.returncode == 0, f"5f: gcc failed on the {label} project: {cc_run.stderr[-2000:]}")
        view_dir = out / "views" / f"deploy_{label.strip('-')}"
        view_dir.mkdir(parents=True, exist_ok=True)
        view, _, _ = qz.build_mode(cnn_trainer, cnn_bundle, mode, view_dir, train_fs.features)
        score_err, same_argmax = 0.0, True
        for j in (0, len(val.features) // 2):
            (proj / "feat.f32").write_bytes(val.features[j].astype(np.float32).tobytes())
            run = subprocess.run([str(exe), "--predict-feat", str(proj / "feat.f32")], capture_output=True, text=True,
                                 timeout=120)
            check(run.returncode == 0, f"5f: the {label} harness failed: {run.stderr[-2000:]}")
            c_scores = np.array([float(v) for v in run.stdout.split()])
            card_scores = view.predict_proba(val.features[j : j + 1])[0]
            check(c_scores.shape == card_scores.shape, f"5f: {label} C scores shape {c_scores.shape}")
            score_err = max(score_err, float(np.abs(c_scores - card_scores).max()))
            same_argmax &= int(c_scores.argmax()) == int(card_scores.argmax())
        run = subprocess.run([str(exe), "--features", str(out / "clip.f32")], capture_output=True, text=True, timeout=120)
        check(run.returncode == 0, f"5f: the {label} harness failed on --features: {run.stderr[-2000:]}")
        c_mel = np.array([float(v) for v in run.stdout.split()]).reshape(gold.shape)
        card_mel = mel_kernel.mel_spec_feature(torch.from_numpy(clip[None]).to(dev))[0].cpu().numpy()
        mel_err, mel_gold = float(np.abs(c_mel - card_mel).max()), float(np.abs(c_mel - gold).max())
        deployed[label] = (mode, gen_s, cc_s)
        print(f"[5f] deploy {label} ({mode}, arena peak {cg['arena_peak_kb']:.1f} KB): C scores on 2 validation "
              f"features vs the view's predict_proba on the card max|d| {score_err:.3e} (tol {C_SCORE_TOL:g}), "
              f"argmax equal {same_argmax}; C mel on a tree clip vs the card's mel_spec_feature max|d| {mel_err:.3e}, "
              f"vs float64 golden {mel_gold:.3e} (tol {C_MEL_TOL:g})")
        check(score_err <= C_SCORE_TOL and same_argmax, f"5f: the {label} C forward disagrees with the card")
        check(mel_err <= C_MEL_TOL and mel_gold <= C_MEL_TOL, f"5f: the {label} C mel disagrees with the card")
    torch.cuda.synchronize()
    t5f["mel_launches"] = mel_kernel.counter.launches
    launched = dict(mel_kernel.counter.by_instantiation)
    check(launched == {"mel_rfft<256, float>": len(deployed)},
          f"5f: the card's mel feature launched {launched}, not mel_rfft<256, float> once a project")
    t5f["deployed"] = deployed
    print(f"[5f] phase 5f in {time.perf_counter() - t_start:.2f} s")
    return t5f


def deploy_times(t5f: dict, card: str) -> None:
    """Phase 6's post-training times from 5f: each mode's latency_ms (the
    CLI's timed call and a second full call), the optimize CLI's wall time
    a candidate, codegen and gcc a project; with the card's name and power
    limit."""
    for (run, mode), (first, second, in_report, rows, same_acc) in t5f["latency"].items():
        print(f"[6] latency_ms of {run} {mode} on {rows} rows: first full call {first:.4f} ms a row (the report's "
              f"run {in_report:.4f}), second {second:.4f}; accuracy as in the report {same_acc} on {card}")
    print(f"[6] optimize CLI over 5 candidates: {1e3 * t5f['optimize_s']:.1f} ms; a candidate "
          + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in t5f["optimize_by_candidate_s"].items()) + f" on {card}")
    print("[6] deploy (codegen) and gcc -O2 a cnn project: " + "; ".join(
        f"{label} ({mode}) {1e3 * g:.1f} ms + gcc {1e3 * c:.1f} ms" for label, (mode, g, c) in t5f["deployed"].items())
          + f" ({t5f['gcc']}) on the host of {card}")
    check(all(np.isfinite([v for lat in t5f["latency"].values() for v in lat[:3]])), "5f timing")


def ms_turns(ts: list[float]) -> str:
    return f"turns {', '.join(f'{t:.3f}' for t in ts)}"


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` (which returns host data, or is
    synchronised here), after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def step_and_grads(dev, X: np.ndarray, y: np.ndarray, bundle: Path, model: str = "cnn",
                   params: dict | None = None) -> tuple[float, dict]:
    """One Adam step of ``model``'s trainer (``params``: its widths; the
    flagship CNN's by default) at dropout 0, warm-started from ``bundle``,
    on the first 32 rows of (X, y): (loss, gradients of the trained
    parameters)."""
    import torch

    from audio_edge_ml_pipeline_torch.models import get_model

    tr = get_model(model)(**(CNN_PARAMS if params is None else params), dropout=0.0, batch_size=32, seed=0,
                          pretrained_model=str(bundle), device=dev)
    Xp = tr._prepare_input(X).astype(np.float32)
    tr.prepare_fit(Xp, N_CLASSES)
    tr._net.train()
    trained = {k: p for k, p in tr._net.named_parameters() if p.requires_grad}
    opt = torch.optim.Adam(trained.values(), lr=1e-3)
    idx = torch.arange(32, device=dev)
    loss, _ = tr.train_step(opt, torch.from_numpy(Xp).to(dev), torch.from_numpy(y.astype(np.int64)).to(dev),
                            idx, torch.ones(32, device=dev))
    return float(loss), {k: p.grad.detach().cpu() for k, p in trained.items()}


def grad_gap(dev, X: np.ndarray, y: np.ndarray, bundle: Path, model: str = "cnn",
             params: dict | None = None) -> tuple[float, float, float, float, str, int]:
    """``step_and_grads`` on the card and on the CPU: (card loss, CPU loss,
    their relative gap, the largest max|d|/max|g| over the gradient tensors,
    that tensor's name, the tensor count)."""
    import torch

    loss_gpu, grads_gpu = step_and_grads(dev, X, y, bundle, model, params)
    loss_cpu, grads_cpu = step_and_grads(torch.device("cpu"), X, y, bundle, model, params)
    grad_rel, worst = max((float((grads_gpu[k] - grads_cpu[k]).abs().max() / grads_cpu[k].abs().max()), k)
                          for k in grads_cpu)
    return loss_gpu, loss_cpu, abs(loss_gpu - loss_cpu) / abs(loss_cpu), grad_rel, worst, len(grads_cpu)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    if not (REPO / "audio_edge_ml_pipeline_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} holds no audio_edge_ml_pipeline_torch package", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from audio_edge_ml_pipeline_torch.data.audio_io import load_audio
    from audio_edge_ml_pipeline_torch.entry import flagship
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.models import classical_core, get_model
    from audio_edge_ml_pipeline_torch.models.deep import MODEL_FILENAME, CNNTrainer, load_any_model
    from audio_edge_ml_pipeline_torch.ops import _build, audio_features, dsp, golden, mel_kernel, mel_unfolded
    from audio_edge_ml_pipeline_torch.serve.edge_simulator import EdgeDeviceSimulator
    from audio_edge_ml_pipeline_torch.train import train
    from audio_edge_ml_pipeline_torch.utils import tracking

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    kernels = ["mel_rfft", "mel_folded", "mel_unfolded"]
    built = _build.build(kernels)
    print(f"[2] build: {time.perf_counter() - t0:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in built.items()) or 'already built'})")
    for kname in kernels:
        ptxas = ptxas_report(_build.library_path(kname).with_suffix(".log").read_text())
        print(f"[2] {kname} ptxas: {' | '.join(ptxas)}")

    # 3. kernel against its plain version, feature against the float64 golden copy
    rng = np.random.default_rng(0)

    entries = {  # entry -> (its module, its plain version, its dense kernel)
        "mel_power_folded": (mel_kernel, mel_kernel.mel_power_folded_plain, "mel_folded.cu"),
        "mel_power_unfolded": (mel_unfolded, mel_unfolded.mel_power_unfolded_plain, "mel_unfolded.cu"),
    }

    errs_by_instantiation: dict[str, float] = {}   # max|d| against the plain version, by template instantiation

    def against_plain(entry: str, label: str, batch: int, n: int, sr: int, n_fft: int, hop: int,
                      n_mels: int, precise: bool = False) -> float:
        """One call of ``entry`` on the card, which must launch its kernel once
        on the route ``route(n_fft)`` names (its float64 instantiation if
        ``precise``), held against its plain version at KERNEL_REL_TOL of
        each clip's peak power, and if ``precise`` at F64_ELEMENT_TOL of
        each bin (the plain version's products run in float64, so only a
        float64 kernel meets that). Returns max|d|."""
        module, plain_fn, dense_kernel = entries[entry]
        dense = module.route(n_fft) == "dense"
        y = torch.from_numpy(synth_clips(rng, batch, n)).to(dev)
        module.counter.reset()
        module.counter_dense.reset()
        mel_kernel.counter_f64.reset()
        out = getattr(module, entry)(y, sr, n_mels, n_fft, hop, **({"precise": True} if precise else {}))
        torch.cuda.synchronize()
        launches = (module.counter.launches, module.counter_dense.launches)
        check(mel_kernel.counter_f64.launches == int(precise), f"{entry} float64 launches")
        kernel = mel_kernel.instantiation(dense_kernel.removesuffix(".cu") if dense else "rfft", n_fft, precise)
        check(dict(module.counter.by_instantiation) == {kernel: 1},
              f"{entry} at n_fft {n_fft} launched {dict(module.counter.by_instantiation)}, not {kernel}")
        ref = plain_fn(y, sr, n_mels, n_fft, hop)
        err = (out - ref).abs()
        rel = float((err / ref.abs().amax(dim=(1, 2), keepdim=True)).max())
        rel_bin = float((err / ref.abs().clamp_min(torch.finfo(torch.float32).tiny)).max())
        errs_by_instantiation[kernel] = max(errs_by_instantiation.get(kernel, 0.0), float(err.max()))
        print(f"[3] {entry} n_fft {n_fft}, hop {hop}, {n_mels} mels ({kernel}) vs plain, {label}: "
              f"launches (all, dense) {launches}, max|d| {float(err.max()):.3e}, max|d|/clip peak {rel:.3e} "
              f"(tol {KERNEL_REL_TOL:g}), max|d|/|plain| per bin {rel_bin:.3e}"
              + (f" (tol {F64_ELEMENT_TOL:g})" if precise else " (not checked)"))
        check(not precise or rel_bin <= F64_ELEMENT_TOL,
              f"{entry}'s float64 instantiation disagrees with its plain version per bin at n_fft {n_fft}: {rel_bin:.3e}")
        check(launches == (1, int(dense)), f"{entry} at n_fft {n_fft} launched (all, dense) {launches}")
        check(out.shape == (batch, 1 + n // hop, n_mels), f"{entry} output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{entry} output is not finite")
        check(rel <= KERNEL_REL_TOL, f"{entry} disagrees with its plain version at n_fft {n_fft}, {label}: {rel:.3e}")
        return float(err.max())

    shapes = [("B=64 x 5 s", 64, CLIP, SR, N_FFT, HOP, N_MELS), ("T=201", 1, 32000, SR, N_FFT, HOP, N_MELS)]
    worst_abs = max(against_plain("mel_power_folded", *shape) for shape in shapes + [
        ("MFCC frontend 1024/512/128 mels @ 22.05 kHz", 2, 66150, 22050, 1024, 512, 128),
        *(("B=4 x 5 s", 4, CLIP, SR, n_fft, HOP, N_MELS) for n_fft in (320, 400, 640))])
    worst_abs_f64 = max(against_plain("mel_power_folded", *shape, precise=True) for shape in [
        ("MFCC frontend 1024/512/128 mels @ 22.05 kHz", 2, 66150, 22050, 1024, 512, 128),
        ("B=4 x 5 s", 4, CLIP, SR, N_FFT, HOP, N_MELS), ("B=4 x 5 s", 4, CLIP, SR, 400, HOP, N_MELS)])
    worst_abs_unfolded = max(against_plain("mel_power_unfolded", *shape) for shape in shapes + [
        ("MFCC frontend 1024/512/128 mels @ 22.05 kHz", 8, 5 * 22050, 22050, 1024, 512, 128),
        ("B=4 x 5 s", 4, CLIP, SR, 400, HOP, N_MELS)])
    # the four-pass plans through both entries and in float64, at 16 kHz and at librosa's default front end
    front_2048 = ("librosa front end 2048/512/128 mels @ 22.05 kHz", 2, 66150, 22050, 2048, 512, 128)
    for n_fft in NEW_PLANS:
        against_plain("mel_power_folded", "B=4 x 5 s", 4, CLIP, SR, n_fft, HOP, N_MELS)
        against_plain("mel_power_folded", "B=4 x 5 s", 4, CLIP, SR, n_fft, HOP, N_MELS, precise=True)
        against_plain("mel_power_unfolded", "B=4 x 5 s", 4, CLIP, SR, n_fft, HOP, N_MELS)
    for entry in entries:
        against_plain(entry, *front_2048)
    against_plain("mel_power_folded", *front_2048, precise=True)
    against_plain("mel_power_folded", "hop 1024: the FFT kernel's tiles shrink to fit", 2, 66150, 22050, 2048, 1024,
                  128, precise=True)
    # each entry's dense kernel, and the folded one's float64 instantiation
    for entry in entries:
        against_plain(entry, "B=4 x 5 s", 4, CLIP, SR, DENSE_N_FFT, HOP, N_MELS)
    against_plain("mel_power_folded", "B=4 x 5 s", 4, CLIP, SR, DENSE_N_FFT, HOP, N_MELS, precise=True)
    against_plain("mel_power_folded", f"MFCC front end at n_fft {DENSE_N_FFT_22}", 2, 66150, 22050, DENSE_N_FFT_22,
                  512, 128, precise=True)
    # no even n_fft from 4 to 4096 raises, in either precision
    for n_fft in SWEEP_N_FFT:
        for precise in (False, True):
            against_plain("mel_power_folded", "sweep, B=2 x 1 s", 2, SR, SR, n_fft, HOP, N_MELS, precise=precise)
    try:
        mel_unfolded.mel_power_unfolded(torch.zeros((2, 4000), device=dev), n_fft=511)
        fail("mel_unfolded took an odd n_fft")
    except ValueError as exc:
        print(f"[3] mel_unfolded refuses odd n_fft: {exc}")
    lengths = np.array([CLIP, 61234, 17001, 4000], np.int64)
    y_np = synth_clips(rng, len(lengths))
    for i, n in enumerate(lengths):
        y_np[i, n:] = 0.0
    y = torch.from_numpy(y_np).to(dev)
    feat = mel_kernel.mel_spec_feature(y, lengths=torch.from_numpy(lengths).to(dev)).cpu().numpy()
    feat_plain = mel_kernel.mel_spec_feature(y.cpu(), lengths=torch.from_numpy(lengths)).numpy()
    gold_err = pad_err = 0.0
    for i, n in enumerate(lengths):
        t = 1 + n // HOP
        gold_err = max(gold_err, float(np.abs(feat[i, :, :t] - golden.mel_spec_feature(y_np[i, :n])).max()))
        pad_err = max(pad_err, float(np.abs(feat[i, :, :t] - feat_plain[i, :, :t]).max()))
    print(f"[3] mel_spec_feature padded batch with lengths: card vs float64 golden max|d| {gold_err:.3e}, "
          f"card vs CPU plain {pad_err:.3e} (tol {FEATURE_TOL:g})")
    check(gold_err <= FEATURE_TOL and pad_err <= FEATURE_TOL, "mel_spec_feature misses the 1e-5 gate")

    # 3c. the MFCC and classical features on the card, with TF32 allowed everywhere, at the extractors'
    # n_fft 1024, at 2048 (the FFT route) and 2050 (the dense float64 route); the mel feature at 511 and 2048
    y22_np = synth_clips(rng, 4, CLIP22, SR22)
    y22 = torch.from_numpy(y22_np).to(dev)
    y16_np = synth_clips(rng, 4)
    y16 = torch.from_numpy(y16_np).to(dev)
    y22_64 = y22_np.astype(np.float64)
    t22 = {nf: 1 + CLIP22 // MFCC_HOP for nf in (MFCC_N_FFT, 2048, DENSE_N_FFT_22)}
    f64 = {nf: mel_kernel.instantiation(mel_kernel.route(nf).replace("dense", "mel_folded"), nf, True)
           for nf in (MFCC_N_FFT, 2048, DENSE_N_FFT_22)}
    cases3c = {  # label -> (feature on the card, golden, tol, shape, launches (all, dense, float64), instantiation)
        "mfcc_seq_feature": (lambda: audio_features.mfcc_seq_feature(y22),
                             lambda c: golden.mfcc_seq_feature(c), FEATURE_TOL, (4, 40, t22[MFCC_N_FFT]),
                             (1, 0, 1), f64[MFCC_N_FFT]),
        "mfcc": (lambda: audio_features.mfcc(y22, SR22, 40, MFCC_N_FFT, MFCC_HOP),
                 lambda c: golden.mfcc(c, SR22, 40, MFCC_N_FFT, MFCC_HOP), RAW_MFCC_TOL, (4, 40, t22[MFCC_N_FFT]),
                 (1, 0, 1), f64[MFCC_N_FFT]),
        "classical_feature_vector": (lambda: audio_features.classical_feature_vector(y22),
                                     lambda c: golden.classical_feature_vector(c), CLASSICAL_REL_TOL, (4, 302),
                                     (1, 0, 1), f64[MFCC_N_FFT]),
        "waveform_feature": (lambda: dsp.waveform_feature(y22), golden.waveform_feature, WAVEFORM_TOL,
                             (4, CLIP22), (0, 0, 0), None),
        **{f"{name} n_fft {nf}": (
            (lambda nf=nf: audio_features.mfcc_seq_feature(y22, n_fft=nf)) if name == "mfcc_seq_feature" else
            (lambda nf=nf: audio_features.classical_feature_vector(y22, n_fft=nf)),
            (lambda c, nf=nf: golden.mfcc_seq_feature(c, n_fft=nf)) if name == "mfcc_seq_feature" else
            (lambda c, nf=nf: golden.classical_feature_vector(c, n_fft=nf)),
            FEATURE_TOL if name == "mfcc_seq_feature" else CLASSICAL_REL_TOL,
            (4, 40, t22[nf]) if name == "mfcc_seq_feature" else (4, 302),
            (1, int(nf == DENSE_N_FFT_22), 1), f64[nf])
           for name in ("mfcc_seq_feature", "classical_feature_vector") for nf in (2048, DENSE_N_FFT_22)},
        "mel_spec_feature n_fft 511": (lambda: mel_kernel.mel_spec_feature(y16, n_fft=511),
                                       lambda c: golden.mel_spec_feature(c, n_fft=511), FEATURE_TOL,
                                       (4, N_MELS, 1 + (CLIP - 1) // HOP), (0, 0, 0), None),
        "mel_spec_feature n_fft 2048": (lambda: mel_kernel.mel_spec_feature(y16, n_fft=2048),
                                        lambda c: golden.mel_spec_feature(c, n_fft=2048), FEATURE_TOL,
                                        (4, N_MELS, 1 + CLIP // HOP), (1, 0, 0), "mel_rfft<1024, float>"),
    }
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        mfcc_launches = {}
        feats3c = {}
        for label, (fn, *_) in cases3c.items():
            mel_kernel.counter.reset()
            mel_kernel.counter_dense.reset()
            mel_kernel.counter_f64.reset()
            feats3c[label] = fn().cpu().numpy()
            torch.cuda.synchronize()
            mfcc_launches[label] = ((mel_kernel.counter.launches, mel_kernel.counter_dense.launches,
                                     mel_kernel.counter_f64.launches), dict(mel_kernel.counter.by_instantiation))
        flags_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for label, (_, gold_fn, tol, shape, launches, inst) in cases3c.items():
        clips = y16_np if label.startswith("mel_spec") else y22_64
        gold = np.stack([gold_fn(c) for c in clips])
        d = np.abs(feats3c[label] - gold)
        classical = label.startswith("classical")
        err = float((d / np.maximum(np.abs(gold), 1.0)).max() if classical else d.max())
        print(f"[3c] {label} on the card, TF32 flags on: shape {feats3c[label].shape}, vs float64 golden "
              f"{'max|d|/max(|g|, 1)' if classical else 'max|d|'} {err:.3e} (tol {tol:g}); mel kernel launches "
              f"(all, dense, float64) {mfcc_launches[label][0]}, {mfcc_launches[label][1]}")
        check(feats3c[label].shape == shape and bool(np.isfinite(feats3c[label]).all()), f"{label} shape or finiteness")
        check(err <= tol, f"{label} on the card misses its gate against golden: {err:.3e}")
        check(mfcc_launches[label] == (launches, {inst: 1} if inst else {}),
              f"{label} launched {mfcc_launches[label]}, not {launches} of {inst}")
    check(flags_after == (True, True), "the DSP changed the caller's TF32 flags")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        fsc22, folder, class_names = write_wav_tree(tmp, rng)

        # 4. extraction CLI
        mel_kernel.counter.reset()
        mel_kernel.counter_dense.reset()
        t0 = time.perf_counter()
        pipeline.main(["--loader", "fsc22", "--dataset", str(fsc22), "--extractor", "audio_mel_spec",
                       "--split", "all", "--output", str(tmp / "features")])
        extract_s = time.perf_counter() - t0
        extract_launches = mel_kernel.counter.launches
        extract_dense = mel_kernel.counter_dense.launches
        fs = pipeline.FeaturePipeline.load(tmp / "features")
        n_clips = N_CLASSES * PER_CLASS
        check(fs.features.shape == (n_clips, N_MELS, 1 + CLIP // HOP), f"FeatureSet shape {fs.features.shape}")
        check(fs.n_classes == N_CLASSES and len(fs.labels) == n_clips, "FeatureSet labels")
        check(bool(np.isfinite(fs.features).all()) and fs.features.min() >= 0 and fs.features.max() <= 1,
              "features outside [0, 1]")
        cli_err = 0.0
        for j in (0, n_clips // 2, n_clips - 1):
            yj, _ = load_audio(fsc22 / "Audio Wise V1.0-20260101" / "Audio Wise V1.0" / fs.metadata[j]["filename"], sr=SR)
            cli_err = max(cli_err, float(np.abs(fs.features[j] - golden.mel_spec_feature(yj)).max()))
        print(f"[4] extraction CLI: {fs} in {extract_s:.2f} s; mel_rfft launches {extract_launches - extract_dense}, "
              f"dense mel_folded launches {extract_dense}; 3 rows vs float64 golden max|d| {cli_err:.3e}")
        check(extract_launches > 0 and extract_dense == 0, "the extraction CLI did not run the FFT mel kernel")
        check(cli_err <= FEATURE_TOL, "CLI features miss the 1e-5 gate")

        audio_dir = fsc22 / "Audio Wise V1.0-20260101" / "Audio Wise V1.0"
        tree = np.stack([load_audio(audio_dir / m["filename"], sr=SR)[0] for m in fs.metadata]).astype(np.float32)
        tree_d = torch.from_numpy(tree).to(dev)
        gold_mel = [golden.melspectrogram(tree[j].astype(np.float64), sr=SR, n_mels=N_MELS, n_fft=N_FFT, hop_length=HOP)
                    for j in (0, n_clips // 2, n_clips - 1)]
        mel_r = mel_kernel.mel_power_folded(tree_d).cpu().numpy()
        gold_rel_rfft = max(float(np.abs(mel_r[j].T - g).max() / np.abs(g).max())
                            for j, g in zip((0, n_clips // 2, n_clips - 1), gold_mel))
        print(f"[4] mel_rfft on the {n_clips} tree clips: 3 clips vs float64 golden mel power max|d|/clip peak "
              f"{gold_rel_rfft:.3e} (tol {GOLDEN_REL_TOL:g})")
        check(gold_rel_rfft <= GOLDEN_REL_TOL, "the FFT kernel misses the golden mel power")

        # 4b. the unfolded kernel's entry point on the tree's clips
        mel_unfolded.counter.reset()
        mel_unfolded.counter_dense.reset()
        mel_u = mel_unfolded.mel_power_unfolded(tree_d).cpu().numpy()
        unfolded_launches = mel_unfolded.counter.launches
        unfolded_dense = mel_unfolded.counter_dense.launches
        gold_rel = max(float(np.abs(mel_u[j].T - g).max() / np.abs(g).max())
                       for j, g in zip((0, n_clips // 2, n_clips - 1), gold_mel))
        print(f"[4] mel_power_unfolded on the {n_clips} tree clips: shape {mel_u.shape}, mel_rfft launches "
              f"{unfolded_launches - unfolded_dense}, dense mel_unfolded launches {unfolded_dense}; "
              f"3 clips vs float64 golden mel power max|d|/clip peak {gold_rel:.3e} (tol {GOLDEN_REL_TOL:g})")
        check(unfolded_launches == 1 and unfolded_dense == 0,
              f"mel_power_unfolded launched {unfolded_launches} kernels ({unfolded_dense} dense) for one call")
        check(mel_u.shape == (n_clips, 1 + CLIP // HOP, N_MELS), "unfolded mel shape")
        check(gold_rel <= GOLDEN_REL_TOL, "the unfolded kernel misses the golden mel power")
        # and its dense kernel, at an n_fft with no FFT plan
        mel_unfolded.counter.reset()
        mel_unfolded.counter_dense.reset()
        mel_ud = mel_unfolded.mel_power_unfolded(tree_d, n_fft=DENSE_N_FFT).cpu().numpy()
        unfolded_dense_launches = dict(mel_unfolded.counter.by_instantiation)
        gold_rel_d = max(float(np.abs(mel_ud[j].T - g).max() / np.abs(g).max())
                         for j, g in ((j, golden.melspectrogram(tree[j].astype(np.float64), sr=SR, n_mels=N_MELS,
                                                                n_fft=DENSE_N_FFT, hop_length=HOP))
                                      for j in (0, n_clips // 2, n_clips - 1)))
        print(f"[4] mel_power_unfolded at n_fft {DENSE_N_FFT} on the {n_clips} tree clips: launches "
              f"{unfolded_dense_launches}; 3 clips vs float64 golden mel power max|d|/clip peak {gold_rel_d:.3e} "
              f"(tol {GOLDEN_REL_TOL:g})")
        check(unfolded_dense_launches == {"mel_unfolded<float>": 1}, "mel_power_unfolded's dense route")
        check(gold_rel_d <= GOLDEN_REL_TOL, "the dense unfolded kernel misses the golden mel power")

        # 4c. the shipped extraction config on the same tree, through the CLI on the card
        cfg, shipped = shipped_config_copy(fsc22, tmp / "shipped")
        shipped_launches: dict[str, tuple[int, int]] = {}
        shipped_s: dict[str, float] = {}
        run_experiment = pipeline._run_experiment

        counters = (mel_kernel.counter, mel_kernel.counter_dense, mel_kernel.counter_f64)

        def counted(exp, *args, **kwargs):
            before = [c.launches for c in counters]
            t0 = time.perf_counter()
            run_experiment(exp, *args, **kwargs)
            torch.cuda.synchronize()
            shipped_s[exp.resolved_name()] = time.perf_counter() - t0
            shipped_launches[exp.resolved_name()] = tuple(c.launches - b for c, b in zip(counters, before))

        pipeline._run_experiment = counted
        try:
            for c in counters:
                c.reset()
            pipeline.main(["--config", str(cfg)])
        finally:
            pipeline._run_experiment = run_experiment
        shipped_f64 = mel_kernel.counter_f64.launches
        shipped_f32 = mel_kernel.counter.launches - shipped_f64
        split_rows = {"train": N_CLASSES * 4, "validation": N_CLASSES}   # 5 a class: 4 train, 1 validation
        per_clip = {"audio_mel_spec": ((N_MELS, 1 + CLIP // HOP), golden.mel_spec_feature, SR, FEATURE_TOL),
                    "audio_mfcc_seq": ((40, 1 + CLIP22 // MFCC_HOP), golden.mfcc_seq_feature, SR22, FEATURE_TOL),
                    "audio_classical": ((302,), golden.classical_feature_vector, SR22, CLASSICAL_REL_TOL)}
        check(len(shipped_launches) == len(shipped) == 4, f"the shipped config ran {sorted(shipped_launches)}")
        for exp in shipped:
            shape, gold_fn, sr_exp, tol = per_clip[exp["extractor"]]
            fs_exp = pipeline.FeaturePipeline.load(exp["output"])
            rows = split_rows[exp["split"]]
            check(fs_exp.features.shape == (rows, *shape), f"{exp['name']} FeatureSet shape {fs_exp.features.shape}")
            check(fs_exp.n_classes == N_CLASSES and len(fs_exp.labels) == rows
                  and all(fs_exp.label_names[c] == m["class_name"] for c, m in zip(fs_exp.labels, fs_exp.metadata)),
                  f"{exp['name']} labels")
            check(bool(np.isfinite(fs_exp.features).all()), f"{exp['name']} features are not finite")
            err_exp = 0.0
            for j in (0, rows // 2, rows - 1):
                yj, _ = load_audio(audio_dir / fs_exp.metadata[j]["filename"], sr=sr_exp)
                gj = gold_fn(yj)
                d = np.abs(fs_exp.features[j] - gj)
                err_exp = max(err_exp, float((d / np.maximum(np.abs(gj), 1.0)).max() if exp["extractor"] == "audio_classical"
                                             else d.max()))
            launches_exp = shipped_launches[exp["name"]]
            print(f"[4c] shipped config {exp['name']} ({exp['extractor']}, split {exp['split']}): {fs_exp} in "
                  f"{shipped_s[exp['name']]:.2f} s; mel_rfft launches {launches_exp[0] - launches_exp[1]} "
                  f"({launches_exp[2]} float64), dense {launches_exp[1]}; 3 rows vs float64 golden {err_exp:.3e} "
                  f"(tol {tol:g})")
            check(err_exp <= tol, f"{exp['name']} misses its gate against golden")
            mfcc_exp = exp["extractor"] != "audio_mel_spec"
            check(launches_exp[0] >= 1 and launches_exp[1] == 0 and launches_exp[2] == launches_exp[0] * mfcc_exp,
                  f"{exp['name']} launched (all, dense, float64) {launches_exp}: not the FFT mel kernel it should")

        # 4d. this slice's path: the repaired sizes through the extraction CLI, counted by instantiation
        slice_cfg, slice_exps = repaired_sizes_config(fsc22, tmp / "repaired")
        slice_launches: dict[str, dict[str, int]] = {}
        slice_s: dict[str, float] = {}

        def counted_slice(exp, *args, **kwargs):
            mel_kernel.counter.reset()
            t0 = time.perf_counter()
            run_experiment(exp, *args, **kwargs)
            torch.cuda.synchronize()
            slice_s[exp.resolved_name()] = time.perf_counter() - t0
            slice_launches[exp.resolved_name()] = dict(mel_kernel.counter.by_instantiation)

        pipeline._run_experiment = counted_slice
        try:
            pipeline.main(["--config", str(slice_cfg)])
        finally:
            pipeline._run_experiment = run_experiment
        check(sorted(slice_launches) == sorted(e["name"] for e in slice_exps), f"the repaired sizes ran {sorted(slice_launches)}")
        path_launches: dict[str, int] = {}    # by instantiation, over this slice's path
        for exp in slice_exps:
            prm = exp["extractor_params"]
            mfcc_exp = exp["extractor"] == "audio_mfcc_seq"
            shape, gold_fn, sr_exp = (((40, 1 + CLIP22 // MFCC_HOP), golden.mfcc_seq_feature, SR22) if mfcc_exp else
                                      ((N_MELS, 1 + CLIP // HOP), golden.mel_spec_feature, SR))
            fs_exp = pipeline.FeaturePipeline.load(exp["output"])
            rows = split_rows[exp["split"]]
            check(fs_exp.features.shape == (rows, *shape) and bool(np.isfinite(fs_exp.features).all()),
                  f"{exp['name']} FeatureSet shape {fs_exp.features.shape}")
            err_exp = 0.0
            for j in (0, rows // 2, rows - 1):
                yj, _ = load_audio(audio_dir / fs_exp.metadata[j]["filename"], sr=sr_exp)
                err_exp = max(err_exp, float(np.abs(fs_exp.features[j] - gold_fn(yj, n_fft=prm["n_fft"])).max()))
            kernel = mel_kernel.instantiation(mel_kernel.route(prm["n_fft"]).replace("dense", "mel_folded"),
                                              prm["n_fft"], mfcc_exp)
            print(f"[4d] repaired size {exp['name']} ({exp['extractor']}, n_fft {prm['n_fft']}): {fs_exp} in "
                  f"{slice_s[exp['name']]:.2f} s; launches {slice_launches[exp['name']]}; 3 rows vs float64 golden "
                  f"{err_exp:.3e} (tol {FEATURE_TOL:g})")
            check(err_exp <= FEATURE_TOL, f"{exp['name']} misses its gate against golden")
            check(set(slice_launches[exp["name"]]) == {kernel}, f"{exp['name']} did not run {kernel}")
            for k, v in slice_launches[exp["name"]].items():
                path_launches[k] = path_launches.get(k, 0) + v

        # 5. serving
        trainer = CNNTrainer(filters=[16, 64, 64], first_stride=4, second_stride=2, device=dev)
        trainer.initialize((N_MELS, 1 + CLIP // HOP, 1), N_CLASSES, torch.Generator().manual_seed(0))
        bundle = tmp / "model.flax.npz"
        trainer.save(bundle)
        keys = sorted(np.load(bundle).files)
        check("p/Conv_2/kernel" in keys and "p/Dense_1/kernel" in keys, f"bundle keys {keys}")
        served = load_any_model(bundle)
        check(served.device.type == "cuda", "the served model is not on the card")
        cpu_model = load_any_model(bundle, device="cpu")
        X = fs.features[:8]
        logit_err = float(np.abs(served._batched_logits(served._prepare_input(X)) -
                                 cpu_model._batched_logits(cpu_model._prepare_input(X))).max())
        print(f"[5] flagship CNN logits card vs CPU on 8 CLI features: max|d| {logit_err:.3e} (tol {LOGIT_TOL:g}, TF32 off)")
        check(logit_err <= LOGIT_TOL, "CNN logits on the card disagree with the CPU")

        mel_kernel.counter.reset()
        mel_kernel.counter_dense.reset()
        sim = EdgeDeviceSimulator(bundle, class_names, folder, device_id="smoke",
                                  telemetry_dir=tmp / "telemetry", stats_dir=tmp / "stats", seed=0)
        t0 = time.perf_counter()
        sim.run(8)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_launches = mel_kernel.counter.launches
        serve_dense = mel_kernel.counter_dense.launches
        events = [json.loads(ln) for ln in (tmp / "telemetry" / "smoke_telemetry.jsonl").read_text().splitlines()]
        stats = json.loads((tmp / "stats" / "smoke_stats.json").read_text())
        check(len(events) == 8 and stats["total_inferences"] == 8, "telemetry / stats of 8 requests")
        need = {"timestamp", "device_id", "clip", "true_class", "prediction", "confidence", "uploaded"}
        check(all(need <= set(e) and e["prediction"] in class_names and 0 < e["confidence"] <= 1 for e in events),
              "malformed telemetry event")
        conf_err = 0.0
        for e in events:
            yj, _ = load_audio(folder / e["true_class"] / e["clip"], sr=SR)
            cpu_feat = mel_kernel.mel_spec_feature(torch.from_numpy(yj[None])).numpy()
            conf_err = max(conf_err, abs(float(cpu_model.predict_proba(cpu_feat).max()) - e["confidence"]))
        print(f"[5] edge simulator: 8 requests in {serve_s:.3f} s, mel_rfft launches {serve_launches - serve_dense}, "
              f"dense mel_folded launches {serve_dense}, "
              f"avg confidence {stats['avg_confidence']:.4f}; confidence vs all-CPU path max|d| {conf_err:.3e}")
        check(serve_launches == 8 and serve_dense == 0,
              f"the simulator launched the mel kernels {serve_launches} times ({serve_dense} dense) for 8 requests")
        check(conf_err <= 1e-5, "served confidences disagree with the CPU path")

        # 5b. training: the train CLI on the card, then its bundle served
        _, _, _, y_val = train.stratified_train_val_split(np.arange(n_clips), fs.labels, 0.2)
        check(np.bincount(y_val, minlength=N_CLASSES).tolist() == [1] * N_CLASSES,
              "the train CLI's split did not stratify")
        os.environ["MLFLOW_TRACKING_URI"] = str(tmp / "mlruns")
        mel_kernel.counter.reset()
        mel_unfolded.counter.reset()
        t0 = time.perf_counter()
        train.main(["--features", str(tmp / "features"), "--model", "cnn", "--output", str(tmp / "models"),
                    "--experiment", "chip-smoke", "--param", "filters=[16,64,64]", "--param", "first_stride=4",
                    "--param", "second_stride=2", "--param", f"epochs={TRAIN_EPOCHS}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = (mel_kernel.counter.launches, mel_unfolded.counter.launches)
        run_dir = tmp / "models" / "cnn"
        trained = run_dir / MODEL_FILENAME
        info = json.loads((run_dir / "model_info.json").read_text())
        tkeys = set(np.load(trained).files)
        check({"p/Conv_0/kernel", "p/Conv_2/kernel", "p/Dense_0/kernel", "p/Dense_1/kernel", "norm_mean"} <= tkeys,
              f"trained bundle keys {sorted(tkeys)}")
        check(info["val_accuracy"] is not None and np.isfinite(info["val_accuracy"]), "model_info val_accuracy")
        (loss_file,) = (tmp / "mlruns").glob("*/*/metrics/loss")
        epoch_loss = [float(ln.split()[1]) for ln in loss_file.read_text().splitlines()]
        print(f"[5b] train CLI on the card: {TRAIN_EPOCHS} epochs of the flagship CNN on {n_clips - len(y_val)} clips "
              f"in {train_s:.2f} s; epoch loss {' -> '.join(f'{v:.4f}' for v in epoch_loss)}; val_accuracy "
              f"{info['val_accuracy']:.4f}; kernel launches (folded route, unfolded) {train_launches}: "
              "training runs cuDNN/cuBLAS through autograd, no hand kernel")
        os.environ.pop("MLFLOW_TRACKING_URI")
        check(len(epoch_loss) == TRAIN_EPOCHS and all(np.isfinite(epoch_loss)), "epoch losses")
        check(epoch_loss[-1] < epoch_loss[0], "the epoch loss did not fall from the first epoch to the last")

        mel_kernel.counter.reset()
        mel_kernel.counter_dense.reset()
        sim = EdgeDeviceSimulator(trained, class_names, folder, device_id="trained",
                                  telemetry_dir=tmp / "telemetry", stats_dir=tmp / "stats", seed=1)
        sim.run(4)
        torch.cuda.synchronize()
        trained_launches = mel_kernel.counter.launches
        trained_dense = mel_kernel.counter_dense.launches
        events = [json.loads(ln) for ln in (tmp / "telemetry" / "trained_telemetry.jsonl").read_text().splitlines()]
        print(f"[5b] edge simulator on the trained bundle: 4 requests, mel_rfft launches {trained_launches - trained_dense}, "
              f"dense mel_folded launches {trained_dense}, "
              f"predictions {[e['prediction'] for e in events]}")
        check(len(events) == 4 and all(e["prediction"] in class_names for e in events), "served trained bundle")
        check(trained_launches == 4 and trained_dense == 0,
              f"the simulator launched the mel kernels {trained_launches} times ({trained_dense} dense) for 4 requests")

        X_step, y_step = fs.features[:32], fs.labels[:32]
        # From phase 5's seeded bundle, not the trained one: training on the card does not repeat from run to
        # run, and a ReLU or max-pool near-tie in one run's weights can go the other way on the CPU (once
        # 9.2e-5 of the 1e-4 limit on an H100).
        loss_gpu, loss_cpu, loss_rel, grad_rel, grad_worst, n_grads = grad_gap(dev, X_step, y_step, bundle)
        print(f"[5b] one train step (B=32, dropout 0) card vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f} "
              f"(rel {loss_rel:.3e}, tol {STEP_LOSS_TOL:g}); gradients max|d|/max|g| {grad_rel:.3e} "
              f"({grad_worst}, the worst of {n_grads} tensors; tol {GRAD_TOL:g}, TF32 off)")
        check(loss_rel <= STEP_LOSS_TOL, "train-step loss on the card disagrees with the CPU")
        check(grad_rel <= GRAD_TOL, "train-step gradients on the card disagree with the CPU")

        # 5c. the five runs of configs/training.yaml through the train CLI on the card, on phase 4c's FeatureSets
        train_cfg, train_runs = training_config_copy(tmp / "shipped", tmp / "runs")
        experiment = json.loads(train_cfg.read_text())["experiment"]
        os.environ["MLFLOW_TRACKING_URI"] = str(tmp / "runs" / "mlruns")
        mel_kernel.counter.reset()
        cwd = os.getcwd()
        os.chdir(tmp / "runs")   # the CLI archives a sweep's config under ./config/experiments
        t0 = time.perf_counter()
        try:
            train.main(["--config", str(train_cfg)])
            torch.cuda.synchronize()
            runs_s = time.perf_counter() - t0
            (svm_rec,) = (r for r in tracking.search_runs(experiment) if r.params["model"] == "svm")
        finally:
            os.chdir(cwd)
            os.environ.pop("MLFLOW_TRACKING_URI")
        shortlist = json.loads((tmp / "runs" / "models" / "shortlist.json").read_text())
        print(f"[5c] the five runs of configs/training.yaml on the card, deep runs {TRAIN_EPOCHS} epochs each, in "
              f"{runs_s:.2f} s; shortlist {[(c['rank'], c['model'], round(c['val_f1_macro'], 4)) for c in shortlist['candidates']]}; "
              f"mel kernel launches {mel_kernel.counter.launches}")
        check(shortlist["n_candidates"] == 5 and sorted(c["model"] for c in shortlist["candidates"]) ==
              ["cnn", "knn", "mlp", "rnn", "svm"], f"the shortlist of the five runs: {shortlist}")
        svm_run = next(r for r in train_runs if r["model"] == "svm")
        cv_metrics = {k: round(v, 4) for k, v in svm_rec.metrics.items() if k.startswith("cv_val_")}
        print(f"[5c] svm run: cv_folds {svm_run['cv_folds']} in the file, {svm_rec.params.get('cv_folds')} used "
              f"(the smallest class has {PER_CLASS - 1} train rows); {cv_metrics}")
        check(svm_rec.params.get("cv_folds") == str(PER_CLASS - 1) and "cv_val_accuracy_mean" in svm_rec.metrics,
              f"the svm run's CV: {svm_rec.params}")
        served_gap = {}
        for run in train_runs:
            Xr = pipeline.FeaturePipeline.load(run["features_dir"]).features
            run_dir = Path(train_cfg.parent / "models" / run["name"])
            info = json.loads((run_dir / "model_info.json").read_text())
            if run["model"] in ("svm", "knn"):
                bundle_path = run_dir / f"{run['model']}.npz"
                card_model = get_model(run["model"]).load(bundle_path)
                cpu_model = get_model(run["model"]).load(bundle_path, device="cpu")
                check(card_model.device.type == "cuda" and card_model.name == run["model"], f"{run['name']} served")
                same = bool((card_model.predict(Xr) == cpu_model.predict(Xr)).all())
                if run["model"] == "svm":
                    dec_card, dec_cpu = (classical_core.svm_decision_np(Xr, m._state, m.device)
                                         for m in (card_model, cpu_model))
                    served_gap[run["name"]] = float(np.abs(dec_card - dec_cpu).max() / np.abs(dec_cpu).max())
                    what = f"decision values max|d|/max|dec| {served_gap[run['name']]:.3e} (tol {DECISION_TOL:g})"
                else:
                    served_gap[run["name"]] = float(np.abs(card_model._predict_counts(Xr) -
                                                           cpu_model._predict_counts(Xr)).max())
                    what = f"neighbour counts max|d| {served_gap[run['name']]:g} (must be 0)"
                print(f"[5c] {run['name']} ({run['model']}, {run['params']}): val_accuracy {info['val_accuracy']:.4f}; "
                      f"served card vs CPU on all {len(Xr)} rows: predictions equal {same}, {what}")
                check(same and served_gap[run["name"]] <= (DECISION_TOL if run["model"] == "svm" else 0.0),
                      f"{run['name']} on the card disagrees with the CPU")
                continue
            run_bundle = run_dir / MODEL_FILENAME
            card_model, cpu_model = load_any_model(run_bundle), load_any_model(run_bundle, device="cpu")
            check(card_model.device.type == "cuda" and card_model.name == run["model"], f"{run['name']} served")
            Xr = Xr[:8]
            served_gap[run["name"]] = float(np.abs(card_model._batched_logits(card_model._prepare_input(Xr)) -
                                                   cpu_model._batched_logits(cpu_model._prepare_input(Xr))).max())
            print(f"[5c] {run['name']} ({run['model']}, {run['params']}): val_accuracy {info['val_accuracy']:.4f}; "
                  f"served logits card vs CPU on 8 rows max|d| {served_gap[run['name']]:.3e} (tol {LOGIT_TOL:g})")
            check(served_gap[run["name"]] <= LOGIT_TOL, f"{run['name']} logits on the card disagree with the CPU")
        for model, params, fs_dir in (("mlp", {"hidden_units": [256, 128]}, "fsc22_classical_train"),
                                      ("rnn", {"units": 128}, "fsc22_mfcc_seq_train")):
            fs_run = pipeline.FeaturePipeline.load(tmp / "shipped" / fs_dir)
            seeded = get_model(model)(**params, device=dev)
            seeded.initialize(seeded._prepare_input(fs_run.features[:1]).shape[1:], N_CLASSES,
                              torch.Generator().manual_seed(0))
            seeded.save(tmp / f"{model}_seeded.npz")
            loss_gpu, loss_cpu, loss_rel, grad_rel, grad_worst, n_grads = grad_gap(
                dev, fs_run.features[:32], fs_run.labels[:32], tmp / f"{model}_seeded.npz", model, params)
            print(f"[5c] one {model} train step ({params}, B=32, dropout 0) card vs CPU: loss {loss_gpu:.6f} vs "
                  f"{loss_cpu:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_TOL:g}); gradients max|d|/max|g| "
                  f"{grad_rel:.3e} ({grad_worst}, the worst of {n_grads} tensors; tol {GRAD_TOL:g}, TF32 off)")
            check(loss_rel <= STEP_LOSS_TOL, f"the {model} train-step loss on the card disagrees with the CPU")
            check(grad_rel <= GRAD_TOL, f"the {model} train-step gradients on the card disagree with the CPU")

        # 5f. the post-training stages on 5c's runs: select, optimize, select --post-opt, deploy
        t5f = phase_5f(dev, tmp / "runs", experiment, tree[0])

    # 5d. the classical core on the card against the CPU at fsc22 scale, with TF32 allowed everywhere
    X_fit, y_fit, X_q, y_q = fsc22_classical(np.random.default_rng(22))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        on_card = classical_core_run(dev, X_fit, y_fit, X_q)
        card_s = time.perf_counter() - t0
        flags_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    t0 = time.perf_counter()
    on_cpu = classical_core_run(torch.device("cpu"), X_fit, y_fit, X_q)
    cpu_s = time.perf_counter() - t0
    check(flags_after == (True, True), "the classical core changed the caller's TF32 flags")

    def gap(key: str, scale=None) -> float:
        return float(np.abs(on_card[key] - on_cpu[key]).max() / (np.abs(on_cpu[key]).max() if scale is None else scale))

    dec_train = np.abs(on_cpu["f"] + on_cpu["b"][:, None]).max()
    within = X_fit - np.stack([X_fit[y_fit == k].mean(0) for k in range(N_CLASSES)])[y_fit]
    sw_ev = np.linalg.eigvalsh(within.T.astype(np.float64) @ within / (len(X_fit) - N_CLASSES))
    sw_edge = sw_ev[0] / (CLASSICAL_DIM * np.finfo(np.float32).eps * sw_ev[-1])   # smallest over the rank cutoff
    gaps5d = {   # label -> (gap, tol)
        "svm alpha / max(u)": (gap("alpha", on_cpu["u"].max()), SVM_TOL),
        "svm b / max|f + b|": (gap("b", dec_train), SVM_TOL),
        "svm training decisions f + b / max|f + b|": (
            float(np.abs((on_card["f"] + on_card["b"][:, None]) - (on_cpu["f"] + on_cpu["b"][:, None])).max() / dec_train),
            SVM_TOL),
        "svm decision values on the query rows / max|dec|": (gap("dec"), SVM_TOL),
        "Platt A, relative": (gap("platt_a"), PLATT_TOL),
        "Platt B, relative": (gap("platt_b"), PLATT_TOL),
        "LDA coef / max|coef|": (gap("lda"), LDA_TOL),
        f"PCA projector ({PCA_COMPONENTS} components) / max": (gap("pca"), PCA_TOL),
        f"kNN counts (k {KNN_K}), max|d|": (gap("knn", 1.0), 0.0),
        f"k-means centres (k {N_CLASSES}, 10 restarts) / max|centre|": (gap("centres"), KMEANS_TOL),
        "k-means inertia, relative": (gap("inertia"), INERTIA_TOL),
    }
    print(f"[5d] classical core at fsc22 scale ({len(X_fit)} fit rows x {CLASSICAL_DIM}, {N_CLASSES} classes, "
          f"{len(X_q)} query rows; svm C {SVM_C:g}, gamma scale, {SVM_ITERS} iterations, P {on_cpu['alpha'].shape[0]}, "
          f"M {on_cpu['alpha'].shape[1]}), card with both TF32 flags on ({card_s:.2f} s) vs CPU ({cpu_s:.2f} s): "
          + "; ".join(f"{k} {g:.3e} (tol {t:g})" for k, (g, t) in gaps5d.items())
          + f"; svm predictions on the query rows equal {bool((on_card['pred'] == on_cpu['pred']).all())}, "
          f"accuracy {float((on_card['pred'] == y_q).mean()):.4f}; the LDA's within-class scatter: condition number "
          f"{sw_ev[-1] / sw_ev[0]:.1f}, smallest eigenvalue {sw_edge:.1f}x the rank cutoff")
    for label, (g, tol) in gaps5d.items():
        check(g <= tol, f"5d: {label} on the card disagrees with the CPU: {g:.3e}")
    check(bool((on_card["pred"] == on_cpu["pred"]).all()), "5d: svm predictions on the card disagree with the CPU")

    t5e = phase_5e(dev)

    # 6. timing at B=512 five-second clips
    batch = 512
    waves = torch.from_numpy(np.tile(synth_clips(rng, 8), (batch // 8, 1))).to(dev)

    def in_turns(*fns, timer=cuda_ms) -> tuple[list[float], list[list[float]]]:
        """Each fn's ms by ``timer``, timed in turns forth and back (a, b, c,
        c, b, a): (the mean of each fn's two turns, the turns)."""
        turns: list[list[float]] = [[] for _ in fns]
        for i in [*range(len(fns)), *reversed(range(len(fns)))]:
            turns[i].append(timer(fns[i]))
        return [sum(t) / len(t) for t in turns], turns

    def dense_folded(n_fft):
        consts = mel_kernel.constants(SR, n_fft, N_MELS, dev)
        return lambda: mel_kernel.launch_dense(waves, consts, n_fft, HOP)

    def dense_unfolded(n_fft):
        consts = mel_unfolded.constants(SR, n_fft, N_MELS, dev)
        return lambda: mel_unfolded.launch_dense(waves, consts, n_fft, HOP)

    (ms_kernel, ms_dense), turns = in_turns(lambda: mel_kernel.mel_power_folded(waves), dense_folded(N_FFT))
    (ms_unf, ms_unf_dense), turns_unf = in_turns(lambda: mel_unfolded.mel_power_unfolded(waves), dense_unfolded(N_FFT))
    (ms_400, ms_400_folded, ms_400_unfolded), turns_400 = in_turns(
        lambda: mel_kernel.launch_rfft(waves, SR, N_MELS, 400, HOP), dense_folded(400), dense_unfolded(400))
    ms_plain = cuda_ms(lambda: mel_kernel.mel_power_folded_plain(waves))
    ms_unf_plain = cuda_ms(lambda: mel_unfolded.mel_power_unfolded_plain(waves))
    mel_nonzeros = int(np.count_nonzero(golden.mel_filterbank(SR, N_FFT, N_MELS)))
    bound_ms, bound_by, fft_ms, dense_ms, unf_dense_ms = mel_folded_bound(batch, CLIP, N_FFT, mel_nonzeros)
    nonzeros_400 = int(np.count_nonzero(golden.mel_filterbank(SR, 400, N_MELS)))
    bound_400, bound_by_400, fft_400, dense_400, unf_dense_400 = mel_folded_bound(batch, CLIP, 400, nonzeros_400)
    module, forward = flagship()
    module.to(dev)
    params = dict(served._net.state_dict())
    with torch.inference_mode():
        ms_e2e = cuda_ms(lambda: forward(params, waves), iters=10)
        mel = mel_kernel.mel_power_folded(waves).transpose(1, 2)
        ms_epilogue = cuda_ms(lambda: dsp.mel_epilogue(mel, None, HOP))
        x = dsp.mel_epilogue(mel, None, HOP).transpose(1, 2)[..., None]
        ms_cnn = cuda_ms(lambda: module(x), iters=10)

    def share(ms: float, bound: float) -> str:
        return f"{100 * bound / ms:.2f} % of the bound"

    print(f"[6] bound at B={batch} x 5 s, hop {HOP}, {N_MELS} mels: n_fft {N_FFT} {bound_ms:.4f} ms ({bound_by}; "
          f"least operations at the float32 peak: FFT {fft_ms:.4f} ms with {mel_nonzeros} mel nonzeros, dense "
          f"folded DFT {dense_ms:.3f} ms, dense unfolded DFT {unf_dense_ms:.3f} ms); n_fft 400 {bound_400:.4f} ms "
          f"({bound_by_400}; FFT {fft_400:.4f} ms with {nonzeros_400} mel nonzeros, dense folded {dense_400:.3f} ms, "
          f"dense unfolded {unf_dense_400:.3f} ms) on {card}")
    print(f"[6] n_fft {N_FFT}, mel_power_folded: mel_rfft {ms_kernel:.3f} ms ({ms_turns(turns[0])}), "
          f"{share(ms_kernel, bound_ms)}; dense mel_folded {ms_dense:.3f} ms ({ms_turns(turns[1])}), "
          f"{share(ms_dense, bound_ms)}, {100 * dense_ms / ms_dense:.1f} % of its formulation's peak; "
          f"mel_rfft is {ms_dense / ms_kernel:.1f}x faster; plain version {ms_plain:.3f} ms on {card}")
    print(f"[6] n_fft {N_FFT}, mel_power_unfolded: mel_rfft {ms_unf:.3f} ms ({ms_turns(turns_unf[0])}), "
          f"{share(ms_unf, bound_ms)}; dense mel_unfolded {ms_unf_dense:.3f} ms ({ms_turns(turns_unf[1])}), "
          f"{share(ms_unf_dense, bound_ms)}, {100 * unf_dense_ms / ms_unf_dense:.1f} % of its formulation's peak; "
          f"mel_rfft is {ms_unf_dense / ms_unf:.1f}x faster; plain version {ms_unf_plain:.3f} ms on {card}")
    print(f"[6] n_fft 400: mel_rfft {ms_400:.3f} ms ({ms_turns(turns_400[0])}), {share(ms_400, bound_400)}; "
          f"dense mel_folded {ms_400_folded:.3f} ms ({ms_turns(turns_400[1])}), {share(ms_400_folded, bound_400)}; "
          f"dense mel_unfolded {ms_400_unfolded:.3f} ms ({ms_turns(turns_400[2])}), "
          f"{share(ms_400_unfolded, bound_400)} on {card}")
    print(f"[6] waveform -> mel -> CNN at B={batch}: {ms_e2e:.3f} ms, {batch / ms_e2e * 1e3:.0f} clips/s on {card}")
    print(f"[6] stages alone at B={batch}: dB + min-max epilogue {ms_epilogue:.3f} ms, CNN forward {ms_cnn:.3f} ms on {card}")
    step_ms = {}
    for b in (32, 512):
        tr = CNNTrainer(filters=[16, 64, 64], first_stride=4, second_stride=2, batch_size=b, device=dev)
        Xb = np.random.default_rng(b).random((b, N_MELS, 1 + CLIP // HOP, 1), dtype=np.float32)
        tr.prepare_fit(Xb, N_CLASSES)
        tr._net.train()
        opt = torch.optim.Adam(tr._net.parameters(), lr=1e-3)
        X_d = torch.from_numpy(Xb).to(dev)
        y_d = torch.from_numpy(np.arange(b) % N_CLASSES).to(dev)
        idx, w = torch.arange(b, device=dev), torch.ones(b, device=dev)
        step_ms[b] = cuda_ms(lambda: tr.train_step(opt, X_d, y_d, idx, w), iters=20)
        print(f"[6] train step (forward + backward + Adam, dropout 0.3) of the flagship CNN at B={b}: "
              f"{step_ms[b]:.3f} ms, {b / step_ms[b] * 1e3:.0f} clips/s on {card}")
    for model, params, shape in (("mlp", {"hidden_units": [256, 128]}, (302,)),
                                 ("rnn", {"units": 128}, (40, 1 + CLIP22 // MFCC_HOP))):
        for b in (32, 512):
            tr = get_model(model)(**params, batch_size=b, device=dev)
            Xb = np.random.default_rng(b).standard_normal((b, *shape)).astype(np.float32)
            tr.prepare_fit(Xb, N_CLASSES)
            tr._net.train()
            opt = torch.optim.Adam([p for p in tr._net.parameters() if p.requires_grad], lr=1e-3)
            X_d = torch.from_numpy(Xb).to(dev)
            y_d = torch.from_numpy(np.arange(b) % N_CLASSES).to(dev)
            idx, w = torch.arange(b, device=dev), torch.ones(b, device=dev)
            step_ms[f"{model} B={b}"] = cuda_ms(lambda: tr.train_step(opt, X_d, y_d, idx, w), iters=20)
            print(f"[6] train step (forward + backward + Adam, dropout 0.3) of the {model} {params} on {shape} "
                  f"inputs at B={b}: {step_ms[f'{model} B={b}']:.3f} ms, "
                  f"{b / step_ms[f'{model} B={b}'] * 1e3:.0f} clips/s on {card}")

    # MFCC front end and the 22.05 kHz features at B=512 five-second clips
    waves22 = torch.from_numpy(np.tile(synth_clips(rng, 8, CLIP22, SR22), (batch // 8, 1))).to(dev)

    # classical_feature_vector's groups after its magnitude STFT S, but for the MFCC block and its deltas
    groups = {
        "centroid": lambda S: dsp.spectral_centroid_from_mag(S, SR22, MFCC_N_FFT),
        "rolloff": lambda S: dsp.spectral_rolloff_from_mag(S, SR22, MFCC_N_FFT),
        "bandwidth": lambda S: dsp.spectral_bandwidth_from_mag(S, SR22, MFCC_N_FFT),
        "contrast": lambda S: dsp.spectral_contrast_from_mag(S, SR22, MFCC_N_FFT),
        "flatness": dsp.spectral_flatness_from_mag,
        "chroma+tonnetz": lambda S: dsp.tonnetz_from_chroma(dsp.chroma_from_power(S * S, SR22, MFCC_N_FFT)),
        "zcr": lambda S: dsp.zero_crossing_rate(waves22, hop_length=MFCC_HOP),
        "rms": lambda S: dsp.rms(waves22, MFCC_N_FFT, MFCC_HOP),
    }

    def spectral_groups(S):
        return [fn(S) for fn in groups.values()]

    with torch.inference_mode():
        (ms_mfcc_kernel, ms_mfcc_f64), turns_mfcc = in_turns(
            lambda: mel_kernel.mel_power_folded(waves22, SR22, MFCC_MELS, MFCC_N_FFT, MFCC_HOP),
            lambda: mel_kernel.mel_power_folded(waves22, SR22, MFCC_MELS, MFCC_N_FFT, MFCC_HOP, precise=True))
        ms_mfcc_plain = cuda_ms(lambda: mel_kernel.mel_power_folded_plain(waves22, SR22, MFCC_MELS, MFCC_N_FFT,
                                                                          MFCC_HOP), iters=5)
        ms_mfcc_seq = cuda_ms(lambda: audio_features.mfcc_seq_feature(waves22), iters=10)
        ms_classical = cuda_ms(lambda: audio_features.classical_feature_vector(waves22), iters=5)
        ms_mfcc_block = cuda_ms(lambda: audio_features.mfcc(waves22, SR22, 40, MFCC_N_FFT, MFCC_HOP), iters=10)
        ms_mag_stft = cuda_ms(lambda: dsp.stft_spectrum(waves22, MFCC_N_FFT, MFCC_HOP, power=1.0), iters=5)
        Smag = dsp.stft_spectrum(waves22, MFCC_N_FFT, MFCC_HOP, power=1.0)
        ms_groups = cuda_ms(lambda: spectral_groups(Smag), iters=5)
        ms_group = {k: cuda_ms(lambda fn=fn: fn(Smag), iters=5) for k, fn in groups.items()}
        M40 = audio_features.mfcc(waves22, SR22, 40, MFCC_N_FFT, MFCC_HOP)
        ms_group["deltas"] = cuda_ms(lambda: (dsp.delta(M40, order=1), dsp.delta(M40, order=2)), iters=5)
        del Smag, M40
    nonzeros_mfcc = int(np.count_nonzero(golden.mel_filterbank(SR22, MFCC_N_FFT, MFCC_MELS)))
    bound_mfcc, bound_by_mfcc, fft_mfcc, dense_mfcc, _ = mel_folded_bound(batch, CLIP22, MFCC_N_FFT, nonzeros_mfcc,
                                                                         MFCC_HOP, MFCC_MELS)
    bound_f64, bound_by_f64, fft_f64, _, _ = mel_folded_bound(batch, CLIP22, MFCC_N_FFT, nonzeros_mfcc, MFCC_HOP,
                                                             MFCC_MELS, F64_PEAK)
    print(f"[6] MFCC front end at B={batch} x 5 s, 22.05 kHz, n_fft {MFCC_N_FFT}, hop {MFCC_HOP}, {MFCC_MELS} mels: "
          f"mel_rfft float32 {ms_mfcc_kernel:.3f} ms ({ms_turns(turns_mfcc[0])}), {share(ms_mfcc_kernel, bound_mfcc)} "
          f"{bound_mfcc:.4f} ms ({bound_by_mfcc}; FFT least operations {fft_mfcc:.4f} ms at the float32 peak with "
          f"{nonzeros_mfcc} mel nonzeros, dense folded DFT {dense_mfcc:.3f} ms); mel_rfft float64 (what the MFCC "
          f"features launch) {ms_mfcc_f64:.3f} ms ({ms_turns(turns_mfcc[1])}), {share(ms_mfcc_f64, bound_f64)} "
          f"{bound_f64:.4f} ms ({bound_by_f64}; its least operations {fft_f64:.4f} ms at the float64 peak); "
          f"plain version {ms_mfcc_plain:.3f} ms on {card}")
    print(f"[6] 22.05 kHz features at B={batch} x 5 s: mfcc_seq_feature {ms_mfcc_seq:.3f} ms, "
          f"{batch / ms_mfcc_seq * 1e3:.0f} clips/s; classical_feature_vector {ms_classical:.3f} ms, "
          f"{batch / ms_classical * 1e3:.0f} clips/s; alone: its MFCC block (mfcc) {ms_mfcc_block:.3f} ms, its "
          f"magnitude STFT {ms_mag_stft:.3f} ms, its spectral groups, zcr and rms {ms_groups:.3f} ms "
          f"({', '.join(f'{k} {v:.3f}' for k, v in ms_group.items())} ms) on {card}")
    # the four-pass plans and the dense routes at B=512 five-second clips, beside their bounds and plain versions
    timed = {}   # instantiation -> (ms, plain ms, bound ms, bound_by, shape)
    with torch.inference_mode():
        for key, entry, w, sr, n_fft, hop, n_mels, precise in (
                ("mel_rfft<240, float>", "mel_power_folded", waves, SR, 480, HOP, N_MELS, False),
                ("mel_rfft<240, double>", "mel_power_folded", waves, SR, 480, HOP, N_MELS, True),
                ("mel_rfft<1024, float>", "mel_power_folded", waves22, SR22, 2048, MFCC_HOP, MFCC_MELS, False),
                ("mel_rfft<1024, double>", "mel_power_folded", waves22, SR22, 2048, MFCC_HOP, MFCC_MELS, True),
                ("mel_folded<float>", "mel_power_folded", waves, SR, DENSE_N_FFT, HOP, N_MELS, False),
                ("mel_folded<double>", "mel_power_folded", waves22, SR22, DENSE_N_FFT_22, MFCC_HOP, MFCC_MELS, True),
                ("mel_unfolded<float>", "mel_power_unfolded", waves, SR, DENSE_N_FFT, HOP, N_MELS, False)):
            module, plain_fn, _ = entries[entry]
            kw = {"precise": True} if precise else {}
            dense = module.route(n_fft) == "dense"
            ms = cuda_ms(lambda: getattr(module, entry)(w, sr, n_mels, n_fft, hop, **kw), iters=5 if dense else 20)
            ms_p = cuda_ms(lambda: plain_fn(w, sr, n_mels, n_fft, hop), iters=3, warmup=1)
            nonzeros = int(np.count_nonzero(golden.mel_filterbank(sr, n_fft, n_mels)))
            bound, bound_by_k, *_ = mel_folded_bound(batch, w.shape[1], n_fft, nonzeros, hop, n_mels,
                                                     F64_PEAK if precise else F32_PEAK)
            shape = f"B={batch} x 5 s at {sr / 1000:g} kHz, n_fft {n_fft}, hop {hop}, {n_mels} mels"
            timed[key] = (ms, ms_p, bound, bound_by_k, shape)
            print(f"[6] {key} ({entry}) at {shape}: {ms:.3f} ms, {share(ms, bound)} {bound:.4f} ms ({bound_by_k}); "
                  f"plain version {ms_p:.3f} ms on {card}")
    # the classical core at 5d's fsc22 scale: host clock around calls that end on the host or synchronise
    gamma_v, _, idx, ypm, u = classical_core.svm_problem(X_fit, y_fit, N_CLASSES, SVM_C)
    solver_args = [torch.from_numpy(a).to(dev) for a in (X_fit, idx.astype(np.int64), ypm, u)]

    def solve(capture: bool, iters: int = SVM_ITERS):
        out = classical_core.svm_fit(*solver_args, gamma_v, "rbf", iters, capture=capture)
        torch.cuda.synchronize()
        return out

    eager_out = [t.cpu() for t in solve(False)]
    captured_out = [t.cpu() for t in solve(True)]
    check(all(torch.equal(a, b) for a, b in zip(eager_out, captured_out)),
          "the captured APG loop does not give what the eager loop gives, bit for bit")
    (ms_svm_eager, ms_svm_captured), svm_turns = in_turns(lambda: solve(False), lambda: solve(True),
                                                          timer=lambda fn: host_ms(fn, reps=1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof1:
        solve(False, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof2:
        solve(False, 2)

    def n_kernels(prof) -> int:
        return sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)

    per_step = n_kernels(prof2) - n_kernels(prof1)
    svm_trainer = get_model("svm")(C=SVM_C, iters=SVM_ITERS, device=dev)
    svm_trainer._fit_body(X_fit, y_fit, N_CLASSES)
    knn_trainer = get_model("knn")(n_neighbors=KNN_K, device=dev)
    knn_trainer._fit_body(X_fit, y_fit, N_CLASSES)
    classical_ms = {
        "svm fit (fit_svm_np: layout, captured solve, Platt, support vectors)":
            host_ms(lambda: classical_core.fit_svm_np(X_fit, y_fit, N_CLASSES, C=SVM_C, iters=SVM_ITERS, device=dev)),
        f"svm predict on {len(X_q)} rows": host_ms(lambda: svm_trainer.predict(X_q), reps=10),
        f"svm predict_proba on {len(X_q)} rows": host_ms(lambda: svm_trainer.predict_proba(X_q), reps=10),
        f"kNN predict (k {KNN_K}) on {len(X_q)} rows": host_ms(lambda: knn_trainer.predict(X_q), reps=10),
        "LDA fit": host_ms(lambda: classical_core.fit_lda_np(X_fit, y_fit, N_CLASSES, dev)),
        f"pca_svm fit ({PCA_COMPONENTS} components, {SVM_ITERS} iterations)":
            host_ms(lambda: get_model("pca_svm")(n_components=PCA_COMPONENTS, C=SVM_C, iters=SVM_ITERS,
                                                 device=dev)._fit_body(X_fit, y_fit, N_CLASSES)),
        f"k-means fit (k {N_CLASSES}, 10 restarts, 100 steps)":
            host_ms(lambda: get_model("kmeans")(device=dev)._lloyd(X_fit, N_CLASSES)),
    }
    print(f"[6] svm solve (svm_fit) at fsc22 scale ({len(X_fit)} x {CLASSICAL_DIM}, P {idx.shape[0]}, M {idx.shape[1]}, "
          f"C {SVM_C:g}, {SVM_ITERS} iterations): eager {ms_svm_eager:.1f} ms ({ms_turns(svm_turns[0])}), captured in a "
          f"CUDA graph {ms_svm_captured:.1f} ms ({ms_turns(svm_turns[1])}), {ms_svm_eager / ms_svm_captured:.2f}x; "
          f"the two equal bit for bit; an APG step launches "
          f"{per_step if per_step > 0 else 'not measured (the profiler saw no kernels)'} kernels eager and one "
          f"graph captured on {card}")
    print(f"[6] classical at fsc22 scale on {card}: " + "; ".join(f"{k} {v:.2f} ms" for k, v in classical_ms.items()))
    check(all(np.isfinite([ms_svm_eager, ms_svm_captured, *classical_ms.values()])), "classical timing")

    tuning_times(t5e, card, in_turns)
    deploy_times(t5f, card)

    check(all(np.isfinite([ms_kernel, ms_dense, ms_plain, ms_unf, ms_unf_dense, ms_unf_plain, ms_400, ms_400_folded,
                            ms_400_unfolded, ms_e2e, ms_epilogue, ms_cnn, *step_ms.values(), ms_mfcc_kernel, ms_mfcc_f64,
                            ms_mfcc_plain, ms_mfcc_seq, ms_classical, ms_mfcc_block, ms_mag_stft, ms_groups,
                            *(t for v in timed.values() for t in v[:3])])), "timing")
    path_launches["mel_unfolded<float>"] = unfolded_dense_launches.get("mel_unfolded<float>", 0)
    check(all(path_launches.get(key, 0) >= 1 for key in timed),
          f"a kernel of this slice's path was not launched there: {path_launches}")

    # 7. results
    print(json.dumps({"kernels": [{
        "name": "mel_folded", "route": "cuda", "source": "audio_edge_ml_pipeline_torch/csrc/mel_rfft.cu",
        "replaces": "audio_edge_ml_pipeline_tpu/ops/pallas_mel.py:119",
        "launches": (extract_launches + shipped_f32 + serve_launches + trained_launches + t5e["mel_launches"]
                     + t5f["mel_launches"]),
        "max_abs_err": worst_abs,
        "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "plain_products": "float64", "dense_ms": ms_dense,
        "dense_source": "audio_edge_ml_pipeline_torch/csrc/mel_folded.cu",
    }, {
        "name": "mel_folded_f64", "route": "cuda", "source": "audio_edge_ml_pipeline_torch/csrc/mel_rfft.cu",
        "replaces": "audio_edge_ml_pipeline_tpu/ops/pallas_mel.py:119",
        "launches": shipped_f64, "max_abs_err": worst_abs_f64,
        "ms": ms_mfcc_f64, "plain_ms": ms_mfcc_plain, "bound_ms": bound_f64, "bound_by": bound_by_f64,
        "library_ms": None, "plain_products": "float64",
        "shape": f"B={batch} x 5 s at 22.05 kHz, n_fft {MFCC_N_FFT}, hop {MFCC_HOP}, {MFCC_MELS} mels",
    }, {
        "name": "mel_unfolded", "route": "cuda", "source": "audio_edge_ml_pipeline_torch/csrc/mel_rfft.cu",
        "replaces": "audio_edge_ml_pipeline_tpu/ops/pallas_mel.py:35",
        "launches": unfolded_launches, "max_abs_err": worst_abs_unfolded,
        "ms": ms_unf, "plain_ms": ms_unf_plain, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "plain_products": "float32", "dense_ms": ms_unf_dense, "dense_source": "audio_edge_ml_pipeline_torch/csrc/mel_unfolded.cu",
    }, *({
        "name": key, "route": "cuda",
        "source": f"audio_edge_ml_pipeline_torch/csrc/{'mel_rfft' if key.startswith('mel_rfft') else key.split('<')[0]}.cu",
        "replaces": f"audio_edge_ml_pipeline_tpu/ops/pallas_mel.py:{35 if key.startswith('mel_unfolded') else 119}",
        "launches": path_launches[key], "max_abs_err": errs_by_instantiation[key], "ms": ms, "plain_ms": ms_p,
        "bound_ms": bound, "bound_by": by, "library_ms": None, "shape": shape,
    } for key, (ms, ms_p, bound, by, shape) in timed.items())]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
