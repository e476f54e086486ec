#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (audio_edge_ml_pipeline_torch).

Drives the port's main path on one CUDA card, through the entry points a
user calls, and checks each phase; any failed check ends the run with a
non-zero exit code. Builds the hand-written kernels from csrc/ itself.

  1. the card's name and power limit (nvidia-smi);
  2. build every kernel (one nvcc per source) and the native WAV reader
     (``csrc/wavio.cpp``, g++), all at once;
  3. each kernel against its plain PyTorch version on the card, through
     both entries, ``mel_power_folded`` and ``mel_power_unfolded``, with the
     launches of each route and template instantiation counted: the FFT mel
     kernel at n_fft 512 (two shapes), 1024 / 512 / 128 mels at 22.05 kHz
     and n_fft 320, 400 and 640 (folded) or 400 (unfolded); its four-pass
     plans (n_fft 480 and 2048) through both entries and in float64; each
     entry's off-plan route, ``mel_czt`` (chirp-z at n_fft 482, direct at
     4096), one launch each; the float64 instantiations (``precise=True``)
     of ``mel_rfft`` at n_fft 1024, 512, 400, 480 and 2048 (also at hop
     1024, where its tiles shrink) and of ``mel_czt`` at 482, 2050 and
     4096, also per bin; no dense launch anywhere; a sweep of even n_fft
     (SWEEP_N_FFT) in both precisions against the plain version, then every
     even n_fft from 4 to 4096 off the compiled plans through both entries
     and in float64 against a float64 DFT reference, each of which
     must launch ``mel_czt`` once; the unfolded entry's refusal of odd n_fft;
     and the mel feature against the float64 golden copy;
  3c. the MFCC and classical features on the card (``mfcc_seq_feature``,
     raw ``mfcc``, ``classical_feature_vector``, ``waveform_feature``) on 4
     five-second clips at 22.05 kHz against the float64 golden copy, with
     both TF32 flags on (the DSP must pin its own precision), at n_fft 1024
     and, for the MFCC sequence and the classical vector, at 2048 (the FFT
     route) and 2050 (``mel_czt``'s float64 route); each MFCC call must launch
     the mel kernel of its route once, in float64; and ``mel_spec_feature``
     at n_fft 511 (no fold, no kernel) and 2048 against golden;
  4. the feature-extraction CLI on a 27-class x 5-clip fsc22-style WAV tree
     (5 s, 16 kHz), which must launch the FFT mel kernel and neither
     ``mel_czt`` nor a dense one, and the FFT kernel's mel power on the
     tree's clips against the float64 golden mel power; then the unfolded
     kernel's entry point (``mel_power_unfolded``, which no CLI calls, as no
     JAX path calls ``mel_power_pallas``) on the same clips, which must
     launch the FFT kernel, against the same, and at n_fft 482
     ``mel_czt<float>`` and no dense kernel;
  4c. the shipped ``configs/feature_extraction.yaml`` through the extraction
     CLI on the same tree (its own splits, train and validation; its
     dataset and outputs moved to the temporary directory): all four
     experiments, each FeatureSet's shape and labels, 3 rows of each
     against golden (the 22.05 kHz features on the clips as ``load_audio``
     resamples them), and each experiment's kernel launches; the native WAV
     reader: available, bit for bit with the numpy codec on the tree's
     clips, None and negative batch lengths for a missing and a truncated
     file;
  4d. the repaired sizes, through the extraction CLI on the same tree (a
     copy of the shipped config's mel and MFCC-sequence experiments at
     n_fft 480, 2048 and 482 / 2050): each experiment must launch the
     template instantiation of its route (``mel_czt<float>`` at 482,
     ``mel_czt<double>`` at 2050) and no dense kernel, and 3 rows against
     golden;
  4e. BIRDeep (the ``birdeep`` loader): a synthetic BIRDeep_AudioAnnotations
     tree (10 recordings of 30 s at 16 kHz; 16 train and 4 validation rows a
     species of the five focal ones and of one that class_filter drops,
     segments of 0.051-5 s; an augmented row and a 0.02 s segment, both
     dropped) through ``configs/experiments/birdeep-feature-extraction.yaml``
     on the card: each FeatureSet against the same config's CPU run and 3
     rows against golden (1e-5; classical 1e-4 relative), the mel_rfft
     launches by instantiation; then ``birdeep-5-classes-train.yaml`` (the
     cnn at 3 epochs) through the train CLI on those sets: lda, pca_svm and
     cnn shortlisted, and random_forest too where scikit-learn is installed
     (else its run fails naming it, as in JAX);
  4f. the augmentation stage through the augment CLI, each run its own
     process: ``configs/augmentation.yaml`` on 27 classes x 3 train clips of
     5 s (a split manifest; one class named Thunderstorm, whose override
     time-stretches), the host backend at workers 1 and 4 byte for byte,
     the device backend on the card with both TF32 flags on against it
     (byte for byte but the 12 Thunderstorm copies, those within 5e-3); a
     copy where every class runs time_stretch then pitch_shift at
     device_batch 64, device vs host within 1e-2 with equal lengths, every
     copy through the batched vocoder and none through the oracle; both
     backends' times and ``time_stretch_batch`` at B=64 x 5 s; then the
     device backend's tree through the extraction CLI (split all):
     originals x 5 rows;
  4g. the AEP_PROFILE_DIR trace at fsc22 scale: the extraction CLI on a
     tree of 27 classes x 75 five-second clips (2025 rows, 8 chunks) and a
     2-epoch run of the flagship CNN on that FeatureSet through the train
     CLI with the variable set; each stage's torch.profiler trace parsed:
     the top kernels by device time with their launches, the device idle
     share over the stage's window and over the steps after the first (the
     extraction also with the numpy codec patched in for the native reader,
     which must have decoded every clip, the same FeatureSet), and
     every train step's host time between kernels (the first, cuDNN's
     set-up, apart); the extraction trace's mel_rfft launches must equal
     the kernel's counter;
  4h. audio_cqt: the extraction CLI on phase 4's tree (split train: 27 x 4
     clips resampled to 22.05 kHz; 84 bins, 12 an octave from C1, n_fft
     16384, hop 512) on the card and on the CPU, card vs CPU within 1e-6
     and 3 rows within 1e-5 of golden; ``cqt_feature`` at B=512 x 5 s
     with its peak memory (under the card's), a clip alone against the
     same clip in the batch (1e-6), and the card's float64 GEMM rate at the
     CQT's shape;
  4i. the image modality: an image_folder tree (4 classes x 16 PNGs) and a
     birdeep_image tree (spectrogram PNGs, the three split CSVs, YOLO
     boxes, an augmented row, a box under min_bbox_area) through the
     extraction CLI with image_classical (128 x 128, 8196 dims),
     image_pixels and image_mobilenet_v2 (224, 1280 dims, a weights .npz the
     port writes from seeded weights) on the card and on the CPU:
     classical within 2e-4 with the LBP and histogram columns bit for bit,
     pixels equal, embeddings within 1e-4 of their largest (TF32 off); the
     train CLI's mlp for 2 epochs on the folder's classical set;
  4j. the video modality: a video_folder tree written with cv2 (3 classes x
     2 MJPG clips of 24 frames) through the extraction CLI with
     video_classical (optical flow on), video_frame_seq and
     video_mobilenet_v2_seq on the card and on the CPU, at the image gates;
  4k. the text modality (no kernel of the port; no mel kernel may launch in
     4k-4l): a seeded corpus shaped like 20 Newsgroups (20 classes x 200
     documents of 80-240 tokens, Zipf(1.1) over 30,000 pseudo-words, class
     topic words) through the extraction CLI on the card and on the CPU:
     text_tfidf (10,000 columns), text_bow and text_bert_tokens on all
     4,000 documents, text_char_ngram (50,000 columns) and the LSA on a
     1,000-document subset, the LSA of all 4,000 (4000 x 20000 -> 384) on
     the card: vocabularies equal, bow and token ids equal, tfidf and char
     rows within 1e-7, LSA rows within 1e-5, the top 10 singular values
     within 1e-6 relative of an exact float64 decomposition (the Gram
     matrix's eigenvalues), the IDF, weighting and SVD on the card; small
     text_folder, text_json and text_csv trees of the same documents give
     one FeatureSet; the train CLI's mlp (2 epochs) on the tfidf set and lda
     on the LSA set, served card vs CPU; the TF-IDF weighting and the LSA
     timed on the card and the CPU;
  4l. the tabular modality: 32,561 seeded rows with UCI Adult's schema
     (6 numeric, 8 categorical columns, 99 categories, missing cells at
     Adult's '?' shares) through the extraction CLI with tabular_classical
     (105 columns) and tabular_polynomial (126), each with the standard,
     minmax and robust scalers, card vs CPU within 1e-6 of each column's
     largest value, the statistics on the card; sqlite and jsonl copies of
     500 rows as the CSV of them; the mlp (2 epochs) served card vs CPU;
     the transform timed at 32,561 rows;
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
  5g. the deep families this slice ported, through the port's train CLI on
     the card: the ds_cnn at the JAX defaults ([32, 32, 64], first stride
     2, avg pool, BatchNorm) on 4c's mel FeatureSet and the transformer (4
     heads, ff 128, 2 blocks) on 4c's MFCC sequences, 3 epochs each: each
     bundle served card vs CPU (logits 1e-4), one train step card vs CPU
     from a seeded bundle at dropout 0 (loss 1e-5, gradients 1e-4, the new
     BatchNorm statistics 1e-5 relative), and the ds_cnn through the deploy
     CLI and gcc (C scores on 2 rows within 1e-4 of the card, same argmax);
     then ``configs/experiments/fsc22-nicla-kd.yaml`` on 5e's fsc22-sized
     mel sets (its class_filter rewritten to 10 synthetic class names): the
     EfficientNet-B0 teacher at the file's image_size 224, batch 16, dropout
     0.3 and lr 1e-3 for 2 + 2 epochs, then the enabled [16, 16, 16] student
     (T 4, alpha 0.7) for 3 epochs. Checks: both runs shortlisted, phase 1
     moved only the head (every backbone tensor and statistic bit for bit),
     phase 2 left every batch_stats leaf bit for bit, the teacher's logits
     card vs CPU on 4 rows within 1e-4 of their largest, the student served
     by the edge simulator (8 requests, one mel_rfft launch each) and
     deployed to C as above, every parameter's Adam moments in the phase
     checkpoints (optax's layout; phase 1's frozen ones zero), and a
     checkpointed teacher run resumed after its first epoch with its epoch
     counter and lr, its step against an uninterrupted run's (loss 1e-5,
     gradients from the moments 1e-4 of each tensor's largest);
  5h. the serving loop with the REST tracking backend: a stdlib stub of the
     MLflow REST surface on 127.0.0.1; the flagship cnn through the train
     CLI on 4c's mel set against it and against a file store (two runs each,
     in turns, cuDNN deterministic, one seed), select against each (the same
     shortlist); the ingestion API on port 0 and 12 edge-simulator requests
     on the REST run's bundle at upload_threshold 1.1 (every one uploaded,
     one WAV and one sidecar each); the uploads relabelled from the
     telemetry, the audio_processor CLI on the card (3 rows vs golden, card
     vs CPU, 1e-5); SpectrogramDataset's labels, the arrays rescored by the
     served bundle (the telemetry's predictions, confidences 1e-5); the
     dashboard's render;
  5i. the compile stage (``compilation/compile_xla.py``) on 5b's bundle at
     --batch 32, plain and with --tune-flags: JAX's report keys; the CUDA
     graph's and each torch.compile candidate's logits within 1e-5 of the
     eager forward; each candidate's latency, compile seconds, the
     allocator's bytes; with 2 or more cards, ``--device cuda:1`` while
     cuda:0 is current, its graph within 1e-5 of eager there and its replay
     launching kernels (the profiler's count); with one card it says so;
  5k. stage 7a and the weight converter: ``to_tflite`` imports, and with
     TensorFlow unimportable its CLI on 5b's bundle and compile_xla
     --tflite on an existing file refuse with an ImportError naming it;
     a seeded torchvision MobileNetV2 state_dict through
     ``tools/convert_backbone_weights.py``, the embedder on the file card
     vs CPU at B=32 x 224 (1e-4); its --prefix backbone --bundle file
     warm-starting the teacher on the card; no mel kernel launched;
  5l. the repository's tools and scripts through the port's ``tools/``
     package, after 5k, each command a user types its own process: the
     README quick start (``make_synth_dataset`` 27 classes x 12 clips of
     5 s in every layout, the mel extraction of train and validation on the
     card, the flagship cnn for 3 epochs, select, optimize, select
     --post-opt, deploy); ``generate_split`` (27 x 8 / 2 / 2, a re-run,
     --seed 7 refused by the drift guard, --force) and the extraction CLI on
     the manifest's test split; ``diagnose_data``, ``diagnose_training``,
     ``verify_training_data``; ``test_model`` card vs CPU (equal predictions,
     printed confidences 1e-5); stage 8, ``evaluate_device`` against a
     loopback device whose answers come from the card (each test clip's
     mel, one mel_rfft launch, scored by the quick start's bundle): its
     metrics and report equal the bundle's own predict on the extracted
     rows, and through its CLI with a file tracking store one out-of-set
     reply counts wrong; ``receive_wav`` and ``record_dataset`` byte for byte
     from int16 PCM frames; a FEAT frame of a train clip's card mel through
     the repository's ``tools/receive_mel.py`` (its own row nearest) and
     ``tools/gen_prototypes.py``; ``load_sample_data`` to the ingestion API
     with requests blocked; ``test_dashboard``.
     ``python3 chip_smoke.py --only 5l`` builds the kernels and runs this
     phase alone;
  5j. the parallel layer (``parallel/mesh.py``), after 5g: the flagship
     CNN and the ds_cnn (JAX's defaults) fitted in float64 with
     data_parallel=2 by two gloo ranks sharing the card, against the same
     fits in one process (losses 1e-5, state 1e-4 of each tensor's
     largest), and the cnn so in float32 beside the float32 fit's own floor
     (its state under a 1e-7 input change; printed, not gated); one
     make_sharded_train_step step of waveform -> mel -> CNN on a 1-card
     NCCL mesh against the plain step (1e-5), both timed at B=32 and 512
     (the DDP wrapper's cost); an extraction batch, a pca_svm CV cell and a
     4-trial cnn group each split in two parts on the card against the
     unsplit call (bit for bit, 1e-4, float64 1e-4), one mel_rfft launch a
     part; the model axis of the ds_cnn, the rnn and the transformer on
     get_mesh(2, model_parallel=2) in float64, two gloo ranks on the card
     (and NCCL over two cards where there are two), against one process
     (loss 1e-5, state 1e-4), each step's time. With 2 or more cards (N = min(4, cards)), through NCCL: the train
     CLI with --param data_parallel=N against the 1-card run,
     fsc22-27-classes-tuning.yaml (cut) through the tune CLI, an
     extraction over the cards and dryrun_multichip(N); with one card it
     says so. ``python3 chip_smoke.py --only 5j`` builds the kernels and
     runs this phase alone (with 2 or more cards also 5i's capture on a
     card that is not current, on a seeded flagship bundle);
  6. timing with CUDA events at B=512 five-second clips (at n_fft 512 each
     entry's FFT route beside its dense kernel, in turns, and the plain
     versions; a yardstick on no path, torch.stft -> abs()**2 -> mel
     matmul; at n_fft 400 the FFT kernel beside both dense kernels, in
     turns; each kernel's share of the bound, which is worked out from this
     run's shapes; the stages and waveform -> mel -> CNN), the epilogue
     kernel (``csrc/mel_epilogue.cu``) at B = 32, 256 and 512 on (40, 501)
     mel power, in turns with the torch-op chain it replaced
     (``dsp.mel_epilogue``), beside its bytes bound, each held to the
     chain at 1e-6 with and without ragged lengths, and the chain's kernel
     launches a call (the profiler's count), one training
     step at B=32 and B=512, and at B=512 five-second clips at 22.05 kHz the
     FFT kernel at the MFCC front end (1024 / 512 / 128 mels) against its
     bound and its plain version, ``mfcc_seq_feature`` and
     ``classical_feature_vector`` with its MFCC block, magnitude STFT and
     spectral groups alone; the four-pass plans in both types (n_fft 480 at
     16 kHz, 2048 at 22.05 kHz) and ``mel_czt`` (n_fft 482 at 16 kHz through
     both entries, 2050 in float64 and 4096 in both types at 22.05 kHz, hop
     512, 128 mels) beside their bounds and plain versions, each in turns
     with the dense kernel it replaced there, launched directly (no route
     reaches those); an mlp and an rnn train step at
     B=32 and B=512; at 5d's fsc22 scale an svm fit eager and captured in a
     CUDA graph (which must give what eager gives, bit for bit), the
     kernels an APG step launches, svm predict and predict_proba on the 284
     rows, a kNN predict, an LDA fit, a pca_svm fit and a k-means fit; at
     5e's sizes one svm CV cell fold-batched and fold by fold, each pca_cv,
     the grid's total in the CLI, and a group of 4 cnn trials for one epoch
     against the 4 trials one at a time; from 5f, each optimize mode's
     latency_ms on the card (the CLI's timed call and a second full call),
     the optimize CLI's wall time a candidate, and codegen and gcc a
     project; a ds_cnn and a transformer train step at B=32 and B=512, a
     teacher step at 224 in phase 1 and phase 2 at B=16 and B=128, a KD
     student step at B=16 and B=512, and the teacher's predict_proba in
     rows/s; from 4f, the augmentation stage's host and device times;
     from 4h, ``cqt_feature`` at B=512 x 5 s beside its float64 bound;
     from 4i, ``classical_image_vector_batch`` at B=256 x 128 x 128 (and
     each descriptor alone) and the MobileNetV2 embedder at B=32 and 256 x
     224;
  7. one JSON line per kernel, the run's total time, then the result line.

Matmuls and cuDNN convolutions run in full float32 throughout (TF32 off),
but for phases 3c and 5d, which turn TF32 on: the features must stay within
1e-5 of the float64 oracle, and the classical core must pin full float32
itself.

Usage: python3 chip_smoke.py [--only 5j | --only 5l | --only mel]
(``--only mel``: phases 1-3, then phase 6's times of the four-pass plans,
of mel_czt beside the dense kernels and of the epilogue kernel, and no
result line.)
"""

from __future__ import annotations

import collections
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
EPILOGUE_TOL = 1e-6                # the epilogue kernel vs the torch-op chain, max|d| of the [0, 1] feature: the
                                   # same float32 steps, but a build may take r2 / 13 as r2 * (1/13): a few ulp
EPILOGUE_BATCHES = (32, 256, 512)  # the score batch, the extraction chunk, this run's timing batch
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
TRACE_EPOCHS = 2                   # the traced cnn run of phase 4g: ~51 steps an epoch at fsc22 scale
CZT_N_FFT = 482                    # M = 241 (prime) has no compiled plan: mel_czt's chirp-z route at 16 kHz
CZT_N_FFT_22 = 2050                # M = 1025 = 5^2 x 41: the chirp-z route at the 22.05 kHz front end
DIRECT_N_FFT_22 = 4096             # M = 2048, 5-smooth but no compiled plan: mel_czt's direct route
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
BN_STAT_TOL = 1e-5                 # a train step's new BatchNorm statistics card vs CPU, over each buffer's largest
F32_GRAD_TOL = {"ds_cnn": 1e-3}    # a float32 step's gradients card vs CPU, and each device's against its float64
                                   # step, per tensor as GRAD_TOL (GRAD_TOL for the other models): through five
                                   # train-mode BatchNorms over 160k values a channel the ds_cnn's sit 1.18e-4
                                   # (CPU) and 2.90e-4 (H100, 700 W) from float64, and 2.90e-4 card vs CPU; 1e-3
                                   # leaves 3x above the larger floor, and a wrong gradient reads O(1)
TEACHER_TOL = 1e-4                 # the teacher's logits card vs CPU, over their largest (80 convolution layers)
KD_CLASSES = 10                    # configs/experiments/fsc22-nicla-kd.yaml's class_filter holds 10 classes
TEACHER_IMAGE = 224                # the file's image_size
TEACHER_WARMUP, TEACHER_EPOCHS, STUDENT_EPOCHS = 2, 4, 3   # cut from 10 of 100 and 100


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


def in_turns(*fns, timer=cuda_ms) -> tuple[list[float], list[list[float]]]:
    """Each fn's ms by ``timer``, timed in turns forth and back (a, b, c,
    c, b, a): (the mean of each fn's two turns, the turns)."""
    turns: list[list[float]] = [[] for _ in fns]
    for i in [*range(len(fns)), *reversed(range(len(fns)))]:
        turns[i].append(timer(fns[i]))
    return [sum(t) / len(t) for t in turns], turns

def share(ms: float, bound: float) -> str:
    return f"{100 * bound / ms:.2f} % of the bound"


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


def dft_mel_reference(y64, sr: int, n_fft: int, hop: int, n_mels: int):
    """(B, T, n_mels) float64 mel power of float64 (B, n) clips on the card:
    the center-padded frames times a Hann-windowed DFT basis built on the
    card (phases k n mod n_fft in integers), power, the float64 slaney bank.
    A reference for the off-plan sweep that needs neither the plain
    version's host-built bases (0.7 s a size at n_fft 4096) nor a cuFFT plan
    a size; on no path."""
    import torch

    from audio_edge_ml_pipeline_torch.ops.golden import librosa_ref

    dev = y64.device
    frames = torch.nn.functional.pad(y64, (n_fft // 2, n_fft // 2)).unfold(1, n_fft, hop)
    n = torch.arange(n_fft, device=dev)
    phase = ((n[:, None] * n[None, : n_fft // 2 + 1]) % n_fft).double() * (2 * np.pi / n_fft)
    window = torch.from_numpy(librosa_ref.hann_periodic(n_fft)).to(dev)[:, None]
    re, im = frames @ (window * torch.cos(phase)), frames @ (window * torch.sin(phase))
    fb = torch.from_numpy(librosa_ref.mel_filterbank(sr, n_fft, n_mels)).to(dev)
    return (re * re + im * im) @ fb.T


def sweep_off_plan(dev, rng: np.random.Generator, mel_kernel, mel_unfolded, errs: dict) -> None:
    """Every even n_fft from 4 to 4096 that mel_rfft has no compiled plan for,
    on 2 one-second clips at 16 kHz (hop 160, 40 mels): the folded entry in
    float32 and float64 and the unfolded one in float32, each of which must
    launch mel_czt<T> once and no dense kernel, held against
    ``dft_mel_reference`` at KERNEL_REL_TOL of each clip's peak (float32) or
    F64_ELEMENT_TOL a bin (float64). Adds each instantiation's max|d| to
    ``errs``."""
    import torch

    from audio_edge_ml_pipeline_torch.ops import czt_plan, rfft_plan

    t0 = time.perf_counter()
    y = torch.from_numpy(synth_clips(rng, 2, SR)).to(dev)
    y64 = y.double()
    calls = (("mel_power_folded", mel_kernel, False), ("mel_power_folded", mel_kernel, True),
             ("mel_power_unfolded", mel_unfolded, False))
    sizes = [n for n in range(4, 4098, 2) if not rfft_plan.supports(n)]
    rel = torch.zeros((len(sizes), len(calls)), dtype=torch.float64, device=dev)
    absd = torch.zeros_like(rel)
    for i, n_fft in enumerate(sizes):
        ref = dft_mel_reference(y64, SR, n_fft, HOP, N_MELS)
        peak = ref.amax(dim=(1, 2), keepdim=True)
        for c, (entry, module, precise) in enumerate(calls):
            for counter in (module.counter, module.counter_czt):
                counter.reset()
            out = getattr(module, entry)(y, SR, N_MELS, n_fft, HOP, **({"precise": True} if precise else {}))
            launched = (dict(module.counter.by_instantiation), module.counter_czt.launches)
            want = {mel_kernel.instantiation("mel_czt", n_fft, precise): 1}
            check(launched == (want, 1), f"sweep: {entry} at n_fft {n_fft} launched (by instantiation, czt) "
                                         f"{launched}, not {want}")
            d = (out.double() - ref).abs()
            absd[i, c] = d.amax()
            rel[i, c] = (d / ref.clamp_min(torch.finfo(torch.float64).tiny)).amax() if precise else (d / peak).amax()
    rel, absd = rel.cpu().numpy(), absd.cpu().numpy()
    modes = collections.Counter(czt_plan.plan(n).mode for n in sizes)
    for c, (entry, _, precise) in enumerate(calls):
        tol = F64_ELEMENT_TOL if precise else KERNEL_REL_TOL
        worst = int(np.argmax(rel[:, c]))
        key = mel_kernel.instantiation("mel_czt", 4, precise)
        errs[key] = max(errs.get(key, 0.0), float(absd[:, c].max()))
        print(f"[3] sweep of every even n_fft from 4 to 4096 off the compiled plans ({len(sizes)} sizes: "
              f"{modes['direct']} direct, {modes['chirp']} chirp-z), {entry}{' precise' if precise else ''} ({key}) "
              f"vs a float64 DFT reference: worst max|d|/{'|ref| per bin' if precise else 'clip peak'} "
              f"{rel[worst, c]:.3e} at n_fft {sizes[worst]} (tol {tol:g}), max|d| {absd[:, c].max():.3e}")
        check(bool(np.isfinite(rel[:, c]).all()) and rel[:, c].max() <= tol,
              f"sweep: {entry}{' precise' if precise else ''} misses its gate at n_fft {sizes[worst]}: {rel[worst, c]:.3e}")
    print(f"[3] the off-plan sweep took {time.perf_counter() - t0:.1f} s, {len(sizes) * len(calls)} launches")


def epilogue_times(dev, card: str, rng: np.random.Generator) -> dict:
    """csrc/mel_epilogue.cu (``mel_kernel.launch_epilogue``) in turns with
    the torch-op chain it replaced (``dsp.mel_epilogue``) on (40, 501) mel
    power of 5 s clips at EPILOGUE_BATCHES, beside its bound: one read and
    one write, 8 x 40 x 501 B a clip, over HBM_RATE. CUDA events over
    back-to-back calls time what a caller waits, host issue included; the
    kernel durations of the profiler's chrome trace (10 calls each) give the
    device time and the chain's launches a call. Each output is held to the chain's at
    EPILOGUE_TOL, without lengths and with ragged ones. Returns the kernel's
    row of the result line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_edge_ml_pipeline_torch.ops import dsp, mel_kernel

    base = torch.from_numpy(synth_clips(rng, 8)).to(dev)
    rows, worst = [], 0.0
    for batch in EPILOGUE_BATCHES:
        mel = mel_kernel.mel_power_folded(base.repeat(batch // 8, 1)).transpose(1, 2)
        for lengths in (None, torch.from_numpy(rng.integers(1, CLIP + 1, batch)).to(dev)):
            out = mel_kernel.launch_epilogue(mel, lengths, HOP)
            worst = max(worst, float((out - dsp.mel_epilogue(mel, lengths, HOP)).abs().max()))
            check(out.stride() == mel.stride(), f"the epilogue kernel wrote strides {out.stride()}, not {mel.stride()}")
        (ms, chain_ms), turns = in_turns(lambda: mel_kernel.launch_epilogue(mel, None, HOP),
                                         lambda: dsp.mel_epilogue(mel, None, HOP))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                mel_kernel.launch_epilogue(mel, None, HOP)
            for _ in range(10):
                dsp.mel_epilogue(mel, None, HOP)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_epilogue_") as tmp:
            prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
            events = json.loads((Path(tmp) / "trace.json").read_text())["traceEvents"]
        ours, chain = [], []   # ms of each kernel: the ctypes launch is in the trace, not in prof.events()
        for e in events:
            if e.get("cat") == "kernel":
                (ours if "mel_epilogue_kernel" in e["name"] else chain).append(1e-3 * e["dur"])
        check(len(ours) in (0, 10), f"{len(ours)} mel_epilogue_kernel launches in 10 calls")
        dev_ms = sum(ours) / 10 if ours else None
        chain_dev_ms = sum(chain) / 10 if chain else None
        bound = 1e3 * 8 * N_MELS * (1 + CLIP // HOP) * batch / HBM_RATE
        device = (f"device {dev_ms:.4f} ms, {share(dev_ms, bound)} {bound:.4f} ms (bytes)" if ours
                  else "device time not measured (the profiler saw no kernel)")
        chain_device = (f"device {chain_dev_ms:.4f} ms in {len(chain) // 10} launches" if chain
                        else "device time and launches not measured")
        print(f"[6] dB + min-max epilogue at B={batch} x (40, 501): mel_epilogue kernel {device}, 1 launch; "
              f"a call back to back {ms:.4f} ms ({ms_turns(turns[0])}); the torch-op chain {chain_device}, a call "
              f"back to back {chain_ms:.4f} ms ({ms_turns(turns[1])}): the kernel is {chain_ms / ms:.1f}x faster "
              f"back to back on {card}")
        rows.append({"shape": f"B={batch} x (40, 501)", "ms": ms, "device_ms": dev_ms, "plain_ms": chain_ms,
                     "plain_device_ms": chain_dev_ms, "plain_launches": len(chain) // 10, "bound_ms": bound,
                     "bound_by": "bytes"})
    print(f"[6] the epilogue kernel vs the torch-op chain, with and without ragged lengths: max|d| {worst:.3e} "
          f"(tol {EPILOGUE_TOL:g})")
    check(worst <= EPILOGUE_TOL, f"the epilogue kernel disagrees with the torch-op chain: {worst:.3e}")
    check(all(np.isfinite([r[k] for r in rows for k in ("ms", "plain_ms")])), "epilogue timing")
    return {"name": "mel_epilogue", "route": "cuda", "source": "audio_edge_ml_pipeline_torch/csrc/mel_epilogue.cu",
            "replaces": None, "max_abs_err": worst, **rows[-1], "library_ms": None, "also": rows[:-1]}


def mel_route_times(dev, card: str, entries: dict, waves, waves22) -> dict[str, list[dict]]:
    """Phase 6's timing of the four-pass plans and the off-plan route
    (mel_czt) at B = len(waves) five-second clips (16 kHz ``waves``, 22.05 kHz
    ``waves22``), beside their bounds and plain versions; each mel_czt shape
    in turns with the dense kernel it replaced there, launched directly (on
    no path), both held against the plain version. Returns {instantiation:
    [its shapes' numbers, the first the row's own]}."""
    import torch

    from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel, mel_unfolded

    batch = waves.shape[0]
    timed: dict[str, list[dict]] = {}
    with torch.inference_mode():
        for key, entry, w, sr, n_fft, hop, n_mels, precise in (
                ("mel_rfft<240, float>", "mel_power_folded", waves, SR, 480, HOP, N_MELS, False),
                ("mel_rfft<240, double>", "mel_power_folded", waves, SR, 480, HOP, N_MELS, True),
                ("mel_rfft<1024, float>", "mel_power_folded", waves22, SR22, 2048, MFCC_HOP, MFCC_MELS, False),
                ("mel_rfft<1024, double>", "mel_power_folded", waves22, SR22, 2048, MFCC_HOP, MFCC_MELS, True),
                ("mel_czt<float>", "mel_power_folded", waves, SR, CZT_N_FFT, HOP, N_MELS, False),
                ("mel_czt<float>", "mel_power_unfolded", waves, SR, CZT_N_FFT, HOP, N_MELS, False),
                ("mel_czt<double>", "mel_power_folded", waves22, SR22, CZT_N_FFT_22, MFCC_HOP, MFCC_MELS, True),
                ("mel_czt<float>", "mel_power_folded", waves22, SR22, DIRECT_N_FFT_22, MFCC_HOP, MFCC_MELS, False),
                ("mel_czt<double>", "mel_power_folded", waves22, SR22, DIRECT_N_FFT_22, MFCC_HOP, MFCC_MELS, True)):
            module, plain_fn, dense_launch = entries[entry]
            kw = {"precise": True} if precise else {}

            def kernel_fn():
                return getattr(module, entry)(w, sr, n_mels, n_fft, hop, **kw)

            ms_p = cuda_ms(lambda: plain_fn(w, sr, n_mels, n_fft, hop), iters=3, warmup=1)
            nonzeros = int(np.count_nonzero(golden.mel_filterbank(sr, n_fft, n_mels)))
            bound, bound_by_k, _, dense_peak_ms, unf_dense_peak_ms = mel_folded_bound(
                batch, w.shape[1], n_fft, nonzeros, hop, n_mels, F64_PEAK if precise else F32_PEAK)
            shape = f"B={batch} x 5 s at {sr / 1000:g} kHz, n_fft {n_fft}, hop {hop}, {n_mels} mels"
            row = {"entry": entry, "plain_ms": ms_p, "bound_ms": bound, "bound_by": bound_by_k, "shape": shape}
            if key.startswith("mel_czt"):
                folded = entry == "mel_power_folded"
                consts = (mel_kernel.constants(sr, n_fft, n_mels, dev, precise) if folded
                          else mel_unfolded.constants(sr, n_fft, n_mels, dev))

                def dense_fn():
                    return dense_launch(w, consts, n_fft, hop)

                (ms, ms_d), turns_d = in_turns(kernel_fn, dense_fn, timer=lambda fn: (
                    cuda_ms(fn, iters=3, warmup=1) if fn is dense_fn else cuda_ms(fn)))
                ref = plain_fn(w, sr, n_mels, n_fft, hop)
                dense_key = f"{'mel_folded' if folded else 'mel_unfolded'}<{'double' if precise else 'float'}>"
                dense_err = float((dense_fn() - ref).abs().max())
                czt_err = float((kernel_fn() - ref).abs().max())
                del ref
                timed.setdefault(dense_key, []).append({
                    "entry": entry, "ms": ms_d, "plain_ms": ms_p, "bound_ms": bound, "bound_by": bound_by_k,
                    "shape": shape, "max_abs_err": dense_err,
                    "formulation_ms": dense_peak_ms if folded else unf_dense_peak_ms})
                row.update(ms=ms, max_abs_err=czt_err, dense_ms=ms_d, turns=turns_d)
                print(f"[6] {key} ({entry}) at {shape}: {ms:.3f} ms ({ms_turns(turns_d[0])}), {share(ms, bound)} "
                      f"{bound:.4f} ms ({bound_by_k}), max|d| vs plain {czt_err:.3e}; the dense {dense_key} it replaced "
                      f"there, launched directly: {ms_d:.3f} ms ({ms_turns(turns_d[1])}), {share(ms_d, bound)}, "
                      f"max|d| vs plain {dense_err:.3e}; mel_czt is {ms_d / ms:.1f}x faster; plain version "
                      f"{ms_p:.3f} ms ({ms_p / ms:.1f}x mel_czt) on {card}")
            else:
                ms = cuda_ms(kernel_fn)
                row["ms"] = ms
                print(f"[6] {key} ({entry}) at {shape}: {ms:.3f} ms, {share(ms, bound)} {bound:.4f} ms ({bound_by_k}); "
                      f"plain version {ms_p:.3f} ms on {card}")
            timed.setdefault(key, []).append(row)
    return timed


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
    """The shipped config's mel and MFCC-sequence training experiments at
    the n_fft of the four-pass plans (480, 2048) and of the off-plan route
    (CZT_N_FFT for the mel, CZT_N_FFT_22 for the MFCC sequence, which runs
    mel_czt's float64 instantiation). Written as JSON
    under ``out_root``; its experiments as written."""
    import yaml

    shipped = {e["extractor"]: e for e in yaml.safe_load((REPO / "configs" / "feature_extraction.yaml").read_text())
               ["experiments"] if e["split"] == "train" and e["extractor"] != "audio_classical"}
    experiments = []
    for extractor, sizes in (("audio_mel_spec", (*NEW_PLANS, CZT_N_FFT)),
                             ("audio_mfcc_seq", (*NEW_PLANS, CZT_N_FFT_22))):
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
    mel_kernel.counter_czt.reset()
    t0 = time.perf_counter()
    X_mel = np.concatenate([mel_kernel.mel_spec_feature(class_clips_on_card(gen, dev, c, FSC22_CLIPS)).cpu().numpy()
                            for c in range(N_CLASSES)])
    mel5e_s = time.perf_counter() - t0
    mel5e_launches = (mel_kernel.counter.launches, mel_kernel.counter_czt.launches)
    y_mel = np.repeat(np.arange(N_CLASSES), FSC22_CLIPS).astype(np.int32)
    split = np.array(stratified_split_indices([names5e[c] for c in y_mel], 0.70, 0.15, 42))
    X_ct, y_ct = fsc22_classical_train(np.random.default_rng(22))
    check(X_mel.shape == (N_CLASSES * FSC22_CLIPS, N_MELS, 1 + CLIP // HOP) and bool(np.isfinite(X_mel).all()),
          f"5e mel features {X_mel.shape}")
    check(mel5e_launches == (N_CLASSES, 0), f"5e's extraction launched (all, czt) {mel5e_launches}")

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
              f"{mel5e_launches[0] - mel5e_launches[1]}, czt {mel5e_launches[1]}; train {int((split == 'train').sum())}, "
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
          f"{eng_card.parts[0].ovo[0].shape[1]} pairs (M {eng_card.parts[0].ovo[0].shape[2]}), "
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
        g5 = tune_batched.TrialGroup(arch5e, states5e, lrs5e, [0.0] * BATCHED_K, where, torch.float64,
                                      noise_seeds=[43 + i for i in range(BATCHED_K)])
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
            "names": names5e, "mel_sets": {part: (X_mel[split == part], y_mel[split == part])
                                           for part in ("train", "validation")},
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
    _, cw5 = eng_card._ovo_cached()
    idx5, ypm5 = eng_card.parts[0].ovo
    u5 = torch.from_numpy((cell5e["C"] * cw5).astype(np.float32)).to(dev)
    W5 = eng_card.parts[0].W
    n_folds5 = W5.shape[0]

    def cv_cell():
        return classical_core.svm_cv(Z5e, W5, idx5, ypm5, u5, 0.0, "rbf", "scale", search_cv._DEFAULT_ITERS)

    def cv_by_fold():
        return torch.cat([classical_core.svm_cv(Z5e[f : f + 1], W5[f : f + 1], idx5[f : f + 1], ypm5[f : f + 1],
                                                u5[f : f + 1], 0.0, "rbf", "scale", search_cv._DEFAULT_ITERS)
                          for f in range(n_folds5)])

    by_fold_gap = float((cv_by_fold() - cv_cell()).abs().max() / cv_cell().abs().max())
    (ms_cv_cell, ms_cv_by_fold), cv_turns = in_turns(cv_cell, cv_by_fold, timer=lambda fn: host_ms(fn, reps=1))
    ms_pca_cv = {k: host_ms(lambda k=k: classical_core.pca_cv(eng_card.parts[0].X, W5, k), reps=3)
                 for k in t5e["n_components"]}

    def group_epoch(members):
        def run():
            # as train_trial_group builds its groups: trial i's masks from its generator, seeded 43 + i
            g = tune_batched.TrialGroup(arch5e, [states5e[i] for i in members], [lrs5e[i] for i in members],
                                        [0.3] * len(members), dev, noise_seeds=[43 + i for i in members])
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


def family_times(dev, card: str, t5g: dict) -> dict:
    """Phase 6's times of the ds_cnn, the transformer, the teacher and the KD
    student (CUDA events): a train step (forward + backward + Adam, the
    trainers' default dropout) of the ds_cnn and the transformer at B=32 and
    B=512, of the teacher at TEACHER_IMAGE in phase 1 (head only) and phase 2
    (everything) at B=16 and B=128, of the KD student at B=16 and B=512; and
    5g's trained teacher's predict_proba in rows/s (host clock); with the
    card's name and power limit."""
    import torch

    from audio_edge_ml_pipeline_torch.models import get_model

    mel_shape, seq_shape = (N_MELS, 1 + CLIP // HOP), (40, 1 + CLIP22 // MFCC_HOP)

    def step_ms(tr, shape: tuple, b: int, iters: int = 20) -> float:
        Xb = tr._prepare_input(np.random.default_rng(b).standard_normal((b, *shape)).astype(np.float32))
        tr.prepare_fit(Xb, N_CLASSES)
        if tr.name == "distillation_cnn":
            tr.set_teacher_logits(np.random.default_rng(1).standard_normal((b, N_CLASSES)))
        tr._net.train()
        opt = torch.optim.Adam([p for p in tr._net.parameters() if p.requires_grad], lr=1e-3)
        X_d = torch.from_numpy(Xb).to(dev)
        y_d = torch.from_numpy(np.arange(b) % N_CLASSES).to(dev)
        idx, w = torch.arange(b, device=dev), torch.ones(b, device=dev)
        ms = cuda_ms(lambda: tr.train_step(opt, X_d, y_d, idx, w), iters=iters)
        del tr._net, opt, X_d
        torch.cuda.empty_cache()
        return ms

    times: dict[str, tuple[float, int, str]] = {}   # label -> (ms, rows, what)
    for model, shape in (("ds_cnn", mel_shape), ("transformer", seq_shape)):
        for b in (32, 512):
            times[f"{model} B={b}"] = (step_ms(get_model(model)(batch_size=b, device=dev), shape, b), b,
                                       f"train step on {shape} inputs")
    for phase in (1, 2):
        for b in (16, 128):
            tr = get_model("efficientnet_teacher")(image_size=TEACHER_IMAGE, batch_size=b, device=dev)
            tr._head_only = phase == 1
            times[f"teacher phase {phase} B={b}"] = (step_ms(tr, mel_shape, b, iters=5), b,
                                                     f"train step at {TEACHER_IMAGE}x{TEACHER_IMAGE}, "
                                                     + ("head only" if phase == 1 else "everything"))
    for b in (16, 512):
        times[f"KD student B={b}"] = (step_ms(get_model("distillation_cnn")(batch_size=b, device=dev), mel_shape, b),
                                      b, "train step, [16, 16, 16] on (40, 501)")
    teacher, Xv = t5g["teacher"], t5g["kd_val"]
    ms_predict = host_ms(lambda: teacher.predict_proba(Xv), reps=3)
    for label, (ms, b, what) in times.items():
        print(f"[6] {label}: {what}, {ms:.3f} ms, {b / ms * 1e3:.0f} rows/s on {card}")
    print(f"[6] teacher predict_proba (batch {teacher.batch_size}, {TEACHER_IMAGE}x{TEACHER_IMAGE}) on {len(Xv)} rows: "
          f"{ms_predict:.1f} ms, {len(Xv) / ms_predict * 1e3:.0f} rows/s (host clock) on {card}")
    check(all(np.isfinite([ms_predict, *(t[0] for t in times.values())])), "5g timing")
    return {**{k: v[0] for k, v in times.items()}, "teacher predict_proba": ms_predict}


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


CKPT_INNER = "o/.inner_state/0/"   # optax's inject_hyperparams(adam) state in a train_state.npz
ADAM_B1 = 0.9


def checkpoint_set(data, group: str) -> dict[str, np.ndarray]:
    """Set ``group`` ("params" or "best") of a train_state.npz (the JAX
    package's layout) in the bundle's keys: ``p/<flax path>`` and
    ``c/batch_stats/<flax path>``."""
    cols = {"params": "cols", "best": "best_cols"}[group]
    return {**{"p/" + k[len(f"p/{group}/"):]: data[k] for k in data if k.startswith(f"p/{group}/")},
            **{"c/" + k[len(f"p/{cols}/"):]: data[k] for k in data if k.startswith(f"p/{cols}/")}}


def checkpoint_moments(data, leaf: str = ".mu") -> dict[str, np.ndarray]:
    """Adam's first (``.mu``) or second (``.nu``) moments of a train_state.npz by flax path."""
    prefix = f"{CKPT_INNER}{leaf}/"
    return {k[len(prefix):]: data[k] for k in data if k.startswith(prefix)}


def step_gradients(after, before) -> dict[str, np.ndarray]:
    """The gradient of the one step between two train_state.npz of a run,
    from Adam's first moments: mu' = b1 mu + (1 - b1) g."""
    mu0 = checkpoint_moments(before)
    return {k: (v.astype(np.float64) - ADAM_B1 * mu0[k]) / (1 - ADAM_B1) for k, v in checkpoint_moments(after).items()}


def seeded_bundle(model: str, params: dict, input_shape: tuple, path: Path, seed: int = 0) -> Path:
    """A bundle of ``model`` (``params``: its widths) for inputs of
    ``input_shape``, from flax's initializers seeded ``seed``, its norm layers
    moved off their init (scale 1, bias 0; running mean 0, var 1) by a seeded
    numpy generator: at bias 0 the ds_cnn is invariant to its stem
    BatchNorm's scale, whose gradient then holds only roundoff, which no
    relative gate can hold two devices to."""
    import torch

    from audio_edge_ml_pipeline_torch.models import get_model
    from audio_edge_ml_pipeline_torch.models.layers import BatchNorm, LayerNorm

    tr = get_model(model)(**params, device="cpu")
    tr.initialize(input_shape, N_CLASSES, torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in tr._net.modules():
            if isinstance(mod, (BatchNorm, LayerNorm)):
                n = mod.weight.shape[0]
                mod.weight.copy_(torch.from_numpy(r.uniform(0.5, 1.5, n)))
                mod.bias.copy_(torch.from_numpy(r.normal(0.0, 0.2, n)))
            if isinstance(mod, BatchNorm):
                mod.mean.copy_(torch.from_numpy(r.normal(0.0, 0.3, n)))
                mod.var.copy_(torch.from_numpy(r.uniform(0.5, 2.0, n)))
    tr.save(path)
    return path


def step_and_grads(dev, X: np.ndarray, y: np.ndarray, bundle: Path, model: str = "cnn",
                   params: dict | None = None, dtype=None) -> tuple[float, dict, dict]:
    """One Adam step of ``model``'s trainer (``params``: its widths; the
    flagship CNN's by default) at dropout 0, warm-started from ``bundle``,
    on the first 32 rows of (X, y), in ``dtype`` (float32 by default):
    (loss, gradients of the trained parameters, the buffers after the step:
    the new BatchNorm statistics)."""
    import torch

    from audio_edge_ml_pipeline_torch.models import get_model

    dtype = dtype or torch.float32
    tr = get_model(model)(**(CNN_PARAMS if params is None else params), dropout=0.0, batch_size=32, seed=0,
                          pretrained_model=str(bundle), device=dev)
    Xp = tr._prepare_input(X).astype(np.float32)
    tr.prepare_fit(Xp, N_CLASSES)
    tr._net.to(dtype).train()
    tr._norm_mean, tr._norm_var = tr._norm_mean.to(dtype), tr._norm_var.to(dtype)
    trained = {k: p for k, p in tr._net.named_parameters() if p.requires_grad}
    opt = torch.optim.Adam(trained.values(), lr=1e-3)
    idx = torch.arange(32, device=dev)
    loss, _ = tr.train_step(opt, torch.from_numpy(Xp).to(dev, dtype), torch.from_numpy(y.astype(np.int64)).to(dev),
                            idx, torch.ones(32, device=dev, dtype=dtype))
    return (float(loss), {k: p.grad.detach().cpu() for k, p in trained.items()},
            {k: b.detach().cpu() for k, b in tr._net.named_buffers()})


def rel_grad_gap(grads: dict, ref: dict) -> tuple[float, str, float]:
    """The largest max|d| between ``grads`` and ``ref`` over the gradient
    tensors, each relative to the tensor's largest in ``ref`` (an attention
    key bias to the step's largest: softmax ignores a shift shared by every
    key, so its gradient is zero in exact arithmetic); that tensor's name;
    and the largest max|d| relative to the step's largest in ``ref``."""
    scale = max(float(g.abs().max()) for g in ref.values())
    diff = {k: float((grads[k].double() - g.double()).abs().max()) for k, g in ref.items()}
    rel, worst = max((diff[k] / (scale if k.endswith("key.bias") else float(g.abs().max())), k) for k, g in ref.items())
    return rel, worst, max(diff.values()) / scale


def grad_gap(dev, X: np.ndarray, y: np.ndarray, bundle: Path, model: str = "cnn",
             params: dict | None = None, floors: bool = False) -> dict:
    """``step_and_grads`` in float32 on the card and on the CPU: the card and
    CPU losses and their relative gap (``loss``, ``loss_cpu``, ``loss_rel``);
    the gradients' ``rel_grad_gap`` card vs CPU (``grad_rel``, that tensor
    ``worst``, of ``n_grads``; ``grad_rel_step``); and the largest
    max|d|/max|b| over the new BatchNorm statistics (``stats_rel``, or 0).
    ``floors``: the same step in float64 on each device too, giving the
    float64 readings card vs CPU under ``f64`` and each device's float32
    gradients against its own float64 ones (``floor_card``, ``floor_cpu``:
    ``rel_grad_gap``'s first two)."""
    import torch

    runs = {(d, dt): step_and_grads(d, X, y, bundle, model, params, dt)
            for d in (dev, torch.device("cpu")) for dt in ((torch.float32, torch.float64) if floors else (torch.float32,))}

    def card_vs_cpu(dt) -> dict:
        (loss_gpu, grads_gpu, stats_gpu), (loss_cpu, grads_cpu, stats_cpu) = runs[dev, dt], runs[torch.device("cpu"), dt]
        grad_rel, worst, grad_rel_step = rel_grad_gap(grads_gpu, grads_cpu)
        stats_rel = max((float((stats_gpu[k] - b).abs().max() / b.abs().max()) for k, b in stats_cpu.items()),
                        default=0.0)
        return {"loss": loss_gpu, "loss_cpu": loss_cpu, "loss_rel": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
                "grad_rel": grad_rel, "worst": worst, "n_grads": len(grads_cpu), "grad_rel_step": grad_rel_step,
                "stats_rel": stats_rel}

    out = card_vs_cpu(torch.float32)
    if floors:
        out["f64"] = card_vs_cpu(torch.float64)
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            out[f"floor_{name}"] = rel_grad_gap(runs[d, torch.float32][1], runs[d, torch.float64][1])[:2]
    return out


def compiled_scores(deploy_args: list[str], proj: Path, rows: np.ndarray, card_model) -> tuple[float, bool]:
    """The deploy CLI on ``deploy_args`` into ``proj``, gcc -O2 -std=c99 on the
    project's host harness, and its scores on ``rows`` against
    ``card_model``'s predict_proba on the card: (max|d|, argmax equal)."""
    from audio_edge_ml_pipeline_torch.deploy import deploy

    captured_stdout(deploy.main, [*deploy_args, "--output", str(proj)])
    exe = proj / "host_runner"
    cc_run = subprocess.run(["gcc", "-O2", "-std=c99", f"-I{proj / 'src'}", "-o", str(exe), str(proj / "host_main.c"),
                             *map(str, sorted((proj / "src").glob("*.c"))), "-lm"],
                            capture_output=True, text=True, timeout=600)
    check(cc_run.returncode == 0, f"gcc failed on {proj}: {cc_run.stderr[-2000:]}")
    err, same = 0.0, True
    for row in rows:
        (proj / "feat.f32").write_bytes(np.ascontiguousarray(row, np.float32).tobytes())
        run = subprocess.run([str(exe), "--predict-feat", str(proj / "feat.f32")], capture_output=True, text=True,
                             timeout=120)
        check(run.returncode == 0, f"the harness of {proj} failed: {run.stderr[-2000:]}")
        c_scores = np.array([float(v) for v in run.stdout.split()])
        card_scores = card_model.predict_proba(row[None])[0]
        check(c_scores.shape == card_scores.shape, f"C scores shape {c_scores.shape} of {proj}")
        err = max(err, float(np.abs(c_scores - card_scores).max()))
        same &= int(c_scores.argmax()) == int(card_scores.argmax())
    return err, same


def kd_config_copy(train_dir: Path, val_dir: Path, out_root: Path, classes: list[str]) -> tuple[Path, dict]:
    """configs/experiments/fsc22-nicla-kd.yaml with its FeatureSets and
    output moved, ``class_filter`` rewritten to ``classes``, the teacher at
    the file's image_size, batch, dropout and lr with its epochs cut to
    TEACHER_WARMUP of TEACHER_EPOCHS (both phases run) and its checkpoints in
    ``out_root/teacher_ckpt`` (``phase1/``, ``phase2/``), and the commented
    student step enabled on the teacher's bundle at the file's values but
    STUDENT_EPOCHS epochs; written as JSON under ``out_root``."""
    import yaml

    doc = yaml.safe_load((REPO / "configs" / "experiments" / "fsc22-nicla-kd.yaml").read_text())
    check([r["model"] for r in doc["runs"]] == ["efficientnet_teacher"] and len(doc["class_filter"]) == KD_CLASSES,
          "configs/experiments/fsc22-nicla-kd.yaml's runs and class_filter")
    teacher = doc["runs"][0]
    check(teacher["params"]["image_size"] == TEACHER_IMAGE and teacher["params"]["batch_size"] == 16,
          f"the teacher's params in the file: {teacher['params']}")
    teacher["params"].update(warmup_epochs=TEACHER_WARMUP, epochs=TEACHER_EPOCHS,
                             checkpoint_dir=str(out_root / "teacher_ckpt"))
    doc.update(features_dir=str(train_dir), features_test_dir=str(val_dir), output_dir=str(out_root / "models"),
               class_filter=list(classes))
    doc["runs"].append({"model": "distillation_cnn", "name": "fsc22_nicla_kd_student", "params": {
        "teacher_model": str(out_root / "models" / teacher["name"] / "model.flax.npz"), "filters": [16, 16, 16],
        "temperature": 4.0, "alpha": 0.7, "epochs": STUDENT_EPOCHS, "batch_size": 16, "learning_rate": 0.001}})
    out_root.mkdir(parents=True, exist_ok=True)
    path = out_root / "fsc22-nicla-kd.yaml"
    path.write_text(json.dumps(doc, indent=1))
    return path, doc


def phase_5g(dev, mel108, mfcc108, t5e: dict) -> dict:
    """Phase 5g: the ds_cnn and the transformer through the train CLI on 4c's
    FeatureSets (``mel108``, ``mfcc108``: FeatureSet objects), each served
    card vs CPU with a train step card vs CPU, the ds_cnn deployed to C;
    then configs/experiments/fsc22-nicla-kd.yaml (teacher, then student) on
    5e's fsc22-sized mel sets, with its checks and a resumed teacher run.
    Returns what phase 6 times."""
    import logging

    import torch

    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.features.base import FeatureSet
    from audio_edge_ml_pipeline_torch.models import deep as tdeep
    from audio_edge_ml_pipeline_torch.models import get_model
    from audio_edge_ml_pipeline_torch.ops import mel_kernel
    from audio_edge_ml_pipeline_torch.serve.edge_simulator import EdgeDeviceSimulator
    from audio_edge_ml_pipeline_torch.train import train

    t_start = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_5g_") as tmp:
        tmp = Path(tmp)
        for fs, name in ((mel108, "mel"), (mfcc108, "mfcc_seq")):
            pipeline.FeaturePipeline.save(fs, tmp / name)
        os.environ["MLFLOW_TRACKING_URI"] = str(tmp / "mlruns")
        try:
            # the ds_cnn (JAX defaults) on the mel set, the transformer (JAX defaults) on the MFCC sequences
            for model, fs, fs_dir in (("ds_cnn", mel108, "mel"), ("transformer", mfcc108, "mfcc_seq")):
                t0 = time.perf_counter()
                train.main(["--features", str(tmp / fs_dir), "--model", model, "--output", str(tmp / "models"),
                            "--experiment", "chip-smoke-5g", "--param", f"epochs={TRAIN_EPOCHS}"])
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
                bundle = tmp / "models" / model / "model.flax.npz"
                info = json.loads((bundle.parent / "model_info.json").read_text())
                keys = np.load(bundle).files
                n_stats = sum(k.startswith("c/batch_stats/") for k in keys)
                card_model, cpu_model = tdeep.load_any_model(bundle), tdeep.load_any_model(bundle, device="cpu")
                check(card_model.device.type == "cuda" and card_model.name == model, f"5g: the {model} served")
                Xr = fs.features[:8]
                served = float(np.abs(card_model._batched_logits(card_model._prepare_input(Xr)) -
                                      cpu_model._batched_logits(cpu_model._prepare_input(Xr))).max())
                seeded = seeded_bundle(model, {}, card_model._prepare_input(fs.features[:1]).shape[1:],
                                       tmp / f"{model}_seeded.npz")
                step = grad_gap(dev, fs.features[:32], fs.labels[:32], seeded, model, {}, floors=True)
                s64, f32_tol = step["f64"], F32_GRAD_TOL.get(model, GRAD_TOL)
                print(f"[5g] {model} ({card_model._arch_dict}) through the train CLI on the card: {TRAIN_EPOCHS} "
                      f"epochs on {len(fs.features)} rows of {fs.features.shape[1:]} in {fit_s:.2f} s, val_accuracy "
                      f"{info['val_accuracy']:.4f}; bundle {len(keys) - 3} tensors ({n_stats} c/batch_stats); served "
                      f"logits card vs CPU on 8 rows max|d| {served:.3e} (tol {LOGIT_TOL:g})")
                for label, st, tol in (("float64", s64, GRAD_TOL), ("float32", step, f32_tol)):
                    print(f"[5g] {model}: one train step (B=32, dropout 0, seeded bundle) in {label} card vs CPU: loss "
                          f"{st['loss']:.6f} vs {st['loss_cpu']:.6f} (rel {st['loss_rel']:.3e}, tol {STEP_LOSS_TOL:g}); "
                          f"gradients max|d| over each tensor's max|g| {st['grad_rel']:.3e} ({st['worst']}, the worst of "
                          f"{st['n_grads']}; tol {tol:g}), over the step's max|g| {st['grad_rel_step']:.3e}; new "
                          f"BatchNorm statistics max|d|/max {st['stats_rel']:.3e} (tol {BN_STAT_TOL:g})")
                print(f"[5g] {model}: the float32 step's gradients against the float64 step's on the same device, max|d| "
                      f"over each tensor's max|g|: card {step['floor_card'][0]:.3e} ({step['floor_card'][1]}), CPU "
                      f"{step['floor_cpu'][0]:.3e} ({step['floor_cpu'][1]}) (tol {f32_tol:g})")
                check(n_stats == (10 if model == "ds_cnn" else 0), f"5g: the {model} bundle holds {n_stats} statistics")
                check(served <= LOGIT_TOL, f"5g: the {model} logits on the card disagree with the CPU")
                check(all(st["loss_rel"] <= STEP_LOSS_TOL and st["stats_rel"] <= BN_STAT_TOL for st in (s64, step))
                      and s64["grad_rel"] <= GRAD_TOL and step["grad_rel"] <= f32_tol,
                      f"5g: the {model} train step on the card disagrees with the CPU")
                check(step["floor_card"][0] <= f32_tol and step["floor_cpu"][0] <= f32_tol,
                      f"5g: the {model}'s float32 gradients stray from its float64 ones")
                out[model] = card_model
            # --max-ram 0: the host harness, not a board (the stem's (20, 251, 32) map alone is 642 KB)
            err, same = compiled_scores(["--model", str(tmp / "models" / "ds_cnn" / "model.flax.npz"),
                                         "--features-dir", str(tmp / "mel"), "--max-ram", "0"], tmp / "ds_cnn_c",
                                        mel108.features[-2:], out["ds_cnn"])
            print(f"[5g] ds_cnn through the deploy CLI (--max-ram 0) and gcc -O2 -std=c99: C scores on 2 rows vs "
                  f"predict_proba on the card max|d| {err:.3e} (tol {C_SCORE_TOL:g}), argmax equal {same}")
            check(err <= C_SCORE_TOL and same, "5g: the ds_cnn's C forward disagrees with the card")

            # configs/experiments/fsc22-nicla-kd.yaml on 5e's fsc22-sized mel sets, teacher then student
            names = t5e["names"]
            kd_names = names[::2][:KD_CLASSES]
            for split, (Xs, ys) in t5e["mel_sets"].items():
                pipeline.FeaturePipeline.save(FeatureSet(features=Xs, feature_type="audio_mel_spec", modality="audio",
                                                         metadata=[{} for _ in ys], labels=ys, label_names=names),
                                              tmp / f"fsc22_mel_{split}")
            cfg, doc = kd_config_copy(tmp / "fsc22_mel_train", tmp / "fsc22_mel_validation", tmp / "kd", kd_names)
            teacher_name, student_name = (r["name"] for r in doc["runs"])
            messages: list[str] = []
            handler = logging.Handler(logging.INFO)
            handler.emit = lambda record: messages.append(record.getMessage())
            logging.getLogger("audio_edge_ml_pipeline_torch").addHandler(handler)
            cwd = os.getcwd()
            os.chdir(tmp / "kd")   # the CLI archives its config under ./config/experiments
            t0 = time.perf_counter()
            try:
                train.main(["--config", str(cfg)])
                torch.cuda.synchronize()
            finally:
                os.chdir(cwd)
                logging.getLogger("audio_edge_ml_pipeline_torch").removeHandler(handler)
            kd_s = time.perf_counter() - t0
            models = tmp / "kd" / "models"
            shortlist = json.loads((models / "shortlist.json").read_text())
            failures = [m for m in messages if "failed" in m]
            print(f"[5g] {cfg.name} through the train CLI on the card in {kd_s:.2f} s (teacher, both phases, then "
                  f"student); class_filter {kd_names}; shortlist "
                  f"{[(c['rank'], c['model'], round(c['val_f1_macro'], 4)) for c in shortlist['candidates']]}; "
                  f"logged failures {failures or 'none'}")
            check(sorted(c["model"] for c in shortlist["candidates"]) == ["distillation_cnn", "efficientnet_teacher"],
                  f"5g: the KD shortlist holds {[c['model'] for c in shortlist['candidates']]}")
            check(not failures, f"5g: the KD run logged failures {failures}")

            # the teacher's phases from its checkpoints: phase 1 starts from the seeded init (rebuilt here by a
            # fresh trainer of the same params), phase 2 from phase 1's best state (the bundle it warm-starts from)
            ids = [names.index(n) for n in kd_names]
            X_tr, y_tr = t5e["mel_sets"]["train"]
            teacher_params = {k: v for k, v in doc["runs"][0]["params"].items() if k != "checkpoint_dir"}
            fresh = get_model("efficientnet_teacher")(**teacher_params, device=dev)
            fresh.prepare_fit(fresh._prepare_input(X_tr[np.isin(y_tr, ids)]).astype(np.float32), KD_CLASSES)
            start = tdeep.params_to_flax(fresh._net.state_dict())
            saved = {}
            for phase in ("phase1", "phase2"):
                data = np.load(Path(doc["runs"][0]["params"]["checkpoint_dir"]) / phase / "train_state.npz")
                saved[phase] = {group: checkpoint_set(data, group) for group in ("params", "best")}
                saved[phase]["meta"] = json.loads(bytes(data["__meta__"].tobytes()).decode())
                saved[phase]["moved_moments"] = sorted(k for k, v in checkpoint_moments(data).items() if v.any())
            p1, p2_start, p2 = saved["phase1"]["params"], saved["phase1"]["best"], saved["phase2"]["params"]
            head = [k for k in start if k.startswith("p/head/")]
            frozen = [k for k in start if k.startswith(("p/backbone/", "c/"))]
            frozen_moved = [k for k in frozen for end in (p1, p2_start) if not np.array_equal(start[k], end[k])]
            head_moved = [k for k in head if not np.array_equal(start[k], p1[k])]
            stats = [k for k in frozen if k.startswith("c/")]
            stats_moved = [k for k in stats if not np.array_equal(p2_start[k], p2[k])]
            backbone_moved = [k for k in frozen if k.startswith("p/") and not np.array_equal(p2_start[k], p2[k])]
            epochs_saved = [saved[ph]["meta"]["epoch"] for ph in ("phase1", "phase2")]
            print(f"[5g] teacher checkpoints at epochs {epochs_saved} of phases 1 and 2: phase 1 changed "
                  f"{len(frozen_moved)} of {len(frozen)} backbone tensors (parameters and statistics, last and best "
                  f"state) and moved {len(head_moved)} of {len(head)} head tensors; phase 2 changed {len(stats_moved)} of "
                  f"{len(stats)} batch_stats and moved {len(backbone_moved)} of {len(frozen) - len(stats)} backbone "
                  f"parameters")
            check(epochs_saved == [TEACHER_WARMUP - 1, TEACHER_EPOCHS - TEACHER_WARMUP - 1],
                  f"5g: the teacher's phase checkpoints stopped at epochs {epochs_saved}")
            check(not frozen_moved and len(head_moved) == 2, "5g: phase 1 moved more than the head")
            check(not stats_moved and len(stats) == 98 and backbone_moved, "5g: phase 2 moved the backbone's statistics")
            print(f"[5g] the phase-1 checkpoint holds moments for {len(start) - len(stats)} parameters (optax's "
                  f"layout), nonzero for {saved['phase1']['moved_moments']}; phase 2's nonzero for "
                  f"{len(saved['phase2']['moved_moments'])}")
            check(saved["phase1"]["moved_moments"] == ["head/bias", "head/kernel"]
                  and len(saved["phase2"]["moved_moments"]) > 200, "5g: the frozen parameters' moments")
            teacher_bundle, student_bundle = models / teacher_name / "model.flax.npz", models / student_name / "model.flax.npz"
            teacher, teacher_cpu = tdeep.load_any_model(teacher_bundle), tdeep.load_any_model(teacher_bundle, device="cpu")
            X_val, y_val = t5e["mel_sets"]["validation"]
            keep = np.isin(y_val, [names.index(n) for n in kd_names])
            Xk = X_val[keep]
            lt = teacher._batched_logits(teacher._prepare_input(Xk[:4]))
            lc = teacher_cpu._batched_logits(teacher_cpu._prepare_input(Xk[:4]))
            teacher_gap = float(np.abs(lt - lc).max() / np.abs(lc).max())
            print(f"[5g] teacher (EfficientNet-B0 at {TEACHER_IMAGE}, {teacher._arch_dict['n_classes']} classes) logits "
                  f"card vs CPU on 4 rows max|d|/max {teacher_gap:.3e} (tol {TEACHER_TOL:g})")
            check(teacher_gap <= TEACHER_TOL and teacher._arch_dict["image_size"] == TEACHER_IMAGE,
                  "5g: the teacher's logits on the card disagree with the CPU")

            # the student served by the edge simulator, then deployed to C
            folder = tmp / "student_clips"
            gen = torch.Generator(device=dev).manual_seed(7)
            for c, name in enumerate(kd_names):
                (folder / name).mkdir(parents=True)
                write_wav(folder / name / "0.wav", class_clips_on_card(gen, dev, names.index(name), 1)[0].cpu().numpy(), SR)
            mel_kernel.counter.reset()
            mel_kernel.counter_czt.reset()
            sim = EdgeDeviceSimulator(student_bundle, kd_names, folder, device_id="student",
                                      telemetry_dir=tmp / "telemetry", stats_dir=tmp / "stats", seed=2)
            sim.run(8)
            torch.cuda.synchronize()
            out["mel_launches"] = mel_kernel.counter.launches
            sim_czt = mel_kernel.counter_czt.launches   # may not launch
            events = [json.loads(ln) for ln in (tmp / "telemetry" / "student_telemetry.jsonl").read_text().splitlines()]
            student = tdeep.load_any_model(student_bundle)
            err, same = compiled_scores(["--model", str(student_bundle), "--labels", *kd_names, "--max-ram", "0"],
                                        tmp / "student_c", Xk[:2], student)
            print(f"[5g] student ({student._arch_dict['filters']}, {student.name}) served by the edge simulator: 8 "
                  f"requests, mel_rfft launches {out['mel_launches'] - sim_czt}, czt {sim_czt}, predictions "
                  f"{[e['prediction'] for e in events]}; through the deploy CLI and gcc: C scores on 2 validation rows "
                  f"vs predict_proba on the card max|d| {err:.3e} (tol {C_SCORE_TOL:g}), argmax equal {same}")
            check(len(events) == 8 and all(e["prediction"] in kd_names for e in events), "5g: the served student")
            check(out["mel_launches"] == 8 and sim_czt == 0, "5g: the simulator did not launch mel_rfft once a request")
            check(err <= C_SCORE_TOL and same, "5g: the student's C forward disagrees with the card")

            # a checkpointed teacher run of one epoch, then one of two epochs resumed from it (built with another lr,
            # so the lr it ends at says whether it took the checkpoint's), beside an uninterrupted run of two epochs:
            # one step an epoch (batch = the 48 rows) at dropout 0, so the resumed step is the uninterrupted one's
            sub = np.isin(y_tr, ids)
            Xs, ys = X_tr[sub][:64], np.searchsorted(sorted(ids), y_tr[sub][:64])
            runs: dict[str, dict] = {}
            for tag, epochs, lr, ckpt in (("first", 1, 1e-3, "teacher_ckpt"), ("resumed", 2, 2e-3, "teacher_ckpt"),
                                          ("whole", 2, 1e-3, "teacher_whole")):
                rec: dict = {"epochs": [], "loss": {}}
                state = tmp / ckpt / "phase1" / "train_state.npz"

                def cb(e, logs, rec=rec, state=state):
                    rec["epochs"].append(e)
                    rec["loss"][e] = logs["loss"]
                    if e == 0:
                        rec["epoch0"] = dict(np.load(state))
                    return False

                tr = get_model("efficientnet_teacher")(epochs=epochs, warmup_epochs=epochs, image_size=TEACHER_IMAGE,
                                                       batch_size=48, dropout=0.0, learning_rate=lr,
                                                       checkpoint_dir=str(tmp / ckpt), device=dev)
                tr.fit(Xs[:48], ys[:48], Xs[48:], ys[48:], sorted(kd_names), tag, tmp / f"ckpt_{tag}", None,
                       epoch_callback=cb)
                rec["file"] = dict(np.load(state))
                rec["meta"] = json.loads(bytes(rec["file"]["__meta__"].tobytes()).decode())
                runs[tag] = rec
            first, resumed, whole = runs["first"], runs["resumed"], runs["whole"]
            g_res = step_gradients(resumed["file"], first["file"])
            g_whole = step_gradients(whole["file"], whole["epoch0"])
            grad_gap_res = max(float(np.abs(g_res[k] - g).max() / np.abs(g).max()) if g.any() else
                               float(np.abs(g_res[k]).max()) for k, g in g_whole.items())
            loss_gap_res = abs(resumed["loss"][1] - whole["loss"][1]) / abs(whole["loss"][1])
            print(f"[5g] teacher with checkpoint_dir: a 1-epoch run at lr 1e-3 left {first['meta']}; a 2-epoch run "
                  f"built at lr 2e-3 resumed from it ran epochs {resumed['epochs']} and left {resumed['meta']}; its "
                  f"step against an uninterrupted 2-epoch run's second (one step an epoch, dropout 0): loss "
                  f"{resumed['loss'][1]:.6f} vs {whole['loss'][1]:.6f} (rel {loss_gap_res:.3e}, tol {STEP_LOSS_TOL:g}), "
                  f"gradients from the moments max|d| over each tensor's max|g| {grad_gap_res:.3e} (tol {GRAD_TOL:g}; "
                  f"{sum(bool(g.any()) for g in g_whole.values())} of {len(g_whole)} tensors trained)")
            check(first["epochs"] == [0] and resumed["epochs"] == [1] and whole["epochs"] == [0, 1]
                  and first["meta"]["epoch"] == 0 and resumed["meta"]["epoch"] == 1
                  and first["meta"]["lr"] == resumed["meta"]["lr"] == 1e-3,
                  "5g: the resumed teacher did not restore its epoch counter and lr")
            check(int(resumed["file"]["o/.count"]) == int(whole["file"]["o/.count"]) == 2
                  and loss_gap_res <= STEP_LOSS_TOL and grad_gap_res <= GRAD_TOL,
                  "5g: the resumed step disagrees with the uninterrupted one")
            out.update(teacher=teacher, student=student, kd_val=Xk)
        finally:
            os.environ.pop("MLFLOW_TRACKING_URI", None)
    print(f"[5g] phase 5g in {time.perf_counter() - t_start:.2f} s")
    return out


# ---------------------------------------------------------------------------
# Phases 4e-4g: BIRDeep end to end, the augmentation stage, the device trace
# ---------------------------------------------------------------------------

BIRDEEP_RECORDINGS, BIRDEEP_RECORDING_S = 10, 30   # recordings a few tens of seconds long, 16 kHz
BIRDEEP_ROWS = {"train": 16, "validation": 4}      # annotation rows a species and split
BIRDEEP_SEGMENTS_S = (0.051, 0.3, 0.8, 1.5, 3.0, 5.0)  # segment lengths (the classical vector batches by exact length;
                                                     # 0.05 itself falls to either side of min_segment_duration by rounding)
BIRDEEP_DROPPED = "Passer domesticus"              # a species the config's class_filter drops
AUG_PER_CLASS = 3                                  # train clips a class in the augmentation tree (+1 validation)
AUG_ONE_STAGE_TOL, AUG_TWO_STAGE_TOL = 5e-3, 1e-2   # device vs host backend (tests/test_effects_jax.py)
AUG_BATCH = 64                                     # JAX's default device_batch


def write_birdeep_tree(root: Path, rng: np.random.Generator, focal: list[str]) -> dict[str, int]:
    """A BIRDeep_AudioAnnotations tree: BIRDEEP_RECORDINGS recordings of
    BIRDEEP_RECORDING_S s (noise, with a species' two-tone call at each of its
    segments) under Audios/<site>/<date>/, and train_file.csv /
    validation_file.csv with BIRDEEP_ROWS rows a species of the focal five and
    of BIRDEEP_DROPPED, segments of BIRDEEP_SEGMENTS_S; per split one "Data
    Augmentation" row and one segment under min_segment_duration, both of
    which the loader drops. Returns the focal rows a split."""
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav

    root.mkdir(parents=True)
    n = BIRDEEP_RECORDING_S * SR
    t = np.arange(n) / SR
    waves = [0.02 * rng.standard_normal(n) for _ in range(BIRDEEP_RECORDINGS)]
    rels = [f"SITE{r % 3 + 1}/2026_03_{r + 1:02d}/SITE{r % 3 + 1}_202603{r + 1:02d}_060000.WAV"
            for r in range(BIRDEEP_RECORDINGS)]
    header = "path,specie,start_time,end_time,low_frequency,high_frequency,recorder,date"
    species = [*focal, BIRDEEP_DROPPED]
    for split, per in BIRDEEP_ROWS.items():
        rows = [header]
        for k, sp in enumerate(species):
            f0 = 900.0 * 1.35 ** k
            for _ in range(per):
                r = int(rng.integers(BIRDEEP_RECORDINGS))
                dur = float(rng.choice(BIRDEEP_SEGMENTS_S))
                start = round(float(rng.uniform(0.0, BIRDEEP_RECORDING_S - 5.5)), 3)
                seg = (t >= start) & (t < start + dur)
                waves[r][seg] += 0.3 * np.sin(2 * np.pi * f0 * t[seg]) + 0.15 * np.sin(2 * np.pi * 2.1 * f0 * t[seg])
                rows.append(f"{rels[r]},{sp},{start:.3f},{start + dur:.3f},{0.8 * f0:.1f},{2.4 * f0:.1f},"
                            f"{rels[r].split('/')[0]},{rels[r].split('/')[1]}")
        rows.append(f"Data Augmentation/{rels[0]},{focal[0]},1.0,2.0,,,SITE1,2026_03_01")
        rows.append(f"{rels[1]},{focal[1]},4.00,4.02,,,SITE2,2026_03_02")
        (root / f"{split}_file.csv").write_text("\n".join(rows) + "\n")
    for rel, w in zip(rels, waves):
        (root / "Audios" / rel).parent.mkdir(parents=True, exist_ok=True)
        write_wav(root / "Audios" / rel, (0.8 * w / np.abs(w).max()).astype(np.float32), SR)
    return {split: per * len(focal) for split, per in BIRDEEP_ROWS.items()}


def birdeep_configs(dataset: Path, out_root: Path) -> tuple[Path, Path, dict, dict]:
    """configs/experiments/birdeep-feature-extraction.yaml with its dataset
    and outputs moved under ``out_root``/card, a copy writing to
    ``out_root``/cpu, and birdeep-5-classes-train.yaml on the card's outputs
    with the cnn's epochs cut to TRAIN_EPOCHS, all written as JSON. Returns
    (the extraction config, its CPU copy, the card's extraction document,
    the training document)."""
    import yaml

    shipped = (REPO / "configs" / "experiments" / "birdeep-feature-extraction.yaml").read_text()
    out_root.mkdir(parents=True)
    docs = {}
    for sub in ("card", "cpu"):
        doc = yaml.safe_load(shipped)
        doc["dataset"] = str(dataset)
        for exp in doc["experiments"]:
            exp["output"] = str(out_root / sub / Path(exp["output"]).name)
        (out_root / f"birdeep-feature-extraction-{sub}.yaml").write_text(json.dumps(doc, indent=1))
        docs[sub] = doc

    def moved(path):
        return str(out_root / "card" / Path(path).name)

    tr = yaml.safe_load((REPO / "configs" / "experiments" / "birdeep-5-classes-train.yaml").read_text())
    tr["features_dir"], tr["features_test_dir"] = moved(tr["features_dir"]), moved(tr["features_test_dir"])
    tr["output_dir"] = str(out_root / "models")
    check([r["model"] for r in tr["runs"]] == ["lda", "pca_svm", "random_forest", "cnn"],
          "birdeep-5-classes-train.yaml's runs")
    for run in tr["runs"]:
        for key in ("features_dir", "features_test_dir"):
            if key in run:
                run[key] = moved(run[key])
        if "epochs" in run.get("params", {}):
            run["params"]["epochs"] = TRAIN_EPOCHS
    (out_root / "birdeep-5-classes-train.yaml").write_text(json.dumps(tr, indent=1))
    return (out_root / "birdeep-feature-extraction-card.yaml", out_root / "birdeep-feature-extraction-cpu.yaml",
            docs["card"], tr)


def phase_4e(dev, tmp: Path) -> dict:
    """Phase 4e (ROADMAP §3 i): configs/experiments/birdeep-feature-extraction.yaml
    through the extraction CLI on the card on a synthetic BIRDeep tree, each
    FeatureSet against the CPU run and 3 rows against golden, its kernel
    launches counted; then birdeep-5-classes-train.yaml through the train CLI
    on those sets."""
    import importlib.util
    import logging

    import torch

    from audio_edge_ml_pipeline_torch.data.loaders import BIRDeepLoader
    from audio_edge_ml_pipeline_torch.features import get, pipeline
    from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel
    from audio_edge_ml_pipeline_torch.train import train

    t_start = time.perf_counter()
    root = tmp / "BIRDeep_AudioAnnotations"
    cfg, cfg_cpu, doc, train_doc = birdeep_configs(root, tmp / "birdeep")
    rows = write_birdeep_tree(root, np.random.default_rng(11), doc["class_filter"])
    counters = (mel_kernel.counter, mel_kernel.counter_f64, mel_kernel.counter_czt)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    pipeline.main(["--config", str(cfg)])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    by_inst = dict(mel_kernel.counter.by_instantiation)
    t0 = time.perf_counter()
    pipeline.main(["--config", str(cfg_cpu), "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    check(tuple(c.launches for c in counters) == launches, "4e: the CPU run launched a kernel")
    out: dict = {"mel_launches": by_inst.get("mel_rfft<256, float>", 0),
                 "f64_launches": by_inst.get("mel_rfft<512, double>", 0)}
    print(f"[4e] {Path(cfg).name} through the extraction CLI on the card in {card_s:.2f} s (the CPU run "
          f"{cpu_s:.2f} s): launches (all, float64, czt) {launches}, by instantiation {by_inst}")
    for exp in doc["experiments"]:
        classical = exp["extractor"] == "audio_classical"
        split = exp["split"]
        fs = pipeline.FeaturePipeline.load(exp["output"])
        fs_cpu = pipeline.FeaturePipeline.load(Path(exp["output"]).parent.parent / "cpu" / Path(exp["output"]).name)
        samples = list(BIRDeepLoader(root, split=split, species_filter=set(doc["class_filter"])))
        shape = (302,) if classical else (N_MELS, 1 + CLIP // HOP)
        check(fs.features.shape == (rows[split], *shape) == fs_cpu.features.shape and len(samples) == rows[split],
              f"4e: {exp['name']} FeatureSet shape {fs.features.shape}")
        check(sorted(fs.label_names) == sorted(doc["class_filter"]) and fs.metadata == [m for _, _, m in samples]
              and [fs.label_names[c] for c in fs.labels] == [s for _, s, _ in samples], f"4e: {exp['name']} labels")
        d = np.abs(fs.features.astype(np.float64) - fs_cpu.features)
        tol = CLASSICAL_REL_TOL if classical else FEATURE_TOL
        gap = float((d / np.maximum(np.abs(fs_cpu.features), 1.0)).max() if classical else d.max())
        loader = get(exp["extractor"])(device="cpu", **exp.get("extractor_params", {}))
        gold_err = 0.0
        for j in (0, rows[split] // 2, rows[split] - 1):
            path, _, meta = samples[j]
            g = (golden.classical_feature_vector if classical else golden.mel_spec_feature)(
                loader._load_clip(path, meta["start_time"], meta["end_time"]).astype(np.float64))
            dj = np.abs(fs.features[j] - g)
            gold_err = max(gold_err, float((dj / np.maximum(np.abs(g), 1.0)).max() if classical else dj.max()))
        seg_s = sorted({round(m["end_time"] - m["start_time"], 3) for m in fs.metadata})
        print(f"[4e] {exp['name']} ({exp['extractor']}, {split}): {fs}; segments {seg_s} s; card vs CPU "
              f"{'max|d|/max(|cpu|, 1)' if classical else 'max|d|'} {gap:.3e}, 3 rows vs float64 golden {gold_err:.3e} "
              f"(tol {tol:g})")
        check(gap <= tol and gold_err <= tol, f"4e: {exp['name']} misses its gate")
    check(out["mel_launches"] == 2 and out["f64_launches"] >= 2 and launches[2] == 0,
          f"4e: the mel experiments launched mel_rfft<256, float> {out['mel_launches']} times, not once each")

    # birdeep-5-classes-train.yaml on those FeatureSets, through the train CLI on the card
    messages: list[str] = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("audio_edge_ml_pipeline_torch").addHandler(handler)
    os.environ["MLFLOW_TRACKING_URI"] = str(tmp / "birdeep" / "mlruns")
    cwd = os.getcwd()
    os.chdir(tmp / "birdeep")
    t0 = time.perf_counter()
    try:
        train.main(["--config", str(tmp / "birdeep" / "birdeep-5-classes-train.yaml")])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        os.environ.pop("MLFLOW_TRACKING_URI")
        logging.getLogger("audio_edge_ml_pipeline_torch").removeHandler(handler)
    train_s = time.perf_counter() - t0
    shortlist = json.loads((tmp / "birdeep" / "models" / "shortlist.json").read_text())
    models = sorted(c["model"] for c in shortlist["candidates"])
    failures = [m for m in messages if "failed" in m]
    sklearn = importlib.util.find_spec("sklearn") is not None
    print(f"[4e] {train_doc['experiment']} (birdeep-5-classes-train.yaml, the cnn at {TRAIN_EPOCHS} epochs) through "
          f"the train CLI on the card in {train_s:.2f} s: shortlist "
          f"{[(c['rank'], c['model'], round(c['val_f1_macro'], 4)) for c in shortlist['candidates']]}; scikit-learn "
          f"{'present' if sklearn else 'absent'}; logged failures {failures or 'none'}")
    if sklearn:
        check(models == ["cnn", "lda", "pca_svm", "random_forest"] and not failures, "4e: all four runs shortlisted")
    else:   # the random forest is scikit-learn's in both packages
        check(models == ["cnn", "lda", "pca_svm"] and len(failures) == 1 and "random_forest" in failures[0]
              and "scikit-learn" in failures[0], "4e: the three device runs shortlisted, the forest refused by name")
    print(f"[4e] phase 4e in {time.perf_counter() - t_start:.2f} s")
    return out


def write_aug_tree(root: Path, rng: np.random.Generator) -> list[str]:
    """The augmentation stage's input: N_CLASSES class folders of 5 s 16 kHz
    clips, AUG_PER_CLASS + 1 a class, one class named Thunderstorm (the
    shipped config's override), and a split_manifest.json that puts
    AUG_PER_CLASS a class in train and one in validation."""
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav

    names = [f"class{c:02d}" for c in range(N_CLASSES)]
    names[5] = "Thunderstorm"
    manifest: dict[str, list[str]] = {"train": [], "validation": []}
    for name in names:
        (root / name).mkdir(parents=True)
        for i, y in enumerate(synth_clips(rng, AUG_PER_CLASS + 1)):
            write_wav(root / name / f"{i}.wav", y, SR)
            manifest["train" if i < AUG_PER_CLASS else "validation"].append(f"{name}/{i}.wav")
    (root / "split_manifest.json").write_text(json.dumps(manifest))
    return names


def aug_config(src: Path, out: Path, path: Path, **over) -> Path:
    """configs/augmentation.yaml with its dataset, manifest and output moved,
    ``over`` set; written as JSON to ``path``."""
    import yaml

    doc = yaml.safe_load((REPO / "configs" / "augmentation.yaml").read_text())
    doc.update(dataset=str(src), manifest=str(src / "split_manifest.json"), output_dir=str(out), **over)
    path.write_text(json.dumps(doc, indent=1))
    return path


def augment_cli(cfg: Path, *extra: str, tf32: bool = False) -> tuple[float, str]:
    """The augment CLI as a user runs it, in its own process (its host pool
    forks, which a process that has started CUDA must not): (seconds, its
    log). ``tf32`` turns both TF32 flags on in that process first."""
    argv = ["--config", str(cfg), *extra]
    code = ("import sys, torch\n"
            + ("torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True\n" if tf32 else "")
            + "from audio_edge_ml_pipeline_torch.features.augment import main\n"
            + f"main({argv!r})\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=cfg.parent,
                       timeout=600)
    secs = time.perf_counter() - t0
    check(r.returncode == 0, f"the augment CLI failed on {cfg.name}: {r.stderr[-3000:]}")
    return secs, r.stdout + r.stderr


def wav_tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.wav"))}


def vocoder_counts(log: str) -> tuple[int, int]:
    m = re.search(r"vocoder copies: (\d+) batched, (\d+) on the oracle", log)
    check(m is not None, "the device backend did not log its vocoder copies")
    return int(m[1]), int(m[2])


def phase_4f(dev, tmp: Path) -> dict:
    """Phase 4f: the augmentation stage. configs/augmentation.yaml (paths
    moved) through the augment CLI: the host backend at workers 1 and 4 byte
    for byte, the device backend on the card (both TF32 flags on) against
    it; a copy where every class runs time_stretch then pitch_shift at
    device_batch 64, device against host; time_stretch_batch alone at B=64 x
    5 s; then the augmented tree through the extraction CLI (split all)."""
    import torch

    from audio_edge_ml_pipeline_torch.data.audio_io import load_audio
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.ops import effects_device, mel_kernel

    t_start = time.perf_counter()
    root = tmp / "aug"
    src = root / "fsc22_device"
    names = write_aug_tree(src, np.random.default_rng(12))
    n_files = N_CLASSES * AUG_PER_CLASS
    out: dict = {}
    s_h1, _ = augment_cli(aug_config(src, root / "host1", root / "host1.yaml", workers=1))
    s_h4, _ = augment_cli(aug_config(src, root / "host4", root / "host4.yaml", workers=4))
    host1, host4 = wav_tree(root / "host1"), wav_tree(root / "host4")
    check(len(host1) == n_files * 5 and host1 == host4, "4f: the host backend's trees at workers 1 and 4 differ")
    s_dev, log_dev = augment_cli(aug_config(src, root / "dev", root / "dev.yaml", backend="device"), tf32=True)
    dev_tree = wav_tree(root / "dev")
    check(dev_tree.keys() == host1.keys(), "4f: the device backend wrote other files")
    storm = [k for k in host1 if k.startswith("Thunderstorm/") and "_aug" in k]
    same = [k for k in host1 if k not in storm and host1[k] == dev_tree[k]]
    storm_err = max(float(np.abs(load_audio(root / "host1" / k)[0] - load_audio(root / "dev" / k)[0]).max())
                    for k in storm)
    counts = vocoder_counts(log_dev)
    print(f"[4f] configs/augmentation.yaml on {n_files} train clips x 4 copies: host backend {s_h1:.2f} s at "
          f"workers 1, {s_h4:.2f} s at 4 (byte-identical); device backend on the card (TF32 on) {s_dev:.2f} s: "
          f"{len(same)} of {len(host1) - len(storm)} non-vocoder files byte-identical, the {len(storm)} Thunderstorm "
          f"copies max|d| {storm_err:.3e} (tol {AUG_ONE_STAGE_TOL:g}); vocoder copies (batched, oracle) {counts}")
    check(len(same) == len(host1) - len(storm) and len(storm) == 4 * AUG_PER_CLASS, "4f: device files differ")
    check(storm_err <= AUG_ONE_STAGE_TOL and counts == (4 * AUG_PER_CLASS, 0), "4f: the Thunderstorm copies")

    # every class through time_stretch then pitch_shift at device_batch 64
    chain = {"augmentations": [{"type": "time_stretch"}, {"type": "pitch_shift"}], "class_overrides": {},
             "device_batch": AUG_BATCH}
    s_vh, _ = augment_cli(aug_config(src, root / "voc_host", root / "voc_host.yaml", **chain))
    s_vd, log_vd = augment_cli(aug_config(src, root / "voc_dev", root / "voc_dev.yaml", backend="device", **chain),
                               tf32=True)
    vh, vd = wav_tree(root / "voc_host"), wav_tree(root / "voc_dev")
    check(vh.keys() == vd.keys() and len(vh) == n_files * 5, "4f: the vocoder trees hold other files")
    err, lengths_equal = 0.0, True
    for k in vh:
        a, b = load_audio(root / "voc_host" / k)[0], load_audio(root / "voc_dev" / k)[0]
        lengths_equal &= a.shape == b.shape
        err = max(err, float(np.abs(a - b).max()))
    vcounts = vocoder_counts(log_vd)
    workers = min(8, os.cpu_count() or 1)
    print(f"[4f] time_stretch then pitch_shift on every class, device_batch {AUG_BATCH}: host backend {s_vh:.2f} s "
          f"(workers {workers}), device backend on the card (TF32 on) {s_vd:.2f} s; device vs host max|d| {err:.3e} "
          f"(tol {AUG_TWO_STAGE_TOL:g}), lengths equal {lengths_equal}; vocoder copies (batched, oracle) {vcounts}")
    check(lengths_equal and err <= AUG_TWO_STAGE_TOL, "4f: the device vocoder disagrees with the host backend")
    check(vcounts == (2 * 4 * n_files, 0), f"4f: vocoder copies {vcounts}: the oracle took copies at device_batch 64")
    out.update(aug_host_s=s_vh, aug_dev_s=s_vd, aug_workers=workers, shipped_host_s=s_h1, shipped_dev_s=s_dev)

    # time_stretch_batch alone at B=64 five-second clips
    clips = synth_clips(np.random.default_rng(13), AUG_BATCH)
    rates = np.random.default_rng(14).uniform(0.85, 1.15, AUG_BATCH)
    out["stretch_ms"] = host_ms(lambda: effects_device.time_stretch_batch(clips, rates, device=dev))
    out["stretch_cpu_ms"] = host_ms(lambda: effects_device.time_stretch_batch(clips[:8], rates[:8], device="cpu"),
                                    reps=1) * AUG_BATCH / 8

    # the augmented tree through the extraction CLI on the card, split all
    mel_kernel.counter.reset()
    mel_kernel.counter_czt.reset()
    pipeline.main(["--loader", "audio_folder", "--dataset", str(root / "dev"), "--split", "all", "--extractor",
                   "audio_mel_spec", "--output", str(root / "mel")])
    torch.cuda.synchronize()
    out["mel_launches"] = mel_kernel.counter.launches
    fs = pipeline.FeaturePipeline.load(root / "mel")
    print(f"[4f] the device backend's tree through the extraction CLI (audio_mel_spec, split all): {fs}; mel_rfft "
          f"launches {out['mel_launches']}, czt {mel_kernel.counter_czt.launches}")
    check(fs.features.shape == (n_files * 5, N_MELS, 1 + CLIP // HOP) and fs.n_classes == N_CLASSES
          and sorted(fs.label_names) == sorted(names) and bool(np.isfinite(fs.features).all()),
          "4f: the augmented FeatureSet")
    check(out["mel_launches"] >= 1 and mel_kernel.counter_czt.launches == 0,
          "4f: the extraction's mel kernel")
    print(f"[4f] phase 4f in {time.perf_counter() - t_start:.2f} s")
    return out


def kernel_intervals(events: list[dict]) -> list[tuple[float, float]]:
    """The union of the kernels' [start, end) intervals in a trace, in µs."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel")
    union: list[list[float]] = []
    for a, b in spans:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    return [(a, b) for a, b in union]


def covered(union: list[tuple[float, float]], a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def trace_summary(stage_dir: Path) -> dict:
    """A stage's torch.profiler trace: kernels by total device time (µs,
    launches), the device idle share over the stage's window (1 - the union
    of kernel intervals over the span of all its timed events) and over the
    train steps after the first, and each aep.train_step range's host time, the
    kernel time inside it and the kernel launches made in it."""
    (path,) = stage_dir.glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    kernels: dict[str, list[float]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"], [0.0, 0])
            k[0] += e["dur"]
            k[1] += 1
    union = kernel_intervals(events)
    t0, t1 = min(e["ts"] for e in events), max(e["ts"] + e["dur"] for e in events)
    steps = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "aep.train_step"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]]
    steps.sort(key=lambda s: s["ts"])
    a, b = (steps[1]["ts"], steps[-1]["ts"] + steps[-1]["dur"]) if len(steps) > 1 else (t0, t1)
    launch_ts = np.sort([e["ts"] for e in launches])
    return {"kernels": kernels, "window_us": t1 - t0, "busy_us": covered(union, t0, t1),
            "idle": 1.0 - covered(union, t0, t1) / (t1 - t0), "bytes": path.stat().st_size,
            "steady_idle": 1.0 - covered(union, a, b) / (b - a),
            "steps": [(s["dur"], covered(union, s["ts"], s["ts"] + s["dur"]),
                       int(np.searchsorted(launch_ts, s["ts"] + s["dur"]) - np.searchsorted(launch_ts, s["ts"])))
                      for s in steps]}


def write_fsc22_tree(root: Path, dev, per_class: int) -> Path:
    """An fsc22-layout tree (flat audio dir and metadata CSV) of 27 classes
    x ``per_class`` five-second 16 kHz clips, made on the card from a seeded
    generator and written as 16-bit WAVs by a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav

    audio_dir = root / "Audio Wise V1.0-20260101" / "Audio Wise V1.0"
    meta_dir = root / "Metadata-20260101" / "Metadata"
    audio_dir.mkdir(parents=True)
    meta_dir.mkdir(parents=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = ["Source File Name,Dataset File Name,Class ID,Class Name"]
    with ThreadPoolExecutor(8) as pool:
        for c in range(N_CLASSES):
            clips = class_clips_on_card(gen, dev, c, per_class).cpu().numpy()
            names = [f"{c + 1}_{i + 1}.wav" for i in range(per_class)]
            list(pool.map(lambda a: write_wav(audio_dir / a[0], a[1], SR), zip(names, clips)))
            rows += [f"src_{n},{n},{c + 1},class{c:02d}" for n in names]
    (meta_dir / "Metadata V1.0 FSC22.csv").write_text("\n".join(rows) + "\n")
    return root


def phase_4g(dev, tmp: Path, card: str) -> dict:
    """Phase 4g: the AEP_PROFILE_DIR device trace at fsc22 scale. The
    extraction CLI on an fsc22-sized tree (27 classes x 75 five-second
    clips, split all: 2025 rows in chunks of the extractor's 256) and a
    TRACE_EPOCHS-epoch run of the flagship CNN through the train CLI on that
    FeatureSet, with AEP_PROFILE_DIR set; each stage's trace parsed: the top
    kernels by device time, the idle share over the stage's window, and
    every train step's host range (the time the host takes to launch it),
    the kernel time inside it and the host time between kernels, the first
    step (cuDNN's algorithm choice) reported apart. The extraction trace
    must name mel_rfft with the launches the kernel's counter saw."""
    import torch

    from audio_edge_ml_pipeline_torch.data import native_wavio
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.ops import mel_kernel
    from audio_edge_ml_pipeline_torch.train import train

    t_start = time.perf_counter()
    tree = write_fsc22_tree(tmp / "fsc22_full", dev, FSC22_CLIPS)
    write_s = time.perf_counter() - t_start
    trace_dir = tmp / "trace"
    os.environ["AEP_PROFILE_DIR"] = str(trace_dir)
    os.environ["MLFLOW_TRACKING_URI"] = str(tmp / "trace_mlruns")
    decode = native_wavio.decode
    native_decodes: list[bool] = []   # one entry a decode call of load_audio: did the reader decode the file

    def counted_decode(*args):
        got = decode(*args)
        native_decodes.append(got is not None)
        return got

    native_wavio.decode = counted_decode
    try:
        mel_kernel.counter.reset()
        t0 = time.perf_counter()
        pipeline.main(["--loader", "fsc22", "--dataset", str(tree), "--extractor", "audio_mel_spec", "--split",
                       "all", "--output", str(tmp / "trace_features")])
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        launches = mel_kernel.counter.launches
        # the same extraction with the numpy codec (the reader patched out), traced apart
        native_wavio.decode = lambda *a: None
        os.environ["AEP_PROFILE_DIR"] = str(tmp / "trace_numpy")
        t0 = time.perf_counter()
        pipeline.main(["--loader", "fsc22", "--dataset", str(tree), "--extractor", "audio_mel_spec", "--split",
                       "all", "--output", str(tmp / "trace_features_numpy")])
        torch.cuda.synchronize()
        numpy_s = time.perf_counter() - t0
        native_wavio.decode = decode
        os.environ["AEP_PROFILE_DIR"] = str(trace_dir)
        t0 = time.perf_counter()
        train.main(["--features", str(tmp / "trace_features"), "--model", "cnn", "--output",
                    str(tmp / "trace_models"), "--experiment", "chip-smoke-trace",
                    *(a for k, v in CNN_PARAMS.items() for a in ("--param", f"{k}={json.dumps(v)}")),
                    "--param", f"epochs={TRACE_EPOCHS}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        native_wavio.decode = decode
        os.environ.pop("AEP_PROFILE_DIR")
        os.environ.pop("MLFLOW_TRACKING_URI")
    stages = sorted(p.name for p in trace_dir.iterdir())
    check(stages == ["extract:audio_mel_spec", "fit:cnn"], f"4g: the traced stages {stages}")
    rows = N_CLASSES * FSC22_CLIPS
    print(f"[4g] an fsc22-sized tree ({rows} clips of 5 s at 16 kHz) written in {write_s:.2f} s; the extraction CLI "
          f"on it in {extract_s:.2f} s, the train CLI ({TRACE_EPOCHS} epochs of the cnn {CNN_PARAMS}, B=32) in "
          f"{train_s:.2f} s, both traced")
    out: dict = {"mel_launches": launches}
    for stage, secs in (("extract:audio_mel_spec", extract_s), ("fit:cnn", train_s)):
        s = trace_summary(trace_dir / stage)
        top = sorted(s["kernels"].items(), key=lambda kv: -kv[1][0])[:6]
        print(f"[4g] trace of {stage} ({secs:.2f} s in the CLI, {s['bytes'] / 1e6:.2f} MB): window "
              f"{s['window_us'] / 1e3:.3f} ms, kernels busy {s['busy_us'] / 1e3:.3f} ms, device idle share "
              f"{s['idle']:.4f}; top kernels by device time: "
              + "; ".join(f"{n[:70]} {t / 1e3:.3f} ms x {c}" for n, (t, c) in top))
        check(bool(s["kernels"]), f"4g: the trace of {stage} holds no kernel")
        out[stage] = s
    ext = out["extract:audio_mel_spec"]
    ext_numpy = trace_summary(tmp / "trace_numpy" / "extract:audio_mel_spec")
    same = np.array_equal(pipeline.FeaturePipeline.load(tmp / "trace_features").features,
                          pipeline.FeaturePipeline.load(tmp / "trace_features_numpy").features)
    n_native = sum(native_decodes)
    print(f"[4g] WAV decode in the extraction: the native reader decoded {n_native} of {rows} clips; the extraction "
          f"CLI {extract_s:.2f} s with it (device idle share {ext['idle']:.4f}) and {numpy_s:.2f} s with the numpy "
          f"codec patched in (idle share {ext_numpy['idle']:.4f}); equal FeatureSets {same} on {card}")
    check(n_native == len(native_decodes) == rows, "4g: the native WAV reader did not decode every clip")
    check(same, "4g: the native reader's features differ from the numpy codec's")
    out["extract_s"], out["numpy_extract_s"], out["numpy_idle"] = extract_s, numpy_s, ext_numpy["idle"]
    mel_traced = sum(c for n, (_, c) in ext["kernels"].items() if "mel_rfft" in n)
    print(f"[4g] mel_rfft in the extraction trace: {mel_traced} launches; the kernel's counter: {launches}")
    check(mel_traced == launches == -(-rows // 256), "4g: the trace's mel_rfft launches differ from the counter's")
    fit = out["fit:cnn"]
    steps = fit["steps"]
    per_epoch = -(-(rows - rows // 5) // 32)
    check(len(steps) >= 2 * per_epoch - 2, f"4g: the train trace holds {len(steps)} aep.train_step ranges")
    host = np.array([d - k for d, k, _ in steps]) / 1e3
    rng_ms, busy_ms = np.array([d for d, _, _ in steps]) / 1e3, np.array([k for _, k, _ in steps]) / 1e3
    n_launch = np.array([n for _, _, n in steps])
    later = slice(1, None)
    print(f"[4g] train steps in the trace: {len(steps)} (B=32, {TRACE_EPOCHS} epochs); the first (cuDNN's set-up): "
          f"host range {rng_ms[0]:.3f} ms, kernels inside it {busy_ms[0]:.3f} ms, {n_launch[0]} launches; the "
          f"other {len(steps) - 1}: host range {np.mean(rng_ms[later]):.3f} ms mean ({np.median(rng_ms[later]):.3f} "
          f"median), kernels inside it {np.mean(busy_ms[later]):.3f} ms mean, host time between kernels "
          f"{np.mean(host[later]):.3f} ms mean, {np.median(host[later]):.3f} median, {np.min(host[later]):.3f}-"
          f"{np.max(host[later]):.3f}, kernel launches a step {np.mean(n_launch[later]):.1f}; device idle share from "
          f"the second step's start to the last one's end {fit['steady_idle']:.4f}")
    print("[4g] every step's host time between kernels, ms: " + " ".join(f"{h:.3f}" for h in host))
    print(f"[4g] phase 4g in {time.perf_counter() - t_start:.2f} s")
    return out


CQT_BINS, CQT_HOP = 84, 512                     # audio_cqt's defaults: 84 bins, 12 an octave from C1, hop 512
CQT_BATCH = 512                                 # the extractor's batch: 5 s clips at 22.05 kHz
CQT_CARD_CPU_TOL = 1e-6                         # both sides float64 products: what is left is float32 rounding
IMAGE_TOL, EMBED_TOL = 2e-4, 1e-4               # the image gates (tests/test_image_jax.py); embeddings over their largest
IMAGE_CLASSES, IMAGE_PER_CLASS = 4, 16
IMAGE_BATCH, EMBED_BATCHES = 256, (32, 256)
VIDEO_CLASSES, VIDEO_PER_CLASS, VIDEO_FRAMES = 3, 2, 24


def phase_4h(dev, tmp: Path, fsc22: Path, train_rows: int) -> dict:
    """Phase 4h: audio_cqt. The extraction CLI on phase 4's fsc22 tree
    (split train, resampled to 22.05 kHz) on the card and on the CPU: equal
    labels and metadata, card vs CPU within CQT_CARD_CPU_TOL, 3 rows within
    FEATURE_TOL of golden; then ``cqt_feature`` alone at B=CQT_BATCH x 5 s:
    its time, peak memory (under the card's), the float64 GEMM's own rate,
    and one clip alone against the same clip in the batch."""
    import torch

    from audio_edge_ml_pipeline_torch.data.audio_io import load_audio
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.ops import dsp, golden

    t_start = time.perf_counter()
    secs = {}
    for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        pipeline.main(["--loader", "fsc22", "--dataset", str(fsc22), "--extractor", "audio_cqt", "--split", "train",
                       "--output", str(tmp / "cqt" / side), *extra])
        torch.cuda.synchronize()
        secs[side] = time.perf_counter() - t0
    fs, fs_cpu = (pipeline.FeaturePipeline.load(tmp / "cqt" / side) for side in ("card", "cpu"))
    T = 1 + CLIP22 // CQT_HOP
    check(fs.features.shape == fs_cpu.features.shape == (train_rows, CQT_BINS, T), f"4h: shape {fs.features.shape}")
    check(fs.metadata == fs_cpu.metadata and list(fs.labels) == list(fs_cpu.labels) and fs.n_classes == N_CLASSES,
          "4h: labels or metadata card vs CPU")
    check(bool(np.isfinite(fs.features).all()) and fs.features.min() >= 0 and fs.features.max() <= 1, "4h: range")
    gap = float(np.abs(fs.features - fs_cpu.features).max())
    audio_dir = fsc22 / "Audio Wise V1.0-20260101" / "Audio Wise V1.0"
    gold_err = 0.0
    for j in (0, train_rows // 2, train_rows - 1):
        yj, _ = load_audio(audio_dir / fs.metadata[j]["filename"], sr=SR22)
        gold_err = max(gold_err, float(np.abs(fs.features[j] - golden.cqt_feature(yj)).max()))
    print(f"[4h] audio_cqt through the extraction CLI (fsc22 tree, split train, {train_rows} clips at 22.05 kHz): "
          f"{fs} on the card in {secs['card']:.2f} s, the CPU run {secs['cpu']:.2f} s; card vs CPU max|d| {gap:.3e} "
          f"(tol {CQT_CARD_CPU_TOL:g}); 3 rows vs float64 golden {gold_err:.3e} (tol {FEATURE_TOL:g})")
    check(gap <= CQT_CARD_CPU_TOL and gold_err <= FEATURE_TOL, "4h: audio_cqt misses its gate")

    rng = np.random.default_rng(41)
    waves = torch.from_numpy(np.tile(synth_clips(rng, 8, CLIP22, SR22), (CQT_BATCH // 8, 1))).to(dev)
    waves[3] = torch.from_numpy(synth_clips(rng, 1, CLIP22, SR22)[0]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    feat = dsp.cqt_feature(waves)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    alone = dsp.cqt_feature(waves[3:4])
    alone_gap = float((feat[3] - alone[0]).abs().max())
    check(feat.shape == (CQT_BATCH, CQT_BINS, T) and bool(torch.isfinite(feat).all()), "4h: the B=512 feature")
    check(peak < total, f"4h: peak memory {peak} over the card's {total}")
    print(f"[4h] cqt_feature at B={CQT_BATCH} x 5 s: peak memory {peak / 2**30:.2f} GiB of the card's "
          f"{total / 2**30:.2f} GiB (blocks of {dsp._CQT_BLOCK_BYTES / 2**30:.0f} GiB of partial products); one clip "
          f"alone vs in the batch max|d| {alone_gap:.3e} (tol {CQT_CARD_CPU_TOL:g})")
    check(alone_gap <= CQT_CARD_CPU_TOL, "4h: a clip's CQT depends on its batch-mates")
    ms = cuda_ms(lambda: dsp.cqt_feature(waves), iters=5, warmup=1)
    n_fft = dsp._cqt_n_fft(float(SR22), golden.C1_HZ, CQT_BINS, 12)
    taps = dsp._cqt_taps64(float(SR22), golden.C1_HZ, CQT_BINS, 12, CQT_HOP)
    chunks = T + taps.shape[1] // (2 * CQT_BINS) - 1
    a = torch.randn(CQT_BATCH * chunks // 3, CQT_HOP, dtype=torch.float64, device=dev)
    w = torch.from_numpy(taps).to(dev)
    gemm_ms = cuda_ms(lambda: a @ w, iters=5, warmup=1)
    gemm_rate = 2 * a.shape[0] * CQT_HOP * w.shape[1] / (gemm_ms * 1e-3)
    flops = 2.0 * CQT_BATCH * T * n_fft * 2 * CQT_BINS    # every frame against every kernel, real and imaginary
    done = 2.0 * CQT_BATCH * chunks * CQT_HOP * taps.shape[1]   # the hop-chunk GEMM as run (kernels zero-extended)
    nbytes = 4 * CQT_BATCH * (CLIP22 + CQT_BINS * T)
    t_ops, t_bytes = flops / F64_PEAK, nbytes / HBM_RATE
    bound = 1e3 * max(t_ops, t_bytes)
    out = {"ms": ms, "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops,
           "gemm_rate": gemm_rate, "peak_gib": peak / 2**30}
    print(f"[4h] cqt_feature at B={CQT_BATCH} x 5 s, 22.05 kHz, {CQT_BINS} bins, n_fft {n_fft}, hop {CQT_HOP}: "
          f"{ms:.3f} ms ({CQT_BATCH / ms * 1e3:.0f} clips/s); float64 operations {flops / 1e9:.1f} G (the GEMM as run "
          f"{done / 1e9:.1f} G), bytes {nbytes / 1e6:.1f} MB: bound {bound:.3f} ms ({out['bound_by']}; {F64_PEAK / 1e12:.0f} "
          f"TFLOP/s float64, {HBM_RATE / 1e12:.2f} TB/s), {100 * bound / ms:.2f} % of it; this card's float64 GEMM "
          f"alone at the CQT's shape ({a.shape[0]} x {CQT_HOP} x {w.shape[1]}) {gemm_ms:.3f} ms, "
          f"{gemm_rate / 1e12:.2f} TFLOP/s")
    check(np.isfinite(ms) and ms > 0, "4h: timing")
    print(f"[4h] phase 4h in {time.perf_counter() - t_start:.2f} s")
    return out


def write_image_trees(root: Path, rng: np.random.Generator) -> tuple[Path, Path, dict]:
    """An image_folder tree (IMAGE_CLASSES classes x IMAGE_PER_CLASS PNGs of
    various sizes, gray and RGB) and a birdeep_image tree: 640 x 256
    spectrogram-like RGB PNGs under images/<site>/<date>/, train_file.csv /
    validation_file.csv / test_file.csv with YOLO boxes, per split one "Data
    Augmentation" row (dropped) and one box under min_bbox_area (kept, with
    no bbox_norm). Returns (folder, birdeep root, rows a split)."""
    from PIL import Image

    folder = root / "image_folder"
    for c in range(IMAGE_CLASSES):
        (folder / f"class{c}").mkdir(parents=True)
        for i in range(IMAGE_PER_CLASS):
            h, w = int(rng.integers(96, 200)), int(rng.integers(96, 200))
            yy, xx = np.mgrid[0:h, 0:w]
            base = 127 + 100 * np.sin(2 * np.pi * ((c + 1) * xx / w + (i % 4) * yy / h))
            img = np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img if i % 2 else img[..., 0]).save(folder / f"class{c}" / f"{i:02d}.png")
    bird = root / "BIRDeep_Spectrograms"
    species = ["Cisticola juncidis", "Emberiza calandra", "Passer domesticus"]
    header = "path,specie,start_time,end_time,recorder,date,bbox"
    rows: dict[str, int] = {}
    k = 0
    for split, per in (("train", 6), ("validation", 2), ("test", 2)):
        lines = [header]
        for s, sp in enumerate(species):
            for _ in range(per):
                rel = f"SITE{s + 1}/2026_04_0{s + 1}/SITE{s + 1}_2026040{s + 1}_{k:06d}.WAV"
                png = (bird / "images" / rel).with_suffix(".PNG")
                png.parent.mkdir(parents=True, exist_ok=True)
                spec = rng.gamma(2.0, 20.0, (256, 640))
                spec[80 + 30 * s : 110 + 30 * s, 200:420] += 120
                Image.fromarray(np.clip(np.stack([spec, spec * 0.8, 255 - spec], -1), 0, 255).astype(np.uint8)).save(png)
                box = "0.5, 0.4, 0.001, 0.003" if k % 9 == 4 else f"{0.3 + 0.02 * (k % 10)}, 0.4, 0.35, 0.15"
                lines.append(f'{rel},{sp},1.0,3.5,SITE{s + 1},2026_04_0{s + 1},"[{s}, {box}]"')
                k += 1
        lines.append(f'Data Augmentation/SITE1/aug_{split}.WAV,{species[0]},0.0,1.0,SITE1,2026_04_01,"[0, 0.5, 0.5, 0.2, 0.2]"')
        (bird / f"{split}_file.csv").write_text("\n".join(lines) + "\n")
        rows[split] = per * len(species)
    return folder, bird, rows


def seeded_mobilenet_weights(path: Path, seed: int = 7) -> Path:
    """A MobileNetV2 weights .npz in the flax layout written by the port:
    flax's initializers from a seeded generator, every BatchNorm's scale,
    bias and statistics moved off their init from the same seed."""
    import torch

    from audio_edge_ml_pipeline_torch.models.backbones import MobileNetV2
    from audio_edge_ml_pipeline_torch.models.deep import init_weights_, params_to_flax

    gen = torch.Generator().manual_seed(seed)
    net = MobileNetV2()
    init_weights_(net, gen)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if ".bns." in name:
                if name.endswith(("weight", "var")):
                    t.copy_(0.5 + torch.rand(t.shape, generator=gen))
                else:
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    np.savez(path, **params_to_flax(net.state_dict()))
    return path


def extraction_config(path: Path, dataset: Path, loader: str, split: str, exps: list[dict], out: Path) -> Path:
    """An extraction config (JSON, which the YAML loader reads) of ``exps``
    on one dataset, each written under ``out``."""
    path.write_text(json.dumps({"dataset": str(dataset), "loader": loader, "split": split, "experiments": [
        {**e, "output": str(out / e["name"])} for e in exps]}, indent=1))
    return path


def card_vs_cpu(tmp: Path, tag: str, dataset: Path, loader: str, split: str, exps: list[dict]) -> dict:
    """``exps`` through the extraction CLI on the card and again with
    --device cpu: {name: (card FeatureSet, CPU FeatureSet)}, and the
    seconds of each side."""
    import torch

    from audio_edge_ml_pipeline_torch.features import pipeline

    runs: dict = {}
    for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        cfg = extraction_config(tmp / f"{tag}_{side}.json", dataset, loader, split, exps, tmp / tag / side)
        t0 = time.perf_counter()
        pipeline.main(["--config", str(cfg), *extra])
        torch.cuda.synchronize()
        runs[f"{side}_s"] = time.perf_counter() - t0
    for e in exps:
        runs[e["name"]] = tuple(pipeline.FeaturePipeline.load(tmp / tag / side / e["name"]) for side in ("card", "cpu"))
    return runs


def check_image_set(label: str, extractor: str, card, cpu, rows: int) -> str:
    """Card against CPU at the image gates: classical within IMAGE_TOL with
    the LBP and histogram columns (the 90 before the GLCM's 6) bit for bit,
    pixels and frame stacks equal, embeddings within EMBED_TOL of their
    largest. Returns the printed comparison."""
    check(card.features.shape == cpu.features.shape and len(card.features) == rows,
          f"{label}: shape {card.features.shape} vs {cpu.features.shape}, {rows} rows expected")
    check(card.metadata == cpu.metadata and list(card.labels) == list(cpu.labels), f"{label}: labels or metadata")
    check(bool(np.isfinite(card.features).all()), f"{label}: features are not finite")
    d = float(np.abs(card.features - cpu.features).max())
    if extractor in ("image_classical", "video_classical"):
        flat = card.features.shape[1]
        if extractor == "image_classical":
            exact = bool(np.array_equal(card.features[:, flat - 96 : flat - 6], cpu.features[:, flat - 96 : flat - 6]))
            check(exact, f"{label}: LBP or histogram columns differ card vs CPU")
        check(d <= IMAGE_TOL, f"{label}: card vs CPU {d:.3e}")
        return f"max|d| {d:.3e} (tol {IMAGE_TOL:g})" + (", LBP and histogram bit for bit" if extractor == "image_classical" else "")
    if extractor in ("image_pixels", "video_frame_seq"):
        check(d == 0.0, f"{label}: pixels differ card vs CPU")
        return "equal"
    scale = float(np.abs(cpu.features).max())
    check(d <= EMBED_TOL * scale, f"{label}: embeddings card vs CPU {d:.3e} of {scale:.3e}")
    return f"max|d| {d:.3e}, {d / scale:.3e} of the largest (tol {EMBED_TOL:g})"


def phase_4i(dev, tmp: Path) -> dict:
    """Phase 4i: the image modality. An image_folder tree and a birdeep_image
    tree (``write_image_trees``) through the extraction CLI with
    image_classical (128 x 128, 8196 dims), image_pixels and
    image_mobilenet_v2 (224, 1280 dims, a weights .npz written by the port
    from seeded weights), on the card and on the CPU (check_image_set); the
    train CLI's mlp for 2 epochs on the folder's image_classical set; then
    ``classical_image_vector_batch`` at B=IMAGE_BATCH x 128 x 128 and the
    embedder at B=32 and 256 x 224 timed."""
    import importlib.util
    import torch

    from audio_edge_ml_pipeline_torch.features.image import ImageClassicalExtractor
    from audio_edge_ml_pipeline_torch.models.backbones import mobilenet_v2_embedder
    from audio_edge_ml_pipeline_torch.ops import imgdsp
    from audio_edge_ml_pipeline_torch.train import train

    t_start = time.perf_counter()
    rng = np.random.default_rng(17)
    out: dict = {}
    weights = seeded_mobilenet_weights(tmp / "mbv2_seeded.npz")
    if importlib.util.find_spec("PIL") is None:
        print("[4i] PIL is not installed: the extraction CLI's image paths (image_folder, birdeep_image loaders; "
              "image_classical, image_pixels, image_mobilenet_v2) cannot run; the batched path is driven on numpy images")
        ex = ImageClassicalExtractor()
        images = rng.random((IMAGE_BATCH + 3, 128, 128), dtype=np.float32)
        loader = [(Path(f"{i}.png"), f"c{i % 4}", {}) for i in range(len(images))]
        from audio_edge_ml_pipeline_torch.features.base import _device_batched_dataset, pad_stack

        fs = _device_batched_dataset(loader, None, decode=lambda p, m: images[int(p.stem)],
                                     pack=lambda d: pad_stack(d, ex.batch_size), run=imgdsp.classical_image_vector_batch,
                                     unpack=lambda o, d: o[: len(d)], chunk=ex.batch_size, feature_type="classical",
                                     modality="image", device=dev)
        check(fs.features.shape == (len(images), 8196), "4i: the batched path on numpy images")
    else:
        folder, bird, bird_rows = write_image_trees(tmp / "images", rng)
        exps = [{"name": "classical", "extractor": "image_classical"},
                {"name": "pixels", "extractor": "image_pixels"},
                {"name": "mobilenet", "extractor": "image_mobilenet_v2", "extractor_params": {"weights": str(weights)}}]
        shapes = {"classical": (8196,), "pixels": (64, 64, 1), "mobilenet": (1280,)}
        for tag, dataset, loader, split, rows in (
                ("folder", folder, "image_folder", "all", IMAGE_CLASSES * IMAGE_PER_CLASS),
                ("birdeep", bird, "birdeep_image", "train", bird_rows["train"])):
            runs = card_vs_cpu(tmp, f"img_{tag}", dataset, loader, split, exps)
            for e in exps:
                card, cpu = runs[e["name"]]
                check(card.features.shape[1:] == shapes[e["name"]], f"4i: {tag} {e['name']} shape {card.features.shape}")
                cmp = check_image_set(f"4i {tag} {e['name']}", e["extractor"], card, cpu, rows)
                print(f"[4i] {e['extractor']} on the {loader} tree ({split}): {card}; card vs CPU {cmp}")
            print(f"[4i] the {loader} tree's three extractors through the CLI: card {runs['card_s']:.2f} s, "
                  f"CPU {runs['cpu_s']:.2f} s")
            if tag == "birdeep":
                boxes = sum("bbox_norm" in m for m in runs["classical"][0].metadata)
                check(0 < boxes < rows, f"4i: {boxes} of {rows} BIRDeep rows carry a bbox_norm")
        os.environ["MLFLOW_TRACKING_URI"] = str(tmp / "img_mlruns")
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            train.main(["--features", str(tmp / "img_folder" / "card" / "classical"), "--model", "mlp", "--output",
                        str(tmp / "img_models"), "--experiment", "chip-smoke-image", "--param", "epochs=2"])
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
            os.environ.pop("MLFLOW_TRACKING_URI")
        bundles = sorted(p.name for p in (tmp / "img_models").rglob("model.flax.npz"))
        print(f"[4i] the train CLI's mlp, 2 epochs on the image_classical FeatureSet (64 x 8196) on the card: "
              f"{time.perf_counter() - t0:.2f} s, bundles {bundles}")
        check(len(bundles) == 1, "4i: the mlp on image features wrote no bundle")

    imgs = torch.rand((IMAGE_BATCH, 128, 128), device=dev, generator=torch.Generator(dev).manual_seed(3))
    out["image_ms"] = cuda_ms(lambda: imgdsp.classical_image_vector_batch(imgs), iters=10)
    out["image_parts_ms"] = {name: cuda_ms(lambda fn=fn: fn(imgs), iters=10) for name, fn in (
        ("hog", imgdsp.hog_features_batch), ("lbp", imgdsp.lbp_histogram_batch),
        ("gray_hist", imgdsp.gray_hist_batch), ("glcm", imgdsp.glcm_stats_batch))}
    embed = mobilenet_v2_embedder(224, str(weights), device=dev)
    out["embed_ms"] = {}
    with torch.inference_mode():
        for b in EMBED_BATCHES:
            x = torch.rand((b, 224, 224, 3), device=dev) * 2 - 1
            out["embed_ms"][b] = cuda_ms(lambda: embed(x), iters=10)
    print(f"[4i] phase 4i in {time.perf_counter() - t_start:.2f} s")
    return out


def write_video_tree(root: Path, rng: np.random.Generator) -> Path:
    """VIDEO_CLASSES classes x VIDEO_PER_CLASS MJPG clips of VIDEO_FRAMES
    frames at 96 x 80, written with cv2: a class-coloured square moving
    across noise."""
    import cv2

    for c in range(VIDEO_CLASSES):
        (root / f"class{c}").mkdir(parents=True)
        for i in range(VIDEO_PER_CLASS):
            w = cv2.VideoWriter(str(root / f"class{c}" / f"{i}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10, (96, 80))
            check(w.isOpened(), "4j: cv2 cannot write MJPG")
            for f in range(VIDEO_FRAMES):
                frame = rng.integers(0, 60, (80, 96, 3), dtype=np.uint8)
                x = (4 * f + 9 * i) % 70
                frame[20 + 10 * c : 40 + 10 * c, x : x + 24] = (200 - 60 * c, 90 + 50 * c, 60 + 30 * i)
                w.write(frame)
            w.release()
    return root


def phase_4j(dev, tmp: Path) -> None:
    """Phase 4j: the video modality. A video_folder tree written with cv2
    through the extraction CLI with video_classical (optical flow on),
    video_frame_seq and video_mobilenet_v2_seq (224, phase 4i's seeded
    weights) on the card and on the CPU, at the image gates."""
    import importlib.util

    t_start = time.perf_counter()
    if importlib.util.find_spec("cv2") is None:
        print("[4j] cv2 is not installed: the extraction CLI's video paths (video_folder loader; video_classical, "
              "video_frame_seq, video_mobilenet_v2_seq) cannot run")
        return
    tree = write_video_tree(tmp / "videos", np.random.default_rng(23))
    weights = tmp / "mbv2_seeded.npz"
    exps = [{"name": "classical", "extractor": "video_classical", "extractor_params": {"optical_flow": True}},
            {"name": "frames", "extractor": "video_frame_seq"},
            {"name": "mobilenet", "extractor": "video_mobilenet_v2_seq", "extractor_params": {"weights": str(weights)}}]
    shapes = {"classical": (2 * (4 * 9 * 9 + 26 + 64 + 6) + 10,), "frames": (16, 64, 64, 3), "mobilenet": (16, 1280)}
    runs = card_vs_cpu(tmp, "video", tree, "video_folder", "all", exps)
    for e in exps:
        card, cpu = runs[e["name"]]
        check(card.features.shape[1:] == shapes[e["name"]], f"4j: {e['name']} shape {card.features.shape}")
        cmp = check_image_set(f"4j {e['name']}", e["extractor"], card, cpu, VIDEO_CLASSES * VIDEO_PER_CLASS)
        print(f"[4j] {e['extractor']} on the video_folder tree: {card}; card vs CPU {cmp}")
    print(f"[4j] the three video extractors through the CLI: card {runs['card_s']:.2f} s, CPU {runs['cpu_s']:.2f} s; "
          f"phase 4j in {time.perf_counter() - t_start:.2f} s")


# ---------------------------------------------------------------------------
# 4k-4l: the text and tabular modalities
# ---------------------------------------------------------------------------

TEXT_CLASSES, TEXT_PER_CLASS = 20, 200           # 20 Newsgroups' 20 classes; 200 documents a class (it has ~940)
TEXT_TOKENS = (80, 240)                          # tokens a document
TEXT_VOCAB, TEXT_ZIPF = 30_000, 1.1              # pseudo-words drawn by Zipf(1.1) rank
TEXT_TOPIC_WORDS, TEXT_TOPIC_SHARE = 40, 0.15    # a class's topic words, and the share of tokens drawn from them
TEXT_SUBSET = 50                                 # documents a class in the 1,000-document subset
TEXT_SMALL = (4, 5)                              # classes x documents of the text_folder / text_json trees
TFIDF_TOL = 1e-7                                 # tfidf and char n-gram rows card vs CPU (tests/test_torch_text.py)
LSA_TOL = 1e-5                                   # LSA rows card vs CPU
SV_REL_TOL = 1e-6                                # top 10 randomized singular values vs an exact float64 decomposition
ADULT_ROWS = 32_561                              # UCI Adult's training file
ADULT_SUBSET = 500                               # rows of the sqlite and jsonl copies
TABULAR_TOL = 1e-6                               # card vs CPU, of each column's largest |value|
ADULT_NUMERIC = ("age", "fnlwgt", "education-num", "capital-gain", "capital-loss", "hours-per-week")
ADULT_CATEGORIES = {                             # adult.names, in its order; '?' cells become missing values
    "workclass": ["Private", "Self-emp-not-inc", "Self-emp-inc", "Federal-gov", "Local-gov", "State-gov",
                  "Without-pay", "Never-worked"],
    "education": ["Bachelors", "Some-college", "11th", "HS-grad", "Prof-school", "Assoc-acdm", "Assoc-voc", "9th",
                  "7th-8th", "12th", "Masters", "1st-4th", "10th", "Doctorate", "5th-6th", "Preschool"],
    "marital-status": ["Married-civ-spouse", "Divorced", "Never-married", "Separated", "Widowed",
                       "Married-spouse-absent", "Married-AF-spouse"],
    "occupation": ["Tech-support", "Craft-repair", "Other-service", "Sales", "Exec-managerial", "Prof-specialty",
                   "Handlers-cleaners", "Machine-op-inspct", "Adm-clerical", "Farming-fishing", "Transport-moving",
                   "Priv-house-serv", "Protective-serv", "Armed-Forces"],
    "relationship": ["Wife", "Own-child", "Husband", "Not-in-family", "Other-relative", "Unmarried"],
    "race": ["White", "Asian-Pac-Islander", "Amer-Indian-Eskimo", "Other", "Black"],
    "sex": ["Female", "Male"],
    "native-country": ["United-States", "Cambodia", "England", "Puerto-Rico", "Canada", "Germany",
                       "Outlying-US(Guam-USVI-etc)", "India", "Japan", "Greece", "South", "China", "Cuba", "Iran",
                       "Honduras", "Philippines", "Italy", "Poland", "Jamaica", "Vietnam", "Mexico", "Portugal",
                       "Ireland", "France", "Dominican-Republic", "Laos", "Ecuador", "Taiwan", "Haiti", "Columbia",
                       "Hungary", "Guatemala", "Nicaragua", "Scotland", "Thailand", "Yugoslavia", "El-Salvador",
                       "Trinadad&Tobago", "Peru", "Hong", "Holand-Netherlands"],
}
ADULT_MISSING = {"workclass": 0.056, "occupation": 0.057, "native-country": 0.018}   # the '?' shares of adult.data
ADULT_COLUMNS = ("age", "workclass", "fnlwgt", "education", "education-num", "marital-status", "occupation",
                 "relationship", "race", "sex", "capital-gain", "capital-loss", "hours-per-week", "native-country",
                 "income")


def text_corpus(rng: np.random.Generator) -> tuple[list[str], list[str]]:
    """TEXT_CLASSES x TEXT_PER_CLASS documents shaped like 20 Newsgroups:
    TEXT_TOKENS tokens a document from a Zipf(TEXT_ZIPF) vocabulary of
    TEXT_VOCAB pseudo-words of 1-5 syllables (onset, nucleus, coda),
    TEXT_TOPIC_SHARE of them from the class's topic words, in capitalised
    sentences of 12 words."""
    onsets = list("bcdfghjklmnprstvwz") + ["br", "cr", "dr", "st", "th", "ch", "sh", "pl", "gr", "tr"]
    nuclei = list("aeiou") + ["ai", "ou", "ee", "ea"]
    codas = ["", "", "", "n", "r", "s", "t", "l", "m", "nd", "st"]
    seen: set[str] = set()
    words: list[str] = []
    while len(words) < TEXT_VOCAB:
        w = "".join(onsets[rng.integers(len(onsets))] + nuclei[rng.integers(len(nuclei))] + codas[rng.integers(len(codas))]
                    for _ in range(int(rng.integers(1, 6))))
        if w not in seen:
            seen.add(w)
            words.append(w)
    vocab = np.array(words)
    p = 1.0 / np.arange(1, TEXT_VOCAB + 1) ** TEXT_ZIPF
    p /= p.sum()
    docs, labels = [], []
    for c in range(TEXT_CLASSES):
        topic = vocab[rng.choice(np.arange(100, TEXT_VOCAB), TEXT_TOPIC_WORDS, replace=False)]
        lengths = rng.integers(TEXT_TOKENS[0], TEXT_TOKENS[1] + 1, TEXT_PER_CLASS)
        tokens = vocab[rng.choice(TEXT_VOCAB, int(lengths.sum()), p=p)]
        mix = rng.random(len(tokens)) < TEXT_TOPIC_SHARE
        tokens[mix] = topic[rng.integers(0, TEXT_TOPIC_WORDS, int(mix.sum()))]
        for piece in np.split(tokens, np.cumsum(lengths)[:-1]):
            sentences = [" ".join(piece[i : i + 12]) for i in range(0, len(piece), 12)]
            docs.append(". ".join(s.capitalize() for s in sentences) + ".")
            labels.append(f"group{c:02d}")
    return docs, labels


def write_text_csv(path: Path, docs: list[str], labels: list[str]) -> Path:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["text", "label"])
        w.writerows(zip(docs, labels))
    return path


def write_text_trees(root: Path, docs: list[str], labels: list[str]) -> tuple[Path, Path, Path]:
    """TEXT_SMALL classes x documents as a text_folder tree, a text_json
    array in the folder's order and a text_csv file of the same documents."""
    picked = [(label, d) for c in range(TEXT_SMALL[0]) for label, d in
              [(labels[i], docs[i]) for i in range(c * TEXT_PER_CLASS, c * TEXT_PER_CLASS + TEXT_SMALL[1])]]
    for k, (label, d) in enumerate(picked):
        (root / "folder" / label).mkdir(parents=True, exist_ok=True)
        (root / "folder" / label / f"{k:03d}.txt").write_text(d)
    (root / "docs.json").write_text(json.dumps([{"text": d, "label": label} for label, d in picked]))
    return root / "folder", root / "docs.json", write_text_csv(root / "small.csv", [d for _, d in picked],
                                                              [label for label, _ in picked])


class recorded_extractors:
    """Within the block, every FeaturePipeline.run appends its extractor to
    the list it yields (the fitted vectorizers and transforms of a CLI run)."""

    def __enter__(self) -> list:
        from audio_edge_ml_pipeline_torch.features import pipeline

        self.seen: list = []
        self.run = pipeline.FeaturePipeline.run
        seen, run = self.seen, self.run

        def recording(pipe, max_samples=None):
            seen.append(pipe.extractor)
            return run(pipe, max_samples)

        pipeline.FeaturePipeline.run = recording
        return self.seen

    def __exit__(self, *exc) -> None:
        from audio_edge_ml_pipeline_torch.features import pipeline

        pipeline.FeaturePipeline.run = self.run


def cli_side(tmp: Path, tag: str, exps: list[dict], device: str | None) -> tuple[float, list]:
    """``exps`` (each naming its dataset and loader) through the extraction
    CLI, on the card or with ``device``: the seconds and the extractors."""
    import torch

    from audio_edge_ml_pipeline_torch.features import pipeline

    cfg = extraction_config(tmp / f"{tag}.json", exps[0]["dataset"], exps[0]["loader"], "all", exps, tmp / tag)
    t0 = time.perf_counter()
    with recorded_extractors() as seen:
        pipeline.main(["--config", str(cfg), *(["--device", device] if device else [])])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, list(seen)


def train_and_serve(tmp: Path, tag: str, features: Path, model: str, epochs: int | None) -> tuple[float, float]:
    """The train CLI's ``model`` on ``features`` on the card, its bundle
    served on the card and on the CPU: (seconds, largest logit or decision
    gap over 8 rows, relative to the largest for a classical model)."""
    import torch

    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.models import get_model
    from audio_edge_ml_pipeline_torch.models.deep import MODEL_FILENAME, load_any_model
    from audio_edge_ml_pipeline_torch.train import train

    out = tmp / f"{tag}_models"
    os.environ["MLFLOW_TRACKING_URI"] = str(tmp / f"{tag}_mlruns")
    cwd = os.getcwd()
    os.chdir(tmp)
    t0 = time.perf_counter()
    try:
        train.main(["--features", str(features), "--model", model, "--output", str(out), "--experiment",
                    f"chip-smoke-{tag}", *(["--param", f"epochs={epochs}"] if epochs else [])])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        os.environ.pop("MLFLOW_TRACKING_URI")
    seconds = time.perf_counter() - t0
    X = pipeline.FeaturePipeline.load(features).features[:8]
    if model == "lda":
        (bundle,) = out.rglob("lda.npz")
        card, cpu = get_model("lda").load(bundle), get_model("lda").load(bundle, device="cpu")
        check(card.device.type == "cuda", f"{tag}: the lda bundle is not served on the card")
        dec_card, dec_cpu = card._decision(X), cpu._decision(X)
        return seconds, float(np.abs(dec_card - dec_cpu).max() / np.abs(dec_cpu).max())
    (bundle,) = out.rglob(MODEL_FILENAME)
    card, cpu = load_any_model(bundle), load_any_model(bundle, device="cpu")
    check(card.device.type == "cuda", f"{tag}: the {model} bundle is not served on the card")
    return seconds, float(np.abs(card._batched_logits(card._prepare_input(X)) -
                                 cpu._batched_logits(cpu._prepare_input(X))).max())


def phase_4k(dev, tmp: Path, card: str) -> None:
    """Phase 4k: the text modality. A seeded corpus shaped like 20
    Newsgroups (``text_corpus``) as a text_csv file, and a few of its
    documents as text_folder and text_json trees, through the extraction
    CLI at the extractors' defaults: text_tfidf (10,000 columns), text_bow
    and text_bert_tokens on all 4,000 documents on the card and on the CPU,
    text_sentence_embed (LSA of 4,000 x 20,000 -> 384) on the card,
    text_char_ngram (50,000 columns) and the LSA on a 1,000-document subset
    on both. Checks: vocabularies equal, bow and token ids equal, tfidf and
    char rows within TFIDF_TOL, LSA rows within LSA_TOL, the top 10
    singular values within SV_REL_TOL of an exact float64 decomposition of
    the same TF-IDF matrix on the card (the eigenvalues of its Gram
    matrix), the weighting, IDF and SVD on the card; the three small trees
    give one FeatureSet. Then the train CLI's mlp (2 epochs) on the tfidf
    set and lda on the LSA set, each served card vs CPU."""
    import torch

    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.features.vectorize import TfidfVectorizer
    from audio_edge_ml_pipeline_torch.ops.lsa import truncated_svd

    t_start = time.perf_counter()
    root = tmp / "text"
    root.mkdir()
    docs, labels = text_corpus(np.random.default_rng(29))
    full = write_text_csv(root / "corpus.csv", docs, labels)
    sub = [i for c in range(TEXT_CLASSES) for i in range(c * TEXT_PER_CLASS, c * TEXT_PER_CLASS + TEXT_SUBSET)]
    subset = write_text_csv(root / "subset.csv", [docs[i] for i in sub], [labels[i] for i in sub])
    print(f"[4k] corpus: {len(docs)} documents in {TEXT_CLASSES} classes, "
          f"{sum(len(d.split()) for d in docs) / len(docs):.1f} tokens a document (Zipf {TEXT_ZIPF} over "
          f"{TEXT_VOCAB} pseudo-words, {TEXT_TOPIC_SHARE:.0%} topic words); a {len(sub)}-document subset")

    def exp(name, extractor, dataset):
        return {"name": name, "extractor": extractor, "loader": "text_csv", "dataset": str(dataset),
                "label_col": "label"}

    both = [exp("tfidf", "text_tfidf", full), exp("bow", "text_bow", full), exp("tokens", "text_bert_tokens", full),
            exp("char", "text_char_ngram", subset), exp("lsa_subset", "text_sentence_embed", subset)]
    card_s, card_ex = cli_side(tmp, "text_card", both + [exp("lsa", "text_sentence_embed", full)], None)
    cpu_s, cpu_ex = cli_side(tmp, "text_cpu", both, "cpu")
    print(f"[4k] the extraction CLI, 6 experiments on the card: {card_s:.2f} s; the 5 on both sides on the CPU: "
          f"{cpu_s:.2f} s ({card})")
    sets = {side: {name: pipeline.FeaturePipeline.load(tmp / f"text_{side}" / name) for name in names}
            for side, names in (("card", [e["name"] for e in both] + ["lsa"]), ("cpu", [e["name"] for e in both]))}
    shapes = {"tfidf": (4000, 10_000), "bow": (4000, 10_000), "tokens": (4000, 128), "char": (1000, 50_000),
              "lsa_subset": (1000, 384), "lsa": (4000, 384)}
    for e, ex_card, ex_cpu in zip(both, card_ex, cpu_ex):
        name = e["name"]
        c, p = sets["card"][name], sets["cpu"][name]
        check(c.features.shape == shapes[name] == p.features.shape, f"4k {name}: shape {c.features.shape}")
        check(list(c.labels) == list(p.labels) and c.label_names == p.label_names, f"4k {name}: labels")
        d = float(np.abs(c.features.astype(np.float64) - p.features).max())
        if name in ("tfidf", "bow", "char"):
            check(ex_card._vectorizer.vocabulary_ == ex_cpu._vectorizer.vocabulary_, f"4k {name}: vocabularies")
            check(ex_card._vectorizer.device.type == "cuda", f"4k {name}: the weighting is not on the card")
        if name in ("bow", "tokens"):
            check(d == 0.0, f"4k {name}: card vs CPU {d:.3e}, must be equal")
        elif name == "lsa_subset":
            check(ex_card._lsa[1].components.device.type == "cuda", "4k: the LSA did not run on the card")
            check(d <= LSA_TOL, f"4k {name}: card vs CPU {d:.3e}")
        else:
            check(d <= TFIDF_TOL, f"4k {name}: card vs CPU {d:.3e}")
        print(f"[4k] {e['extractor']} ({c.features.shape[0]} x {c.features.shape[1]}): card vs CPU max|d| {d:.3e}"
              + (f", vocabularies equal ({len(ex_card._vectorizer.vocabulary_)} terms)" if name in ("tfidf", "bow", "char")
                 else ""))

    # the weighting and the LSA timed, and the LSA's spectrum against an exact decomposition
    tfidf_card, tfidf_cpu = card_ex[0]._vectorizer, cpu_ex[0]._vectorizer
    check(tfidf_card.idf_.device.type == "cuda", "4k: the IDF is not on the card")
    counts = tfidf_card.counts(docs)
    weigh_ms = cuda_ms(lambda: tfidf_card.weigh(counts), iters=10)
    weigh_cpu_ms = host_ms(lambda: tfidf_cpu.weigh(counts))
    vec, svd = card_ex[-1]._lsa
    X = vec.transform(docs, dtype=torch.float64)
    exact = torch.linalg.eigvalsh(X @ X.T).flip(0)[:10].clamp_min(0).sqrt()
    sv_rel = float(((svd.singular_values[:10] - exact).abs() / exact).max())
    print(f"[4k] LSA on the card: TF-IDF {tuple(X.shape)} float64, {svd.components.shape[0]} components; top 10 "
          f"singular values {[round(v, 4) for v in exact.tolist()]}, randomized vs exact max rel {sv_rel:.3e} "
          f"(tol {SV_REL_TOL:g})")
    check(svd.singular_values.device.type == "cuda" and sv_rel <= SV_REL_TOL, "4k: the LSA's singular values")
    lsa_ms = cuda_ms(lambda: truncated_svd(X, svd.components.shape[0]), iters=3, warmup=1)
    vec_sub = TfidfVectorizer(max_features=20000, ngram_range=(1, 2), device="cpu")
    X_sub = vec_sub.fit_transform([docs[i] for i in sub], dtype=torch.float64)
    lsa_sub_cpu_ms = host_ms(lambda: truncated_svd(X_sub, 384), reps=1)
    lsa_sub_ms = cuda_ms(lambda: truncated_svd(X_sub.to(dev), 384), iters=3, warmup=1)
    print(f"[4k] times ({card}): TF-IDF weighting of {counts.n_rows} x {counts.n_cols} (nnz {len(counts.data)}) "
          f"{weigh_ms:.3f} ms on the card, {weigh_cpu_ms:.1f} ms on the CPU; LSA of {X.shape[0]} x {X.shape[1]} -> "
          f"{svd.components.shape[0]} {lsa_ms:.1f} ms on the card; of {X_sub.shape[0]} x {X_sub.shape[1]} -> 384 "
          f"{lsa_sub_ms:.1f} ms on the card, {lsa_sub_cpu_ms:.1f} ms on the CPU")

    # the text_folder, text_json and text_csv trees of the same documents
    folder, js, small = write_text_trees(root / "small", docs, labels)
    small_exps = [{"name": f"bow_{loader}", "extractor": "text_bow", "loader": loader, "dataset": str(ds),
                   "label_col": "label", "extractor_params": {"min_df": 1}}
                  for loader, ds in (("text_folder", folder), ("text_json", js), ("text_csv", small))]
    cli_side(tmp, "text_small", small_exps, None)
    smalls = [pipeline.FeaturePipeline.load(tmp / "text_small" / e["name"]) for e in small_exps]
    same = all(np.array_equal(s.features, smalls[0].features) and list(s.labels) == list(smalls[0].labels)
               for s in smalls)
    print(f"[4k] text_folder, text_json and text_csv trees of the same {len(smalls[0].features)} documents: "
          f"text_bow {smalls[0].features.shape}, equal {same}")
    check(same and smalls[0].features.shape[0] == TEXT_SMALL[0] * TEXT_SMALL[1], "4k: the three text loaders differ")

    mlp_s, mlp_gap = train_and_serve(tmp, "text_mlp", tmp / "text_card" / "tfidf", "mlp", 2)
    lda_s, lda_gap = train_and_serve(tmp, "text_lda", tmp / "text_card" / "lsa", "lda", None)
    print(f"[4k] the train CLI on the card ({card}): mlp 2 epochs on the tfidf set {mlp_s:.2f} s, served logits "
          f"card vs CPU max|d| {mlp_gap:.3e} (tol {LOGIT_TOL:g}); lda on the LSA set {lda_s:.2f} s, decisions card "
          f"vs CPU {lda_gap:.3e} of their largest (tol {LOGIT_TOL:g})")
    check(mlp_gap <= LOGIT_TOL and lda_gap <= LOGIT_TOL, "4k: a served text model differs card vs CPU")
    print(f"[4k] phase 4k in {time.perf_counter() - t_start:.2f} s ({card})")


def adult_frame(rng: np.random.Generator):
    """ADULT_ROWS seeded rows with UCI Adult's schema (ADULT_COLUMNS): six
    numeric columns in Adult's ranges, eight categorical ones with Adult's
    99 categories (each present), missing cells where Adult has '?'
    (ADULT_MISSING), and an income label that depends on the features."""
    import pandas as pd

    n = ADULT_ROWS
    cols: dict = {}
    for name, cats in ADULT_CATEGORIES.items():
        p = 1.0 / np.arange(1, len(cats) + 1) ** 1.5
        idx = rng.choice(len(cats), n, p=p / p.sum())
        idx[: len(cats)] = np.arange(len(cats))             # every category present
        col = np.array(cats, dtype=object)[idx]
        if name in ADULT_MISSING:
            col[len(cats):][rng.random(n - len(cats)) < ADULT_MISSING[name]] = np.nan
        cols[name] = col
    edu = {c: i + 1 for i, c in enumerate(ADULT_CATEGORIES["education"])}
    cols["age"] = np.clip(rng.normal(38.6, 13.6, n), 17, 90).astype(np.int64)
    cols["fnlwgt"] = np.clip(rng.lognormal(12.0, 0.5, n), 12285, 1484705).astype(np.int64)
    cols["education-num"] = np.array([edu[c] for c in cols["education"]], np.int64)
    cols["capital-gain"] = np.where(rng.random(n) < 0.083, np.clip(rng.lognormal(8.5, 1.0, n), 114, 99999), 0).astype(np.int64)
    cols["capital-loss"] = np.where(rng.random(n) < 0.047, rng.integers(155, 4357, n), 0).astype(np.int64)
    cols["hours-per-week"] = np.clip(rng.normal(40.4, 12.3, n), 1, 99).astype(np.int64)
    score = (0.04 * (cols["age"] - 38) + 0.3 * (cols["education-num"] - 8) + 0.03 * (cols["hours-per-week"] - 40)
             + 0.0004 * cols["capital-gain"] + rng.normal(0, 1, n))
    cols["income"] = np.where(score > np.quantile(score, 0.76), ">50K", "<=50K")
    return pd.DataFrame({c: cols[c] for c in ADULT_COLUMNS})


def phase_4l(dev, tmp: Path, card: str) -> None:
    """Phase 4l: the tabular modality. A seeded CSV with UCI Adult's schema
    (``adult_frame``: 32,561 rows, 6 numeric and 8 categorical columns, 99
    categories) through the extraction CLI, tabular_classical (6 + 99 = 105
    columns) and tabular_polynomial (27 + 99 = 126) each with the standard,
    minmax and robust scalers, on the card and on the CPU: card vs CPU within
    TABULAR_TOL of each column's largest value, the statistics on the card;
    the sqlite and jsonl copies of its first ADULT_SUBSET rows through the
    same CLI as the CSV of those rows; the train CLI's mlp (2 epochs) on the
    standard classical set served card vs CPU; the transform timed at 32,561
    rows."""
    import sqlite3

    import pandas as pd
    import torch

    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.features.preprocess import ColumnStack
    from audio_edge_ml_pipeline_torch.features.tabular import _expand_datetimes

    t_start = time.perf_counter()
    root = tmp / "tabular"
    root.mkdir()
    df = adult_frame(np.random.default_rng(31))
    adult = root / "adult.csv"
    df.to_csv(adult, index=False)
    head = df.head(ADULT_SUBSET)
    head.to_csv(root / "head.csv", index=False)
    head.to_json(root / "head.jsonl", orient="records", lines=True)
    with sqlite3.connect(root / "head.sqlite") as con:
        head.to_sql("adult", con, index=False)
    missing = {c: int(df[c].isna().sum()) for c in ADULT_MISSING}
    print(f"[4l] Adult-schema table: {len(df)} rows, {len(ADULT_NUMERIC)} numeric and {len(ADULT_CATEGORIES)} "
          f"categorical columns, missing cells {missing}, income >50K {float((df['income'] == '>50K').mean()):.3f}")

    exps = [{"name": f"{ex.split('_')[1]}_{scaler}", "extractor": ex, "loader": "tabular", "dataset": str(adult),
             "label_col": "income", "extractor_params": {"scaler": scaler}}
            for ex in ("tabular_classical", "tabular_polynomial") for scaler in ("standard", "minmax", "robust")]
    card_s, card_ex = cli_side(tmp, "tab_card", exps, None)
    cpu_s, _ = cli_side(tmp, "tab_cpu", exps, "cpu")
    print(f"[4l] the extraction CLI, 6 experiments of {ADULT_ROWS} rows: card {card_s:.2f} s, CPU {cpu_s:.2f} s ({card})")
    for e, ex in zip(exps, card_ex):
        c = pipeline.FeaturePipeline.load(tmp / "tab_card" / e["name"])
        p = pipeline.FeaturePipeline.load(tmp / "tab_cpu" / e["name"])
        width = 105 if e["extractor"] == "tabular_classical" else 126
        check(c.features.shape == p.features.shape == (ADULT_ROWS, width), f"4l {e['name']}: shape {c.features.shape}")
        check(list(c.labels) == list(p.labels), f"4l {e['name']}: labels")
        scale = np.abs(p.features).max(axis=0)
        gap = float((np.abs(c.features - p.features) / np.where(scale > 0, scale, 1.0)).max())
        stats = ex._transformer.num_imputer.statistics_
        check(stats.device.type == "cuda" and ex._transformer.scaler.scale_.device.type == "cuda",
              f"4l {e['name']}: the statistics are not on the card")
        check(gap <= TABULAR_TOL, f"4l {e['name']}: card vs CPU {gap:.3e} of a column's largest")
        print(f"[4l] {e['extractor']} scaler {e['extractor_params']['scaler']}: {c.features.shape}, card vs CPU "
              f"{gap:.3e} of each column's largest (tol {TABULAR_TOL:g}); medians {[round(v, 1) for v in stats.tolist()]}")

    small = [{"name": f"classical_{fmt}", "extractor": "tabular_classical", "loader": "tabular",
              "dataset": str(root / f"head.{fmt}"), "label_col": "income"} for fmt in ("csv", "sqlite", "jsonl")]
    cli_side(tmp, "tab_small", small, None)
    heads = [pipeline.FeaturePipeline.load(tmp / "tab_small" / e["name"]) for e in small]
    same = all(np.abs(h.features - heads[0].features).max() <= TABULAR_TOL and list(h.labels) == list(heads[0].labels)
               for h in heads)
    print(f"[4l] the first {ADULT_SUBSET} rows as csv, sqlite and jsonl through the CLI: {heads[0].features.shape}, "
          f"equal {same}")
    check(same and heads[0].features.shape[0] == ADULT_SUBSET, "4l: the csv, sqlite and jsonl copies differ")

    mlp_s, mlp_gap = train_and_serve(tmp, "tab_mlp", tmp / "tab_card" / "classical_standard", "mlp", 2)
    print(f"[4l] the train CLI's mlp, 2 epochs on the classical set on the card: {mlp_s:.2f} s ({card}); served "
          f"logits card vs CPU max|d| {mlp_gap:.3e} (tol {LOGIT_TOL:g})")
    check(mlp_gap <= LOGIT_TOL, "4l: the served mlp differs card vs CPU")

    frame = _expand_datetimes(pd.read_csv(adult).drop(columns=["income"]))   # the rows the extractor sees
    num, cat = list(ADULT_NUMERIC), list(ADULT_CATEGORIES)

    def transform(device):
        return lambda: ColumnStack(num, cat, "median", "most_frequent", "standard", None,
                                   torch.device(device)).fit_transform(frame).cpu()

    ms_card, ms_cpu = host_ms(transform(dev)), host_ms(transform("cpu"))
    print(f"[4l] times ({card}): the classical transform (impute, scale, one-hot) of {ADULT_ROWS} rows, host "
          f"coding included: {ms_card:.1f} ms on the card, {ms_cpu:.1f} ms on the CPU; phase 4l in "
          f"{time.perf_counter() - t_start:.2f} s")


# ---------------------------------------------------------------------------
# 5h: the serving loop with the REST tracking backend
# ---------------------------------------------------------------------------


def rest_stub(artifacts: dict):
    """A small stdlib stub of the MLflow REST surface the tracker speaks
    (tests/test_tracking_rest.py's): experiments/create + get-by-name,
    runs/create + update, log-batch, log-metric, log-parameter, set-tag,
    runs/search, runs/get, and the mlflow-artifacts proxy, whose uploads land
    in ``artifacts``. Binds 127.0.0.1 on port 0. Returns (server, its URL)."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    experiments: dict[str, dict] = {}
    runs: dict[str, dict] = {}

    def run_obj(run: dict) -> dict:
        return {"info": run["info"], "data": {kind: [{"key": k, "value": v} for k, v in run[kind].items()]
                                              for kind in ("params", "metrics", "tags")}}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length") or 0))

        def do_GET(self):  # noqa: N802
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            if url.path.endswith("/experiments/get-by-name"):
                for e in experiments.values():
                    if e["name"] == q.get("experiment_name"):
                        return self._json(200, {"experiment": e})
                return self._json(404, {"error_code": "RESOURCE_DOES_NOT_EXIST", "message": "no experiment"})
            if url.path.endswith("/runs/get") and q.get("run_id") in runs:
                return self._json(200, {"run": run_obj(runs[q["run_id"]])})
            return self._json(404, {"error_code": "RESOURCE_DOES_NOT_EXIST", "message": url.path})

        def do_PUT(self):  # noqa: N802
            marker = "/api/2.0/mlflow-artifacts/artifacts/"
            if marker not in self.path:
                return self._json(404, {"error_code": "ENDPOINT_NOT_FOUND", "message": self.path})
            artifacts[urllib.parse.unquote(self.path.split(marker, 1)[1])] = self._body()
            return self._json(200, {})

        def do_POST(self):  # noqa: N802
            p = json.loads(self._body() or b"{}")
            path = self.path
            if path.endswith("/experiments/create"):
                if any(e["name"] == p["name"] for e in experiments.values()):
                    return self._json(400, {"error_code": "RESOURCE_ALREADY_EXISTS", "message": p["name"]})
                eid = str(len(experiments) + 1)
                experiments[eid] = {"experiment_id": eid, "name": p["name"]}
                return self._json(200, {"experiment_id": eid})
            if path.endswith("/runs/create"):
                rid = f"r{len(runs) + 1:08d}"
                info = {"run_id": rid, "run_uuid": rid, "experiment_id": str(p["experiment_id"]),
                        "run_name": p.get("run_name", rid), "status": "RUNNING", "start_time": p.get("start_time", 0),
                        "artifact_uri": f"mlflow-artifacts:/{p['experiment_id']}/{rid}/artifacts"}
                runs[rid] = {"info": info, "params": {}, "metrics": {},
                             "tags": {t["key"]: t["value"] for t in p.get("tags", [])}}
                return self._json(200, {"run": {"info": info}})
            run = runs.get(p.get("run_id"))
            if path.endswith("/runs/update") and run:
                run["info"].update(status=p.get("status", run["info"]["status"]), end_time=p.get("end_time"))
                return self._json(200, {"run_info": run["info"]})
            if path.endswith("/runs/log-metric") and run:
                run["metrics"][p["key"]] = float(p["value"])
                return self._json(200, {})
            if path.endswith("/runs/log-parameter") and run:
                run["params"][p["key"]] = str(p["value"])
                return self._json(200, {})
            if path.endswith("/runs/set-tag") and run:
                run["tags"][p["key"]] = str(p["value"])
                return self._json(200, {})
            if path.endswith("/runs/log-batch") and run:
                run["metrics"].update({m["key"]: float(m["value"]) for m in p.get("metrics", [])})
                run["params"].update({m["key"]: str(m["value"]) for m in p.get("params", [])})
                run["tags"].update({m["key"]: str(m["value"]) for m in p.get("tags", [])})
                return self._json(200, {})
            if path.endswith("/runs/search"):
                ids = {str(e) for e in p.get("experiment_ids", [])}
                status = p["filter"].split("'")[1] if "attributes.status" in p.get("filter", "") else None
                found = sorted((r for r in runs.values() if r["info"]["experiment_id"] in ids
                                and status in (None, r["info"]["status"])),
                               key=lambda r: -int(r["info"]["start_time"] or 0))
                return self._json(200, {"runs": [run_obj(r) for r in found[: int(p.get("max_results", 500))]]})
            return self._json(404, {"error_code": "ENDPOINT_NOT_FOUND", "message": path})

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


SERVE_REQUESTS = 12
SHORTLIST_FIELDS = ("rank", "model", "val_accuracy", "val_f1_macro", "model_size_kb", "features_dir",
                    "features_eval_dir", "class_filter")   # a candidate's fields that do not name its store


def tracked_train(dev, uri: str, features: Path, out: Path, experiment: str) -> float:
    """One 3-epoch flagship cnn run through the train CLI with
    MLFLOW_TRACKING_URI=uri, from a seeded global RNG (dropout) and with
    cuDNN's deterministic algorithms, so that two runs give the same model;
    returns its wall seconds."""
    import torch

    from audio_edge_ml_pipeline_torch.train import train

    os.environ["MLFLOW_TRACKING_URI"] = uri
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.manual_seed(0)
    try:
        t0 = time.perf_counter()
        train.main(["--features", str(features), "--model", "cnn", "--output", str(out), "--experiment", experiment,
                    *(a for k, v in CNN_PARAMS.items() for a in ("--param", f"{k}={json.dumps(v)}")),
                    "--param", f"epochs={TRAIN_EPOCHS}"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        os.environ.pop("MLFLOW_TRACKING_URI")


def phase_5h(dev, tmp: Path, folder: Path, class_names: list[str], card: str) -> dict:
    """Phase 5h: the serving loop with the REST tracking backend, on the card.
    The flagship cnn trained through the train CLI against a REST stub (the
    mlflow-artifacts proxy) and against a file store, select against each
    (the same shortlist); the ingestion API on port 0 and SERVE_REQUESTS
    edge-simulator requests on the REST run's bundle at upload_threshold 1.1
    (every one uploaded, one WAV and one sidecar each); the uploads relabelled
    from the telemetry and turned into mel .npy files by the audio_processor
    CLI on the card (3 against golden, all against the CPU); the
    SpectrogramDataset's arrays and labels, scored again by the served bundle
    (the telemetry's predictions and confidences); the dashboard's render."""
    import threading

    import torch

    from audio_edge_ml_pipeline_torch.data.audio_io import load_audio
    from audio_edge_ml_pipeline_torch.models.deep import MODEL_FILENAME, load_any_model
    from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel
    from audio_edge_ml_pipeline_torch.serve import api, audio_processor, dashboard
    from audio_edge_ml_pipeline_torch.serve.edge_simulator import EdgeDeviceSimulator
    from audio_edge_ml_pipeline_torch.train import select
    from audio_edge_ml_pipeline_torch.train.dataset import SpectrogramDataset
    from audio_edge_ml_pipeline_torch.utils import tracking

    t_start = time.perf_counter()
    mel_train = tmp / "shipped" / "fsc22_mel_train"
    artifacts: dict[str, bytes] = {}
    stub, uri = rest_stub(artifacts)
    shortlists = {}
    try:
        # 1-2. the same run against the REST stub and against a file store, in turns after a warm-up run
        # (cuDNN's first choice of its deterministic algorithms), then select against each
        tracked_train(dev, str(tmp / "loop_warmup"), mel_train, tmp / "loop_warmup", "chip-smoke-warmup")
        turns = {"file": [], "rest": []}
        for store in ("file", "rest", "rest", "file"):
            turns[store].append(tracked_train(dev, str(tmp / "loop_mlruns") if store == "file" else uri, mel_train,
                                              tmp / f"loop_{store}", "chip-smoke-loop"))
        file_s, rest_s = (sum(turns[k]) / 2 for k in ("file", "rest"))
        for store, store_uri in (("file", str(tmp / "loop_mlruns")), ("rest", uri)):
            os.environ["MLFLOW_TRACKING_URI"] = store_uri
            try:
                select.main(["--experiment", "chip-smoke-loop", "--output", str(tmp / f"loop_{store}_sl.json")])
            finally:
                os.environ.pop("MLFLOW_TRACKING_URI")
            shortlists[store] = json.loads((tmp / f"loop_{store}_sl.json").read_text())
        newest = {}
        for store, store_uri in (("file", str(tmp / "loop_mlruns")), ("rest", uri)):
            tracking.set_tracking_uri(store_uri)
            newest[store] = tracking.search_runs("chip-smoke-loop")[0]
        tracking.set_tracking_uri(None)
        rest_run = newest["rest"]
    finally:
        stub.shutdown()
        stub.server_close()
    bundle = tmp / "loop_rest" / "cnn" / MODEL_FILENAME
    uploaded = {k.split("/artifacts/", 1)[1]: v for k, v in artifacts.items() if rest_run.run_id in k}
    view = [[{**{k: c[k] for k in SHORTLIST_FIELDS}, "params": sorted(c["params"])} for c in sl["candidates"]]
            for sl in shortlists.values()]
    print(f"[5h] the cnn through the train CLI ({TRAIN_EPOCHS} epochs on 4c's {mel_train.name}), two runs a store in "
          f"turns: file store {file_s:.3f} s ({ms_turns(turns['file'])}), REST stub {rest_s:.3f} s "
          f"({ms_turns(turns['rest'])}), {rest_s - file_s:+.3f} s for REST tracking on {card}; the newest REST "
          f"run logged {len(rest_run.params)} params, {len(rest_run.metrics)} metrics and uploaded "
          f"{sorted(uploaded)} through the mlflow-artifacts proxy; select's shortlist against each store: "
          f"{view[0]}")
    bundles = [np.load(tmp / f"loop_{store}" / "cnn" / MODEL_FILENAME) for store in ("file", "rest")]
    same_bundle = bundles[0].files == bundles[1].files and all(np.array_equal(bundles[0][k], bundles[1][k])
                                                               for k in bundles[0].files)
    print(f"[5h] the newest run of each store: metrics equal {newest['file'].metrics == rest_run.metrics} "
          f"({ {k: round(v, 6) for k, v in rest_run.metrics.items()} }), bundles equal array for array {same_bundle}")
    check(rest_run.status == "FINISHED" and "val_f1_macro" in rest_run.metrics, f"5h: the REST run {rest_run}")
    check(newest["file"].metrics == rest_run.metrics and same_bundle,
          "5h: the same run gave other metrics or weights against the two stores")
    check(uploaded.get(MODEL_FILENAME) == bundle.read_bytes(), "5h: the REST run's bundle was not uploaded as trained")
    check(view[0] == view[1] and len(view[0]) == 2 and set(shortlists["rest"]) == set(shortlists["file"]),
          f"5h: select against REST {view[1]} differs from the file store {view[0]}")
    check(shortlists["rest"]["candidates"][0]["artifact_uri"].startswith("mlflow-artifacts:/"),
          "5h: the REST shortlist's artifact_uri")

    # 3. the ingestion API and the simulator on the card, every request uploaded
    uploads = tmp / "loop_uploads"
    server = api.create_server(uploads, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        sim = EdgeDeviceSimulator(bundle, class_names, folder, device_id="smoke-loop",
                                  api_url=f"http://127.0.0.1:{server.server_address[1]}", upload_threshold=1.1,
                                  telemetry_dir=tmp / "loop_telemetry", stats_dir=tmp / "loop_stats", seed=5)
        mel_kernel.counter.reset()
        t0 = time.perf_counter()
        sim.run(SERVE_REQUESTS)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_launches = mel_kernel.counter.launches
    finally:
        server.shutdown()
        server.server_close()
    events = [json.loads(ln) for ln in (tmp / "loop_telemetry" / "smoke-loop_telemetry.jsonl").read_text().splitlines()]
    sidecars = sorted(uploads.glob("*.json"))
    metas = [json.loads(p.read_text()) for p in sidecars]
    print(f"[5h] edge simulator on the card: {SERVE_REQUESTS} requests with uploads in {serve_s:.3f} s "
          f"({1e3 * serve_s / SERVE_REQUESTS:.1f} ms a request) on {card}; uploaded {sum(e['uploaded'] for e in events)}; "
          f"{len(list(uploads.glob('*.wav')))} WAVs and {len(sidecars)} sidecars stored; mel_rfft launches {serve_launches}")
    check(len(events) == SERVE_REQUESTS and all(e["uploaded"] is True for e in events),
          "5h: an event reads uploaded: false")
    check(len(sidecars) == len(list(uploads.glob("*.wav"))) == SERVE_REQUESTS, "5h: not one WAV and one sidecar an upload")
    check(dict(mel_kernel.counter.by_instantiation) == {"mel_rfft<256, float>": SERVE_REQUESTS},
          f"5h: the simulator launched {dict(mel_kernel.counter.by_instantiation)}")
    check(sorted((m["filename"], m["prediction"], m["confidence"]) for m in metas)
          == sorted((e["clip"], e["prediction"], str(e["confidence"])) for e in events), "5h: sidecars vs telemetry")

    # relabelling: each upload's true class, from the telemetry of the request that sent it
    for path, m in zip(sidecars, metas):
        m["true_class"] = next(e["true_class"] for e in events
                               if e["clip"] == m["filename"] and str(e["confidence"]) == m["confidence"])
        path.write_text(json.dumps(m, indent=2))

    # 4. the audio_processor CLI on the card, then the CPU
    mel_kernel.counter.reset()
    t0 = time.perf_counter()
    audio_processor.main(["--input", str(uploads), "--output", str(tmp / "loop_processed")])
    torch.cuda.synchronize()
    proc_s = time.perf_counter() - t0
    proc_launches = dict(mel_kernel.counter.by_instantiation)
    audio_processor.main(["--input", str(uploads), "--output", str(tmp / "loop_processed_cpu"), "--device", "cpu"])
    npys = sorted((tmp / "loop_processed").glob("*.npy"))
    card_cpu = max(float(np.abs(np.load(p) - np.load(tmp / "loop_processed_cpu" / p.name)).max()) for p in npys)
    gold = 0.0
    for p in npys[:3]:
        y, _ = load_audio(uploads / p.with_suffix(".wav").name, sr=SR)
        y = np.pad(y, (0, max(CLIP - len(y), 0)))[:CLIP]
        gold = max(gold, float(np.abs(np.load(p) - golden.mel_spec_feature(y.astype(np.float64))).max()))
    print(f"[5h] audio_processor CLI on the card: {len(npys)} uploads in {proc_s:.3f} s, {len(npys) / proc_s:.1f} "
          f"clips/s (CLI start to end, one clip a launch) on {card}; launches {proc_launches}; 3 rows vs float64 golden "
          f"max|d| {gold:.3e}, card vs CPU max|d| {card_cpu:.3e} (tol {FEATURE_TOL:g})")
    check(len(npys) == SERVE_REQUESTS and len(list((tmp / "loop_processed").glob("*.json"))) == SERVE_REQUESTS,
          "5h: audio_processor did not process every upload")
    check(proc_launches == {"mel_rfft<256, float>": SERVE_REQUESTS}, f"5h: audio_processor launched {proc_launches}")
    check(gold <= FEATURE_TOL and card_cpu <= FEATURE_TOL, "5h: audio_processor misses the 1e-5 gate")

    # 5. the dataset's arrays and labels, scored again by the served bundle on the card
    data = SpectrogramDataset(tmp / "loop_processed")
    X, y = data.load_arrays()
    metas_p = [json.loads(p.with_suffix(".json").read_text()) for p in npys]
    served = load_any_model(bundle)
    check(served.device.type == "cuda", "5h: the served bundle is not on the card")
    probs = served.predict_proba(X)
    pred_ok = all(class_names[int(r.argmax())] == m["prediction"] for r, m in zip(probs, metas_p))
    conf_err = max(abs(float(r.max()) - float(m["confidence"])) for r, m in zip(probs, metas_p))
    print(f"[5h] SpectrogramDataset: X {X.shape}, {len(data.label_names)} labelled classes; labels equal the sidecars' "
          f"true_class {[data.label_names[i] for i in y] == [m['true_class'] for m in metas_p]}; rescored on the card: "
          f"predictions equal the telemetry's {pred_ok}, confidence max|d| {conf_err:.3e} (tol 1e-05)")
    check(X.shape == (SERVE_REQUESTS, N_MELS, 1 + CLIP // HOP) and y is not None
          and [data.label_names[i] for i in y] == [m["true_class"] for m in metas_p], "5h: the dataset's labels")
    check(pred_ok and conf_err <= 1e-5, "5h: the rescored uploads disagree with the telemetry")

    # 6. the dashboard
    page = dashboard.render(dashboard.load_telemetry(tmp / "loop_telemetry"), dashboard.load_stats(tmp / "loop_stats"))
    print(f"[5h] dashboard render: {len(page)} characters, {page.count('base64,')} PNG panels "
          f"(matplotlib {'present' if dashboard._mpl() else 'absent: text only'})")
    check("<h2>smoke-loop</h2>" in page and f"<span class='big'>{SERVE_REQUESTS}</span>" in page,
          "5h: the dashboard does not name the device and its total")
    print(f"[5h] phase 5h in {time.perf_counter() - t_start:.2f} s")
    return {"mel_launches": serve_launches + SERVE_REQUESTS}


# ---------------------------------------------------------------------------
# 5i: the compile stage
# ---------------------------------------------------------------------------

XLA_REPORT_KEYS = {"model", "backend", "batch", "compile_seconds", "xla_latency_ms_per_sample",
                   "tflite_latency_ms_per_sample", "speedup_vs_tflite", "memory_analysis", "flag_search", "timestamp"}


def phase_5i(dev, tmp: Path, bundle: Path, features: Path, card: str) -> None:
    """Phase 5i: the compile stage (``compilation/compile_xla.py``) on 5b's
    trained cnn bundle at --batch 32, plain (a CUDA graph) and with
    --tune-flags (eager, the graph, torch.compile's default and
    reduce-overhead modes): the report's keys are JAX's, the graph's and each
    candidate's logits within 1e-5 of the eager forward (TF32 off). On 2 or
    more cards, the capture on a card that is not current
    (``other_card_capture``)."""
    import torch
    import torch._inductor.config as inductor_config

    from audio_edge_ml_pipeline_torch.compilation import compile_xla

    t_start = time.perf_counter()
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(tmp / "inductor")   # inside the run's temporary directory
    os.environ["TRITON_CACHE_DIR"] = str(tmp / "triton")
    inductor_config.compile_threads = 1                             # compile in this process: no worker pool
    reports = {}
    _, forward, xb = compile_xla.load_forward(bundle, features, 32, dev)
    eager = forward(xb).clone()
    graph = None
    for label, extra in (("plain", []), ("tuned", ["--tune-flags"])):
        out = tmp / f"xla_{label}.json"
        compile_xla.main(["--model", str(bundle), "--features", str(features), "--output", str(out), "--batch", "32",
                          *extra])
        reports[label] = json.loads(out.read_text())
        # a graph captured after the plain run's (dropped) one, replayed after the tuned run's torch.compile
        # candidates have recorded theirs, which clears cuBLAS's cached workspaces
        graph = graph or compile_xla.capture_graph(forward, xb)
    graph_err = float((graph() - eager).abs().max())
    search = reports["tuned"]["flag_search"]
    for label, rep in reports.items():
        mem = rep["memory_analysis"]
        print(f"[5i] compile_xla {label} at batch {rep['batch']}: backend {rep['backend']}, compile "
              f"{rep['compile_seconds']:.2f} s, {rep['xla_latency_ms_per_sample'] * 1e3:.2f} us a sample; allocator "
              f"around one eager call: arguments {mem['argument_size_bytes']} B, output {mem['output_size_bytes']} B, "
              f"temporaries {mem['temp_size_bytes']} B on {card}")
        check(set(rep) == XLA_REPORT_KEYS, f"5i: the {label} report's keys {sorted(rep)}")
        check(rep["backend"] == "cuda" and rep["batch"] == 32 and rep["xla_latency_ms_per_sample"] > 0,
              f"5i: the {label} report {rep}")
    for c in search["candidates"]:
        print(f"[5i] candidate {c['flags']}: "
              + (f"error {c['error']}" if "error" in c else
                 f"{c['latency_ms_per_sample'] * 1e3:.2f} us a sample, built in {c['compile_seconds']:.2f} s, logits "
                 f"vs eager max|d| {c['max_abs_diff_vs_eager']:.3e}") + f" on {card}")
    print(f"[5i] a CUDA graph captured between the two runs, replayed after the search, vs eager max|d| "
          f"{graph_err:.3e} (tol 1e-05, TF32 off); the search kept {search['best_flags']}")
    check([c["flags"].get("mode", c["flags"]["backend"]) for c in search["candidates"]]
          == ["eager", "cuda_graph", "default", "reduce-overhead"], "5i: the search's candidates")
    check(all("error" not in c and c["max_abs_diff_vs_eager"] <= 1e-5 for c in search["candidates"]),
          "5i: a candidate failed or disagrees with the eager forward")
    check(graph_err <= 1e-5, "5i: the CUDA graph disagrees with the eager forward")
    if torch.cuda.device_count() < 2:
        print(f"[5i] the capture on a card that is not current (compile_xla --device cuda:1 while cuda:0 is current) "
              f"needs 2 cards; this machine has {torch.cuda.device_count()}: not run")
    else:
        other_card_capture(tmp, bundle, features, card)
    print(f"[5i] phase 5i in {time.perf_counter() - t_start:.2f} s")


def other_card_capture(tmp: Path, bundle: Path, features: Path, card: str) -> None:
    """5i on 2 or more cards: with cuda:0 current, compile_xla --device
    cuda:1, and its graph captured on cuda:1 against eager there (1e-5, TF32
    off), its replay's kernels counted by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio_edge_ml_pipeline_torch.compilation import compile_xla

    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    out = tmp / "xla_cuda1.json"
    compile_xla.main(["--model", str(bundle), "--features", str(features), "--output", str(out), "--batch", "32",
                      "--device", "cuda:1"])
    rep = json.loads(out.read_text())
    _, forward, xb = compile_xla.load_forward(bundle, features, 32, other)
    eager = forward(xb).clone()
    graph = compile_xla.capture_graph(forward, xb)
    err = float((graph() - eager).abs().max())
    torch.cuda.synchronize(other)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph()
        torch.cuda.synchronize(other)
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    current = torch.cuda.current_device()
    print(f"[5i] compile_xla --device cuda:1 with cuda:0 current: backend {rep['backend']}, "
          f"{rep['xla_latency_ms_per_sample'] * 1e3:.2f} us a sample; its graph on cuda:1 vs eager there max|d| "
          f"{err:.3e} (tol 1e-05, TF32 off); one replay launched {kernels} kernels (the profiler's count); current "
          f"card after {current} on {card}")
    check(rep["backend"] == "cuda" and rep["xla_latency_ms_per_sample"] > 0, f"5i: the cuda:1 report {rep}")
    check(err <= 1e-5, "5i: the graph captured on cuda:1 disagrees with the eager forward there")
    check(kernels >= 1, "5i: the replay of the graph captured on cuda:1 launched no kernel")
    check(current == 0, "5i: compile_xla changed the current card")


EMBED_TOL = 1e-4    # MobileNetV2 embeddings card vs CPU from a converted file, over their largest


def torchvision_mbv2_state(path: Path, seed: int = 9) -> dict:
    """A torchvision-layout MobileNetV2 state_dict of seeded values, saved
    with torch.save: OIHW kernels in execution order, one
    num_batches_tracked a BatchNorm and a classifier head, both of which the
    converter drops. Returns {flax key: the array the converter must
    write}."""
    import torch

    from audio_edge_ml_pipeline_torch.tools import convert_backbone_weights as tool

    template = tool.backbone_template("mobilenet_v2")
    r = np.random.default_rng(seed)
    state, want = {}, {}
    for i, key in enumerate(tool.mbv2_flax_key_order()):
        shape = template[key]
        if key.endswith("/kernel"):
            arr = (r.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        elif key.endswith(("/scale", "/var")):
            arr = r.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            arr = r.normal(0.0, 0.1, shape).astype(np.float32)
        want[key] = arr
        state[f"features.{i}.w"] = torch.from_numpy(np.ascontiguousarray(arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                                                                          else arr))
        if key.endswith("/var"):
            state[f"features.{i}.num_batches_tracked"] = torch.tensor(0)
    state["classifier.1.weight"] = torch.zeros(1000, 1280)
    state["classifier.1.bias"] = torch.zeros(1000)
    torch.save(state, path)
    return want


def phase_5k(dev, tmp: Path, bundle: Path, features: Path, card: str) -> None:
    """Phase 5k: stage 7a and the backbone-weight converter on the card
    machine. ``compilation.to_tflite`` imports; with TensorFlow unimportable
    (the H100 machine has none; it is hidden anyway, so that the check
    holds on any machine) the to_tflite CLI on 5b's bundle and compile_xla --tflite
    on an existing file refuse with an ImportError that names it: an
    expected refusal, asserted. The converter turns a seeded
    torchvision-layout state_dict into the named .npz, which
    mobilenet_v2_embedder loads on the card and on the CPU: B=32 x 224
    embeddings within EMBED_TOL of the largest. Its --prefix backbone
    --bundle file warm-starts the teacher on the card by name and shape:
    the units MobileNetV2 and EfficientNet-B0 share (stem and head; a B0
    source is a Keras file, which needs TensorFlow). No mel kernel runs."""
    import importlib.util
    import logging

    import torch

    from audio_edge_ml_pipeline_torch.compilation import compile_xla, to_tflite
    from audio_edge_ml_pipeline_torch.models import backbones
    from audio_edge_ml_pipeline_torch.models.deep import EfficientNetTeacherTrainer, params_to_flax
    from audio_edge_ml_pipeline_torch.ops import mel_kernel
    from audio_edge_ml_pipeline_torch.tools import convert_backbone_weights as tool

    t_start = time.perf_counter()
    launches = (mel_kernel.counter.launches, mel_kernel.counter_czt.launches)
    has_tf = importlib.util.find_spec("tensorflow") is not None
    refusals = {}
    saved = sys.modules.get("tensorflow")
    sys.modules["tensorflow"] = None   # an import of it raises ImportError
    try:
        baseline = tmp / "baseline.tflite"
        baseline.write_bytes(b"")
        for label, call in (
                ("to_tflite CLI", lambda: to_tflite.main(["--model", str(bundle), "--features", str(features),
                                                          "--output", str(tmp / "tflite")])),
                ("compile_xla --tflite", lambda: compile_xla.main(["--model", str(bundle), "--features",
                                                                   str(features), "--output", str(tmp / "x.json"),
                                                                   "--tflite", str(baseline)]))):
            try:
                call()
                refusals[label] = "no refusal"
            except ImportError as exc:
                refusals[label] = str(exc)
    finally:
        if saved is None:
            sys.modules.pop("tensorflow", None)
        else:
            sys.modules["tensorflow"] = saved
    for label, msg in refusals.items():
        print(f"[5k] {label} on 5b's bundle without TensorFlow (installed on this run's machine: {has_tf}): ImportError {msg!r} "
              f"(expected)")
        check("TensorFlow" in msg, f"5k: the {label} did not refuse with an ImportError naming TensorFlow")

    want = torchvision_mbv2_state(tmp / "mbv2_torchvision.pth")
    named = tmp / "mbv2_named.npz"
    out = captured_stdout(tool.main, ["--src", str(tmp / "mbv2_torchvision.pth"), "--out", str(named)])
    data = np.load(named)
    same = data.files == list(want) and all(np.array_equal(data[k], want[k]) for k in want)
    x = torch.from_numpy(np.random.default_rng(10).uniform(-1, 1, (32, 224, 224, 3)).astype(np.float32))
    with torch.inference_mode():
        on_card = backbones.mobilenet_v2_embedder(224, weights=str(named), device=dev)(x.to(dev)).cpu().numpy()
        on_cpu = backbones.mobilenet_v2_embedder(224, weights=str(named), device="cpu")(x).numpy()
    embed_gap = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    print(f"[5k] convert_backbone_weights on a seeded torchvision-layout MobileNetV2 state_dict: {out.strip()}; "
          f"every array the source's, in execution order {same}; mobilenet_v2_embedder(224) from the file, B=32: "
          f"card vs CPU max|d|/max {embed_gap:.3e} (tol {EMBED_TOL:g}, TF32 off) on {card}")
    check(same, "5k: the converted arrays are not the source's")
    check(on_card.shape == (32, 1280) and bool(np.isfinite(on_card).all()), "5k: the embeddings on the card")
    check(embed_gap <= EMBED_TOL, "5k: the embeddings from the converted file disagree card vs CPU")

    prefixed = tmp / "mbv2_backbone_bundle.npz"
    captured_stdout(tool.main, ["--src", str(tmp / "mbv2_torchvision.pth"), "--out", str(prefixed), "--prefix",
                                "backbone", "--bundle"])
    msgs: list[str] = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: msgs.append(record.getMessage())
    deep_log = logging.getLogger("audio_edge_ml_pipeline_torch.models.deep")
    deep_log.addHandler(handler)
    level, _ = deep_log.level, deep_log.setLevel(logging.INFO)
    try:
        teacher = EfficientNetTeacherTrainer(device=dev, image_size=224, pretrained_model=str(prefixed))
        teacher.prepare_fit(np.random.default_rng(11).random((4, 40, 501, 1), dtype=np.float32), 5)
    finally:
        deep_log.removeHandler(handler)
        deep_log.setLevel(level)
    flat = params_to_flax(teacher._net.state_dict())
    donor = np.load(prefixed)
    shared = sorted(k for k in donor.files if k in flat and donor[k].shape == flat[k].shape)
    took = all(np.array_equal(flat[k], donor[k]) for k in shared)
    on_device = {p.device.type for p in teacher._net.parameters()}
    print(f"[5k] the converter's --prefix backbone --bundle file warm-starts the teacher (image 224) on the card: "
          f"{[m for m in msgs if 'Pretrained' in m]}; the {len(shared)} tensors of the two backbones' shared units "
          f"({', '.join(sorted({k.split('/')[-3] for k in shared}))}) are the file's {took}; parameters on "
          f"{sorted(on_device)}; mel kernel launches in 5k {mel_kernel.counter.launches - launches[0]}, of them czt "
          f"{mel_kernel.counter_czt.launches - launches[1]}; "
          f"phase 5k in {time.perf_counter() - t_start:.2f} s")
    check(any("Pretrained weights: 6 tensors transferred" in m for m in msgs), "5k: the teacher's warm start")
    check(len(shared) == 10 and took and on_device == {"cuda"}, "5k: the teacher did not take the file's tensors")
    check((mel_kernel.counter.launches, mel_kernel.counter_czt.launches) == launches, "5k launched a mel kernel")


def native_reader_checks(audio_dir: Path, names: list[str], tmp: Path) -> None:
    """Phase 4c's native WAV reader checks: in use, bit for bit with the
    numpy codec on the tree, None and negative batch lengths for a missing
    and a truncated file."""
    from audio_edge_ml_pipeline_torch.data import native_wavio
    from audio_edge_ml_pipeline_torch.data.audio_io import read_wav

    check(native_wavio.available(), "4c: the native WAV reader is not available on the card machine")
    same = all(np.array_equal(native_wavio.decode(audio_dir / n, CLIP)[0], read_wav(audio_dir / n)[0][:, 0])
               for n in names)
    truncated = tmp / "truncated.wav"
    truncated.write_bytes((audio_dir / names[0]).read_bytes()[:20])
    bad = [tmp / "missing.wav", truncated]
    _, lengths, _ = native_wavio.decode_batch([audio_dir / names[0], *bad], CLIP)
    print(f"[4c] native WAV reader: decode equals the numpy codec bit for bit on the {len(names)} tree clips {same}; "
          f"a missing and a truncated file decode to {[native_wavio.decode(p, CLIP) for p in bad]}, batch lengths "
          f"{lengths.tolist()}")
    check(same, "4c: the native reader's samples differ from the numpy codec's")
    check(all(native_wavio.decode(p, CLIP) is None for p in bad) and lengths[0] == CLIP and (lengths[1:] < 0).all(),
          "4c: the native reader's failures")


# ---------------------------------------------------------------------------
# 5l: the repository tools and scripts through the port: the README quick
# start, the split manifest, the diagnostics, stage 8 against a loopback device
# ---------------------------------------------------------------------------

QS_PER_CLASS = 12                 # make_synth_dataset --per-class: 8 / 2 / 2 a class after the 70/15/15 split
QS_SPLIT = {"train": 8, "val": 2, "test": 2}   # round(0.7 * 12) = 8, round(0.15 * 12) = 2, the rest 2
LOOP_CAPTURES = 3                 # PCM captures through receive_wav and through record_dataset
SAMPLE_UPLOADS = 5                # load_sample_data's default --n
OUT_OF_SET = "Thunderstorm"       # a label no synthetic class bears: the loopback's one out-of-set reply
CONF_TOL = 1e-5                   # test_model's printed confidences card vs CPU
PORT_TOOLS = "audio_edge_ml_pipeline_torch.tools."


def tool_cli(module: str, argv: list[str], cwd: Path, block: tuple[str, ...] = ()) -> tuple[int, str, dict]:
    """``python -m <module> <argv>`` as a user types it, in its own process from
    ``cwd`` (TF32 off, as everywhere in this script; ``block``'s modules
    unimportable there): (exit code, its output, the mel kernel launches it
    made, by template instantiation, read from its counters as it ends)."""
    code = ("import json, runpy, sys, torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False\n"
            f"for m in {block!r}:\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = [{module!r}, *{argv!r}]\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
            "finally:\n"
            "    launches = {}\n"
            "    for name in ('mel_kernel', 'mel_unfolded'):\n"
            "        mod = sys.modules.get('audio_edge_ml_pipeline_torch.ops.' + name)\n"
            "        for k, v in (dict(mod.counter.by_instantiation) if mod else {}).items():\n"
            "            launches[k] = launches.get(k, 0) + v\n"
            "    print('5L_LAUNCHES ' + json.dumps(launches), flush=True)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=cwd, timeout=600)
    out = r.stdout + r.stderr
    marks = re.findall(r"^5L_LAUNCHES (.*)$", r.stdout, re.M)
    return r.returncode, out, json.loads(marks[-1]) if marks else {}


def phase_5l(dev, card: str) -> dict:
    """Phase 5l: the repository's tools and scripts through the port's
    ``tools/`` package on the card, each typed command its own process
    (``tool_cli``; b, c and f run beside a's chain, up to 4 processes at a
    time, since a process's start-up is most of its time), in one
    temporary directory:

      a. the README quick start: make_synth_dataset (27 classes x 12 clips of
         5 s at 16 kHz, every layout), the mel extraction of the train and
         validation splits on the card, the flagship cnn (3 epochs), select,
         optimize, select --post-opt and deploy;
      b. generate_split on the audio_folder tree (27 x 8 / 2 / 2), a re-run,
         --seed 7 refused by the drift guard (exit 1), --force, then the
         extraction CLI on the manifest's test split (a --config: the flags
         take no manifest) holding exactly its files;
      c. diagnose_data, diagnose_training and verify_training_data on a's
         train set; test_model on a's bundle on the card and on the CPU;
      d. stage 8: a LoopbackSerial whose 'R' handler does what EVAL_MODE
         firmware does, on the card: the next test clip's mel (the
         audio_mel_spec extractor, one mel_rfft launch a clip) scored by a's
         bundle; ``evaluate_device.evaluate`` over the test split against the
         bundle's own predict on b's features, then its CLI (main, with
         open_serial handed the loopback) with --manifest,
         --optimization-report and a file tracking store, one reply out of
         the set;
      e. captures: receive_wav and record_dataset (main, open_serial handed a
         loopback of 3 test clips' int16 PCM frames) byte for byte with
         write_wav, the recorded tree through the extraction CLI; a FEAT
         frame of a train clip's card mel through read_feat_frame, then the
         repository's tools/receive_mel.py (nearest row) and
         tools/gen_prototypes.py, which import neither jax nor the JAX package;
      f. load_sample_data posting 5 clips to the ingestion API with requests
         blocked; test_dashboard.
    Returns the mel kernel's launches in the phase (subprocesses included)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from audio_edge_ml_pipeline_torch.data.audio_io import load_audio, write_wav
    from audio_edge_ml_pipeline_torch.features.audio import AudioMelSpectrogram
    from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
    from audio_edge_ml_pipeline_torch.models.deep import MODEL_FILENAME, load_any_model
    from audio_edge_ml_pipeline_torch.ops import mel_kernel
    from audio_edge_ml_pipeline_torch.serve import api
    from audio_edge_ml_pipeline_torch.tools import evaluate_device, receive_wav, record_dataset, serial_proto
    from audio_edge_ml_pipeline_torch.train import evaluate as evaluate_mod
    from audio_edge_ml_pipeline_torch.utils import tracking

    t_start = time.perf_counter()
    launches: dict[str, int] = {}
    cli_s: dict[str, float] = {}   # seconds by CLI, over its calls
    calls = []
    lock = threading.Lock()        # the commands run side by side from a thread pool

    def count(new: dict) -> None:
        with lock:
            for k, v in new.items():
                launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_5l_") as tmp_s:
        tmp = Path(tmp_s)

        def run(module: str, *argv: str, expect: int = 0, block: tuple[str, ...] = ()) -> str:
            t0 = time.perf_counter()
            rc, out, counts = tool_cli(module, [str(a) for a in argv], tmp, block)
            label = module.removeprefix(PORT_TOOLS).removeprefix("audio_edge_ml_pipeline_torch.")
            with lock:
                cli_s[label] = cli_s.get(label, 0.0) + time.perf_counter() - t0
                calls.append(label)
            check(rc == expect, f"5l: {module} {list(argv)} exited {rc}, not {expect}: {out[-3000:]}")
            count(counts)
            return out

        def script(name: str, *argv: str) -> str:
            """One of the repository's tools/*.py that the port runs as it is."""
            r = subprocess.run([sys.executable, str(REPO / "tools" / name), *map(str, argv)], capture_output=True,
                               text=True, cwd=tmp, timeout=300)
            check(r.returncode == 0, f"5l: tools/{name} exited {r.returncode}: {r.stderr[-3000:]}")
            return r.stdout

        synth, processed, models = tmp / "data/raw/synth", tmp / "data/processed", tmp / "data/models"
        mel_train, mel_val, deploy_out = processed / "mel_train", processed / "mel_val", tmp / "deploy_out"
        folder = synth / "audio_folder"
        manifest_path = folder / "split_manifest.json"

        def split_chain() -> dict:
            """b: generate_split, a re-run, --seed 7 (the drift guard), --force, each on the manifest the one
            before left; then the extraction CLI on the manifest's test split."""
            out = {"first": run(PORT_TOOLS + "generate_split", "--dataset", folder)}
            out["first_text"] = manifest_path.read_text()
            out["rerun"] = run(PORT_TOOLS + "generate_split", "--dataset", folder)
            out["drift"] = run(PORT_TOOLS + "generate_split", "--dataset", folder, "--seed", 7, expect=1)
            out["kept"] = manifest_path.read_text() == out["first_text"]
            out["forced"] = run(PORT_TOOLS + "generate_split", "--dataset", folder, "--seed", 7, "--force")
            cfg = extraction_config(tmp / "test_split.yaml", folder, "audio_folder", "test", [
                {"name": "folder_mel_test", "extractor": "audio_mel_spec", "manifest": str(manifest_path),
                 "manifest_split": "test"}], processed)
            run("audio_edge_ml_pipeline_torch.features.pipeline", "--config", cfg)
            return out

        # a. the README quick start through the port; what does not wait on it runs beside it (each process's
        # start-up, not its work, is most of its time)
        run(PORT_TOOLS + "make_synth_dataset", synth, "--classes", N_CLASSES, "--per-class", QS_PER_CLASS)
        t_side = time.perf_counter()
        server = api.create_server(tmp / "uploads", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            with ThreadPoolExecutor(max_workers=4) as pool:
                split_job = pool.submit(split_chain)
                upload_job = pool.submit(run, PORT_TOOLS + "load_sample_data", "--dataset", folder, "--api-url",
                                         f"http://127.0.0.1:{server.server_address[1]}", block=("requests",))
                dash_job = pool.submit(run, PORT_TOOLS + "test_dashboard")
                for job in [pool.submit(run, "audio_edge_ml_pipeline_torch.features.pipeline", "--loader", "fsc22",
                                        "--dataset", synth / "fsc22", "--extractor", "audio_mel_spec", "--split",
                                        split, "--output", out)
                            for split, out in (("train", mel_train), ("validation", mel_val))]:
                    job.result()
                diag_jobs = {tool: pool.submit(run, PORT_TOOLS + tool, mel_train)
                             for tool in ("diagnose_data", "diagnose_training", "verify_training_data")}
                run("audio_edge_ml_pipeline_torch.train.train", "--features", mel_train, "--features-test", mel_val,
                    "--model", "cnn", "--param", "filters=[16,64,64]", "--param", "first_stride=4", "--param",
                    "second_stride=2", "--param", f"epochs={TRAIN_EPOCHS}", "--output", models, "--experiment", "demo")
                bundle = models / "cnn" / MODEL_FILENAME
                model_jobs = {dv: pool.submit(run, PORT_TOOLS + "test_model", bundle, mel_val, "--n", 20, *extra)
                              for dv, extra in (("card", ()), ("cpu", ("--device", "cpu")))}
                run("audio_edge_ml_pipeline_torch.train.select", "--experiment", "demo", "--output",
                    models / "shortlist.json")
                run("audio_edge_ml_pipeline_torch.optimize.optimize", "--shortlist", models / "shortlist.json",
                    "--features-eval", mel_val, "--output", models / "optimized")
                run("audio_edge_ml_pipeline_torch.train.select", "--post-opt", "--shortlist", models / "shortlist.json",
                    "--opt-dir", models / "optimized")
                reports = sorted((models / "optimized").glob("*/optimization_report.json"))
                check(len(reports) == 1, f"5l: optimize wrote {reports}")
                run("audio_edge_ml_pipeline_torch.deploy.deploy", "--report", reports[0], "--features-dir", mel_train,
                    "--output", deploy_out, "--board", "nicla_vision")
                split_out, posted, dash = split_job.result(), upload_job.result(), dash_job.result()
                diag = {tool: job.result() for tool, job in diag_jobs.items()}
                served = {dv: job.result() for dv, job in model_jobs.items()}
        finally:
            server.shutdown()
            server.server_close()
        side_s = time.perf_counter() - t_side
        n_clips = N_CLASSES * QS_PER_CLASS
        wavs = {layout: sorted((synth / layout).rglob("*.wav")) for layout in ("fsc22", "audio_folder")}
        fs_train, fs_val = FeaturePipeline.load(mel_train), FeaturePipeline.load(mel_val)
        shortlist = json.loads((models / "shortlist.json").read_text())
        project = sorted(p.name for p in deploy_out.iterdir())
        print(f"[5l] a. README quick start through the port on {card}, with b, c and f beside it ({len(calls)} "
              f"commands, {side_s:.1f} s after make_synth_dataset): {len(wavs['fsc22'])} fsc22 and "
              f"{len(wavs['audio_folder'])} audio_folder WAVs; mel_train {fs_train.features.shape}, mel_val "
              f"{fs_val.features.shape}; shortlist {[c['run_name'] for c in shortlist['candidates']]}; "
              f"best_model.json {(models / 'optimized' / 'best_model.json').exists()}; firmware project {project}")
        check(all(len(v) == n_clips for v in wavs.values()), "5l: make_synth_dataset's trees")
        check(all((synth / f).is_file() for f in ("text.csv", "tabular.csv")) and (synth / "images").is_dir(),
              "5l: make_synth_dataset's text, tabular and image layouts")
        check(fs_train.features.shape == (N_CLASSES * QS_SPLIT["train"], N_MELS, 1 + CLIP // HOP)
              and fs_val.features.shape[0] == N_CLASSES * QS_SPLIT["val"], "5l: the quick start's FeatureSets")
        check(bundle.is_file() and len(shortlist["candidates"]) == 1, "5l: the quick start's bundle and shortlist")
        check((models / "optimized" / "best_model.json").is_file(), "5l: select --post-opt wrote no best_model.json")
        check("platformio.ini" in project and (deploy_out / "src").is_dir(), "5l: deploy wrote no firmware project")

        # b. the split manifest and its drift guard
        first = json.loads(split_out["first_text"])
        per_class = {(c, s): sum(1 for f in first[s] if f.split("/")[0] == c)
                     for c in {f.split("/")[0] for f in first["train"]} for s in QS_SPLIT}
        manifest = json.loads(manifest_path.read_text())
        moved = sum(1 for s in QS_SPLIT for f in manifest[s] if f not in first[s])
        fs_test = FeaturePipeline.load(processed / "folder_mel_test")
        test_files = [f"{m['class_dir']}/{m['filename']}" for m in fs_test.metadata]
        written = re.search(r"train: \d+\s+val: \d+\s+test: \d+", split_out["first"])
        print(f"[5l] b. generate_split: {written and written.group(0)} ({len(per_class) // len(QS_SPLIT)} "
              f"classes, each {sorted(set(per_class.values()))} a split); re-run exit 0 "
              f"{'Manifest written' in split_out['rerun']}; --seed 7 exit 1 with "
              f"{split_out['drift'].strip().splitlines()[0][:60]!r}..., manifest kept {split_out['kept']}; --force: "
              f"{split_out['forced'].strip().splitlines()[0][:70]!r}, {moved} files moved; the extraction CLI on the "
              f"manifest's test split: {fs_test.features.shape}, exactly its files "
              f"{sorted(test_files) == sorted(manifest['test'])}")
        check(all(n == QS_SPLIT[s] for (_, s), n in per_class.items()) and len(per_class) == N_CLASSES * len(QS_SPLIT),
              "5l: the manifest is not 27 x 8 / 2 / 2")
        check("DRIFT GUARD" in split_out["drift"] and split_out["kept"] and moved > 0, "5l: the drift guard")
        check(sorted(test_files) == sorted(manifest["test"]) and len(test_files) == N_CLASSES * QS_SPLIT["test"],
              "5l: the test split's FeatureSet is not the manifest's test files")

        # c. the diagnostics on a's train set, test_model on the card and on the CPU
        rows = {dv: re.findall(r"^\[(?:OK |BAD)\] sample (\d+): true=(\S+)\s+pred=(\S+)\s+conf=(\S+)$", text, re.M)
                for dv, text in served.items()}
        conf_gap = max(abs(float(a[3]) - float(b[3])) for a, b in zip(rows["card"], rows["cpu"]))
        summary = {tool: [ln for ln in text.splitlines() if ln.startswith(("NaN", "OK", "ISSUE", "WARNING", "note"))]
                   for tool, text in diag.items()}
        correct = re.findall(r"^(\d+/\d+ correct)$", served["card"], re.M)
        print(f"[5l] c. diagnostics on mel_train: {summary}; test_model on 20 validation rows, card vs CPU: "
              f"predictions equal {[r[:3] for r in rows['card']] == [r[:3] for r in rows['cpu']]}, printed "
              f"confidences max|d| {conf_gap:.3e} (tol {CONF_TOL:g}); {correct}")
        check("NaN: 0  Inf: 0" in diag["diagnose_data"] and "PROBLEM" not in diag["diagnose_data"],
              "5l: diagnose_data reports non-finite values")
        check("leakage" not in diag["diagnose_training"] and "non-finite" not in diag["diagnose_training"],
              "5l: diagnose_training reports leakage or non-finite values")
        check("OK: batches are finite and stratified." in diag["verify_training_data"], "5l: verify_training_data")
        check(len(rows["card"]) == 20 and [r[:3] for r in rows["card"]] == [r[:3] for r in rows["cpu"]]
              and conf_gap <= CONF_TOL, "5l: test_model on the card disagrees with the CPU")

        # d. stage 8 against a loopback device on the card
        names = fs_train.label_names
        model = load_any_model(bundle)
        check(model.device.type == "cuda", "5l: the loopback's bundle is not on the card")
        extractor = AudioMelSpectrogram(device=dev)
        test_clips = [(folder / rel, rel.split("/")[0]) for rel in manifest["test"]]
        pending: list[Path] = []
        answers: list[str] = []
        wrong_reply: dict[int, str] = {}

        def firmware(ser, data: bytes) -> None:
            """EVAL_MODE: on 'R', the next clip's mel on the card, scored, then PRED / SCORES / EVAL_DONE."""
            if data != b"R":
                return
            feat = extractor.extract(pending.pop(0))
            proba = model.predict_proba(feat[None])[0]
            label = wrong_reply.get(len(answers), names[int(proba.argmax())])
            answers.append(names[int(proba.argmax())])
            ser.feed(f"PRED {label}\nSCORES {' '.join(f'{p:.6f}' for p in proba)}\nEVAL_DONE\n".encode())

        mel_kernel.counter.reset()
        pending[:] = [p for p, _ in test_clips]
        t0 = time.perf_counter()
        metrics = evaluate_device.evaluate(serial_proto.LoopbackSerial(on_write=firmware), test_clips,
                                           sorted({c for _, c in test_clips}), playback=False,
                                           output_dir=tmp / "device_eval_api")
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        loop_launches = dict(mel_kernel.counter.by_instantiation)
        count(loop_launches)
        # the bundle's own predict on b's features of the same clips
        row_of = {f: i for i, f in enumerate(test_files)}
        batch_pred = model.predict(fs_test.features)
        own = [names[int(batch_pred[row_of[str(p.relative_to(folder))]])] for p, _ in test_clips]
        label_set = sorted({c for _, c in test_clips})
        y_true = np.array([label_set.index(c) for _, c in test_clips])
        y_own = np.array([label_set.index(c) for c in own])
        want = evaluate_mod.compute_metrics(y_true, y_own, label_names=label_set)
        evaluate_mod.save_classification_report(y_true, y_own, label_set, tmp / "own_report.txt")
        same_report = ((tmp / "device_eval_api" / "classification_report.txt").read_text()
                       == (tmp / "own_report.txt").read_text())
        print(f"[5l] d. evaluate_device.evaluate over the {len(test_clips)} test clips through the loopback on {card} "
              f"in {loop_s:.2f} s ({1e3 * loop_s / len(test_clips):.1f} ms a clip): val_accuracy "
              f"{metrics['val_accuracy']:.6f}, val_f1_macro {metrics['val_f1_macro']:.6f}; the bundle's predict on "
              f"the extraction CLI's rows: {want['val_accuracy']:.6f}, {want['val_f1_macro']:.6f}; per-clip answers "
              f"equal the batch's {answers == own}; classification_report.txt equal {same_report}; launches "
              f"{loop_launches}")
        check(metrics["val_accuracy"] == want["val_accuracy"] and metrics["val_f1_macro"] == want["val_f1_macro"],
              "5l: the device's metrics are not the bundle's own")
        check(same_report, "5l: the loopback's classification report differs from the bundle's own")
        check(loop_launches == {"mel_rfft<256, float>": len(test_clips)}, f"5l: the loopback launched {loop_launches}")

        # stage 8's CLI: --manifest, --optimization-report, a file tracking store; the first reply out of the set
        answers.clear()
        pending[:] = [p for p, _ in test_clips]
        wrong_reply[0] = OUT_OF_SET
        store = tmp / "device_store"
        opened = serial_proto.open_serial
        serial_proto.open_serial = lambda *a, **k: serial_proto.LoopbackSerial(on_write=firmware)
        mel_kernel.counter.reset()
        try:
            captured_stdout(evaluate_device.main, [
                "--port", "loopback", "--dataset", str(folder), "--manifest", str(manifest_path),
                "--optimization-report", str(reports[0]), "--no-playback", "--mlflow-uri", str(store),
                "--output", str(tmp / "device_eval")])
            tracking.set_tracking_uri(str(store))
            runs = tracking.search_runs("device-eval")
        finally:
            serial_proto.open_serial = opened
            tracking.set_tracking_uri(None)
        count(dict(mel_kernel.counter.by_instantiation))
        expected = (sum(a == c for a, (_, c) in zip(own, test_clips)) - int(own[0] == test_clips[0][1])) / len(own)
        run8 = runs[0] if len(runs) == 1 else None
        arts = sorted(p.name for p in Path(run8.artifact_uri).iterdir()) if run8 else []
        report8 = (tmp / "device_eval" / "classification_report.txt").read_text()
        print(f"[5l] d. the evaluate_device CLI (first reply {OUT_OF_SET!r}): {len(runs)} run(s) "
              f"{[r.run_name for r in runs]}, params {run8.params if run8 else None}, device_val_accuracy "
              f"{run8.metrics.get('device_val_accuracy') if run8 else None} (expected {expected:.6f}), artifacts "
              f"{arts}; the report names {OUT_OF_SET} {OUT_OF_SET in report8}")
        check(run8 is not None and run8.run_name == "device_eval_test" and run8.status == "FINISHED",
              "5l: no device_eval_test run in the tracking store")
        check(run8.metrics.get("device_val_accuracy") == expected, "5l: the out-of-set reply was not counted wrong")
        check(arts == ["classification_report.txt", "confusion_matrix.png"] and OUT_OF_SET in report8,
              "5l: the device run's artifacts or its grown label set")

        # e. captures: PCM frames through receive_wav and record_dataset, a FEAT frame through receive_mel
        cap = test_clips[:LOOP_CAPTURES]
        pcm = [np.clip(np.round(load_audio(p, sr=SR)[0] * 32768.0), -32768, 32767).astype(np.int16) for p, _ in cap]
        refs = []
        for i, frame in enumerate(pcm):
            write_wav(tmp / f"ref_{i}.wav", frame.astype("float32") / 32768.0, SR)
            refs.append((tmp / f"ref_{i}.wav").read_bytes())

        def pcm_device(*_a, **_k):
            ser = serial_proto.LoopbackSerial()
            for frame in pcm:
                serial_proto.write_pcm_frame(ser, frame)
            return ser

        serial_proto.open_serial = pcm_device
        try:
            captured_stdout(receive_wav.main, ["--port", "loopback", "--count", str(LOOP_CAPTURES), "--out",
                                               str(tmp / "captures")])
            captured_stdout(record_dataset.main, ["--port", "loopback", "--no-prompt", "--count", str(LOOP_CAPTURES),
                                                  "--label", cap[0][1], "--out", str(tmp / "recorded")])
        finally:
            serial_proto.open_serial = opened
        got_recv = [p.read_bytes() for p in sorted((tmp / "captures").glob("capture_*.wav"))]
        got_rec = [p.read_bytes() for p in sorted((tmp / "recorded" / cap[0][1]).glob("rec_*.wav"))]
        run("audio_edge_ml_pipeline_torch.features.pipeline", "--loader", "audio_folder", "--dataset",
            tmp / "recorded", "--extractor", "audio_mel_spec", "--split", "all", "--output", processed / "recorded")
        fs_rec = FeaturePipeline.load(processed / "recorded")

        j = 0   # a train clip: its mel on the card, alone, as a FEAT frame
        audio_dir = next((synth / "fsc22").glob("Audio Wise V1.0-*/Audio Wise V1.0"))
        mel_kernel.counter.reset()
        feat = extractor.extract(audio_dir / fs_train.metadata[j]["filename"])
        count(dict(mel_kernel.counter.by_instantiation))
        wire = serial_proto.LoopbackSerial()
        serial_proto.write_feat_frame(wire, feat)
        device_mel = serial_proto.read_feat_frame(wire)
        np.save(tmp / "device_mel.npy", device_mel)
        near = script("receive_mel.py", "--load", tmp / "device_mel.npy", "--no-device", "--features", mel_train)
        nearest = dict(re.findall(r"^\s+(\w+): (\S+)$", near, re.M))
        protos = script("gen_prototypes.py", "--features", mel_train, "--out-dir", deploy_out)
        header = (deploy_out / "include" / "prototypes.h").read_text()
        print(f"[5l] e. receive_wav wrote {len(got_recv)} and record_dataset {len(got_rec)} WAVs from {LOOP_CAPTURES} "
              f"int16 PCM frames, byte for byte write_wav(pcm / 32768): {got_recv == refs}, {got_rec == refs}; the "
              f"recorded tree through the extraction CLI {fs_rec.features.shape} {fs_rec.label_names}; the FEAT "
              f"frame read back bit for bit {np.array_equal(device_mel, feat)}; tools/receive_mel.py: nearest row "
              f"{nearest.get('nearest_index')} (the clip's {j}), MSE {nearest.get('nearest_mse')}; "
              f"tools/gen_prototypes.py: {protos.strip()}")
        check(got_recv == refs and got_rec == refs, "5l: the captured WAVs are not write_wav's bytes")
        check(fs_rec.features.shape == (LOOP_CAPTURES, N_MELS, 1 + CLIP // HOP) and fs_rec.label_names == [cap[0][1]],
              "5l: the recorded tree's FeatureSet")
        check(np.array_equal(device_mel, feat), "5l: the FEAT frame did not come back bit for bit")
        check(nearest.get("nearest_index") == str(j), f"5l: receive_mel found row {nearest.get('nearest_index')}")
        check(f"#define PROTO_N_CLASSES {N_CLASSES}" in header, "5l: gen_prototypes' header")

        # f. load_sample_data to the ingestion API without requests (run beside a); test_dashboard
        metas = [json.loads(p.read_text()) for p in sorted((tmp / "uploads").glob("*.json"))]
        first5 = sorted(folder.rglob("*.wav"))[:SAMPLE_UPLOADS]
        print(f"[5l] f. load_sample_data with requests blocked: {posted.count(': 200 ')} replies 200, "
              f"{len(list((tmp / 'uploads').glob('*.wav')))} WAVs and {len(metas)} sidecars stored, fields "
              f"{sorted({(m['true_class'], m['source']) for m in metas})}; test_dashboard: "
              f"{[ln for ln in dash.splitlines() if ln.startswith('render')]}")
        check(len(metas) == SAMPLE_UPLOADS == len(list((tmp / "uploads").glob("*.wav")))
              and sorted(m["filename"] for m in metas) == sorted(p.name for p in first5)
              and all(m["true_class"] == p.parent.name and m["source"] == "load_sample_data"
                      for m, p in zip(sorted(metas, key=lambda m: m["filename"]), first5)),
              "5l: the uploads and their sidecars")
        check("render OK" in dash, "5l: test_dashboard")

    total = sum(launches.values())
    print(f"[5l] mel kernel launches in phase 5l (its CLI processes and the loopback): {launches}")
    print(f"[5l] phase 5l in {time.perf_counter() - t_start:.2f} s on {card}; its {len(calls)} CLI processes took "
          f"{sum(cli_s.values()):.1f} s together, up to 4 at a time: "
          + ", ".join(f"{k} x{calls.count(k)} {v:.2f} s" for k, v in cli_s.items()))
    check(set(launches) == {"mel_rfft<256, float>"}, f"5l launched {launches}")
    return {"mel_launches": total}


DP_PER_CLASS, DP_EPOCHS, DP_BATCH = 4, 2, 32   # the data-parallel fits: 27 x 4 seeded mel rows, 2 epochs, batch 32
DP_LOSS_TOL, DP_PARAM_TOL = 1e-5, 1e-4         # a data-parallel fit vs one process: losses relative; parameters
                                               # and BatchNorm statistics over each tensor's largest
MESH_LOSS_TOL, MESH_PARAM_TOL = 1e-5, 1e-5     # the 1-card NCCL mesh step vs the plain step
AXIS_LOSS_TOL, AXIS_STATE_TOL = 1e-5, 1e-4     # a (data 1 x model 2) step in float64 vs the one-process step:
                                               # loss relative; every tensor of the state over its largest
AXIS_BATCH, AXIS_STEPS = 16, 5                 # the model-axis step's global batch; the steps timed after it
SPLIT_CV_TOL = 1e-4                            # a CV cell split in fold parts vs unsplit, over the largest decision
DS_CNN_DEFAULTS = {"filters": [32, 32, 64], "first_stride": 2, "pool": "avg", "batch_norm": True}   # JAX's
# family -> (its params at the JAX package's defaults, whether it takes 5j's mel rows transposed): the transformer
# reads 501 steps of 40 mel bins, so its 4 heads of 10 features split over 2 model ranks
AXIS_FAMILIES = {"ds_cnn": (DS_CNN_DEFAULTS, False), "rnn": ({"units": 128, "n_layers": 1}, False),
                 "transformer": ({"num_heads": 4, "ff_dim": 128, "n_blocks": 2}, True)}


def dp_mel_set(rng: np.random.Generator, per_class: int):
    """Seeded mel-shaped rows (40, 501) in [0, 1], a class-dependent band
    each, 27 classes: (X, y)."""
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = rng.uniform(0.0, 0.4, (len(y), N_MELS, 1 + CLIP // HOP)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, c % N_MELS, :] += 0.5
    return X, y


def dp_fit(model: str, params: dict, dev, out: Path, X, y, Xv, yv, names: list[str], **kw):
    """(trainer, epoch logs, seconds) of one fit for 5j's comparisons."""
    import torch

    from audio_edge_ml_pipeline_torch.models import get_model

    logs: list = []
    tr = get_model(model)(**params, epochs=DP_EPOCHS, batch_size=DP_BATCH, dropout=0.0, seed=3, device=dev, **kw)
    t0 = time.perf_counter()
    tr.fit(X, y, Xv, yv, names, out.name, out, None, epoch_callback=lambda e, lg: logs.append(lg) and False)
    torch.cuda.synchronize()
    return tr, logs, time.perf_counter() - t0


def fit_gap(one, two, logs1: list, logs2: list) -> tuple[float, float, str]:
    """(the loss histories' largest relative gap, the state's largest gap
    over each tensor's largest, that tensor)."""
    loss_gap = max(abs(b[k] - a[k]) / abs(a[k]) for a, b in zip(logs1, logs2) for k in ("loss", "val_loss"))
    s1, s2 = one._net.state_dict(), two._net.state_dict()
    gap, worst = max((float((s2[k] - s1[k]).abs().max()) / max(float(s1[k].abs().max()), 1e-30), k) for k in s1)
    return loss_gap, gap, worst


def mesh_step_check(rank, batches: tuple[int, ...], card: str) -> dict:
    """A rank of a 1-card NCCL group: one make_sharded_train_step step of
    waveform -> mel (the mel kernel) -> the flagship CNN on a 1-card mesh
    against the plain step (the same module and Adam, the same dropout
    masks), then both timed, at each batch size."""
    import copy

    import torch
    import torch.nn.functional as F

    from audio_edge_ml_pipeline_torch.entry import MelFront
    from audio_edge_ml_pipeline_torch.models.deep import _MODULE_FACTORY, init_weights_
    from audio_edge_ml_pipeline_torch.ops import mel_kernel
    from audio_edge_ml_pipeline_torch.parallel import mesh as pm
    from audio_edge_ml_pipeline_torch.utils.dropout import GlobalBatchNoise, dropout_noise

    dev = rank.device
    mesh = pm.get_mesh(1)
    out = {}
    for b in batches:
        arch = {"type": "cnn", **CNN_PARAMS, "dropout": 0.3, "n_classes": N_CLASSES,
                "input_shape": [1 + CLIP // HOP, N_MELS, 1]}
        net = _MODULE_FACTORY["cnn"](arch)
        init_weights_(net, torch.Generator().manual_seed(b))
        plain = MelFront(copy.deepcopy(net)).to(dev).train()
        plain_opt = torch.optim.Adam(plain.parameters(), lr=1e-3)
        placed, opt = pm.place_train_state(MelFront(net), torch.optim.Adam(net.parameters(), lr=1e-3), mesh)
        placed.train()
        step = pm.make_sharded_train_step(placed, opt, mesh)
        noise = GlobalBatchNoise(torch.Generator(dev).manual_seed(0))   # the step's masks: its generator is seeded 0
        waves = torch.from_numpy(synth_clips(np.random.default_rng(b), 8)).to(dev).repeat(b // 8, 1)
        labels = torch.arange(b, device=dev) % N_CLASSES

        def plain_step():
            plain_opt.zero_grad(set_to_none=True)
            with dropout_noise(noise):
                logits = plain(waves)
            loss = F.cross_entropy(logits, labels)
            loss.backward()
            plain_opt.step()
            return loss.detach()

        mel_kernel.counter.reset()
        loss_mesh, _ = step(waves, labels)
        launches = mel_kernel.counter.launches
        loss_plain = plain_step()
        torch.cuda.synchronize()
        sp = {k: v.detach() for k, v in placed.named_parameters()}
        sq = {k: v.detach() for k, v in plain.named_parameters()}
        param_gap = max(float((sp[k] - sq[k]).abs().max()) / max(float(sq[k].abs().max()), 1e-30) for k in sq)
        loss_gap = abs(float(loss_mesh) - float(loss_plain)) / abs(float(loss_plain))
        ms_mesh, ms_plain = cuda_ms(lambda: step(waves, labels), iters=10), cuda_ms(plain_step, iters=10)
        ms_mesh2 = cuda_ms(lambda: step(waves, labels), iters=10)
        out[b] = {"loss_gap": loss_gap, "param_gap": param_gap, "launches": launches, "ms_mesh": (ms_mesh + ms_mesh2) / 2,
                  "ms_plain": ms_plain, "params": sum(p.numel() for p in net.parameters())}
    return out


def model_axis_checks(dev, card: str, devices: list, backend: str, X: np.ndarray, y: np.ndarray) -> None:
    """Phase 5j's model axis: the ds_cnn, the rnn and the transformer placed
    on get_mesh(2, model_parallel=2) by ``place_train_state`` over two ranks
    on ``devices`` through ``backend``, one make_sharded_train_step step (SGD
    0.1, dropout 0) in float64 against the one-process step on ``dev``, then
    AXIS_STEPS more steps timed one by one, beside the one-process step's
    time."""
    import torch
    import torch.nn.functional as F

    from audio_edge_ml_pipeline_torch.entry import timed_sharded_step
    from audio_edge_ml_pipeline_torch.models import get_model
    from audio_edge_ml_pipeline_torch.models.layers import BatchNorm, LayerNorm
    from audio_edge_ml_pipeline_torch.parallel import mesh as pm

    rows = np.random.default_rng(16).permutation(len(X))[:AXIS_BATCH]
    for model, (params, transposed) in AXIS_FAMILIES.items():
        tr = get_model(model)(**params, dropout=0.0, device="cpu")
        Xm = tr._prepare_input(X[rows].transpose(0, 2, 1) if transposed else X[rows]).astype(np.float64)
        tr.initialize(Xm.shape[1:], N_CLASSES, torch.Generator().manual_seed(16))
        r = np.random.default_rng(16)
        with torch.no_grad():   # every tensor off its init: a gradient of pure roundoff (an attention key's bias,
            for mod in tr._net.modules():   # a norm's scale at bias 0) moves a tensor that is 0 by a share of itself
                if isinstance(mod, (BatchNorm, LayerNorm)):
                    mod.weight.copy_(torch.from_numpy(r.uniform(0.5, 1.5, mod.weight.shape[0])))
            for prm in tr._net.parameters():
                if prm.requires_grad:   # an LSTM's input-side bias stays 0: the flax layout has none
                    prm.add_(torch.from_numpy(r.normal(0.0, 0.05, tuple(prm.shape)).astype(np.float32)))
        arch = tr._arch_dict
        state = {k: v.double().numpy() for k, v in tr._net.state_dict().items()}
        yb = y[rows].astype(np.int64)
        loss, new, dims, ms = pm.run_ranks(timed_sharded_step, (arch, state, Xm, yb, 2, "float64", AXIS_STEPS),
                                           devices, backend=backend)
        net = tr._net.to(dev, torch.float64).train()
        opt = torch.optim.SGD(net.parameters(), lr=0.1)
        xd, yd = torch.from_numpy(Xm).to(dev), torch.from_numpy(yb).to(dev)

        def plain_step():
            opt.zero_grad(set_to_none=True)
            out = F.cross_entropy(net(xd), yd)
            out.backward()
            opt.step()
            return out.detach()

        ref_loss = float(plain_step())
        ref = {k: v.detach().cpu().clone().numpy() for k, v in net.state_dict().items()}
        plain_ms = []
        for _ in range(AXIS_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            plain_step()
            torch.cuda.synchronize(dev)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        loss_gap = abs(loss - ref_loss) / abs(ref_loss)
        gap, worst = max((float(np.abs(new[k] - v).max() / max(float(np.abs(v).max()), 1e-30)), k)
                         for k, v in ref.items())
        n_split = sum(1 for k in ref if "weight" in k or "kernel" in k)
        print(f"[5j] model axis, {model} {params} on {list(Xm.shape[1:])} (27 classes, B={AXIS_BATCH}, float64): "
              f"get_mesh(2, model_parallel=2) {dims} over {[str(d) for d in devices]} ({backend}) vs one process on "
              f"{dev}: loss {loss:.6f} vs {ref_loss:.6f} (rel {loss_gap:.3e}, tol {AXIS_LOSS_TOL:g}), state after the "
              f"step max|d|/max {gap:.3e} ({worst}; tol {AXIS_STATE_TOL:g}; {len(ref)} tensors, {n_split} weights); "
              f"step ms model axis {[round(t, 3) for t in ms]}, one process {[round(t, 3) for t in plain_ms]} on "
              f"{card}")
        check(sorted(new) == sorted(ref), f"5j: the {model}'s model-axis state has other tensors")
        check(dims == {"data": 1, "model": 2}, f"5j: the {model}'s mesh {dims}")
        check(loss_gap <= AXIS_LOSS_TOL, f"5j: the {model}'s model-axis loss disagrees with one process")
        check(gap <= AXIS_STATE_TOL, f"5j: the {model}'s model-axis state disagrees with one process ({worst})")


def tuning_27_copy(mel_train: Path, mel_val: Path, classical_train: Path, out: Path) -> Path:
    """configs/experiments/fsc22-27-classes-tuning.yaml with its FeatureSets
    moved to this phase's and cut as phase 5e cuts configs/tuning.yaml: the
    cnn study BATCHED_K trials (one round of its tune_parallel 4) of
    TUNE_EPOCHS epochs, the pca_svm grid 2 cells (n_components 50, C 1,
    gamma scale and auto); tune_parallel, cv, the pruner and the search
    space as shipped."""
    import yaml

    doc = yaml.safe_load((REPO / "configs" / "experiments" / "fsc22-27-classes-tuning.yaml").read_text())
    check(doc["tune_parallel"] == 4 and [r["model"] for r in doc["runs"]] == ["pca_svm", "cnn"],
          "fsc22-27-classes-tuning.yaml's runs")
    doc.update(output_dir=str(out / "tuned"), mlflow_uri=str(out / "mlruns"), n_trials=BATCHED_K,
               sweep_epochs=TUNE_EPOCHS)
    doc["runs"][0].update(features_dir=str(classical_train), grid={**doc["runs"][0]["grid"], "n_components": [50],
                                                                    "C": [1.0]})
    doc["runs"][1].update(features_dir=str(mel_train), features_test=str(mel_val))
    out.mkdir(parents=True)
    path = out / "fsc22-27-classes-tuning.yaml"
    path.write_text(json.dumps(doc, indent=1))
    return path


def phase_5j(dev, card: str) -> dict:
    """Phase 5j: the parallel layer. On one card: the flagship CNN and the
    ds_cnn fitted in float64 with data_parallel=2 by two gloo ranks sharing
    the card, each against the same fit in one process, and the cnn in
    float32 beside its floor (not gated); the model axis of the ds_cnn, the
    rnn and the transformer (``model_axis_checks``: two gloo ranks on the
    card, and two cards through NCCL where there are two); one make_sharded_train_step
    step on a 1-card NCCL mesh against the plain step, both timed at B=32
    and 512; an extraction batch, a pca_svm CV cell and a 4-trial cnn group
    split in two parts on the card against the unsplit calls, one mel_rfft
    launch a part. On 2 or more cards (N = min(4, cards)), through NCCL: the
    train CLI with --param data_parallel=N against the 1-card CLI run,
    fsc22-27-classes-tuning.yaml (cut) through the tune CLI, an extraction
    batch split over the cards, and dryrun_multichip(N)."""
    import logging

    import torch

    from audio_edge_ml_pipeline_torch.features import get as get_extractor
    from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel
    from audio_edge_ml_pipeline_torch.parallel import mesh as pm
    from audio_edge_ml_pipeline_torch.train import search_cv, tune_batched

    t_phase = time.perf_counter()
    two_ranks = {"data_parallel": 2, "data_parallel_devices": [dev, dev], "data_parallel_backend": "gloo"}
    rng = np.random.default_rng(15)
    X, y = dp_mel_set(rng, DP_PER_CLASS)
    Xv, yv = dp_mel_set(rng, 1)
    names = [f"class{c:02d}" for c in range(N_CLASSES)]
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_5j_") as tmp:
        tmp = Path(tmp)
        # two gloo ranks on the card against one process, dropout 0, in float64: the two fits then part only by
        # the order of their sums (in float32 Adam lifts roundoff on near-zero gradients to fractions of a step)
        for model, params in (("cnn", CNN_PARAMS), ("ds_cnn", DS_CNN_DEFAULTS)):
            fits = {tag: dp_fit(model, params, dev, tmp / model / tag, X, y, Xv, yv, names, dtype="float64", **dp)
                    for tag, dp in (("one", {}), ("two", two_ranks))}
            (one, logs1, s1), (two, logs2, s2) = fits["one"], fits["two"]
            loss_gap, gap, worst = fit_gap(one, two, logs1, logs2)
            counts[model] = sum(p.numel() for p in one._net.parameters())
            print(f"[5j] {model} {params} in float64 (27 classes, {len(X)} seeded mel rows (40, 501), {DP_EPOCHS} "
                  f"epochs, batch {DP_BATCH}, dropout 0): data_parallel=2 by two gloo ranks on one card vs one process: "
                  f"losses max rel {loss_gap:.3e} (tol {DP_LOSS_TOL:g}), parameters and BatchNorm statistics "
                  f"max|d|/max {gap:.3e} ({worst}; tol {DP_PARAM_TOL:g}); {s2:.2f} s vs {s1:.2f} s (the two-rank time "
                  f"includes spawning the second rank; gloo stages CUDA tensors through the host, so this time says "
                  f"nothing about NCCL) on {card}")
            check(len(logs1) == len(logs2) == DP_EPOCHS, f"5j: {model} epochs {len(logs2)}")
            check(loss_gap <= DP_LOSS_TOL, f"5j: the {model}'s data-parallel losses disagree with one process")
            check(gap <= DP_PARAM_TOL, f"5j: the {model}'s data-parallel state disagrees with one process ({worst})")
        # the same in float32, as users train, beside the float32 fit's own floor: its state under a 1e-7 input change
        deterministic, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
        f32 = {tag: dp_fit("cnn", CNN_PARAMS, dev, tmp / "f32" / tag, Xs, y, Xv, yv, names, **dp)
               for tag, Xs, dp in (("one", X, {}), ("two", X, two_ranks), ("moved", X * np.float32(1 + 1e-7), {}))}
        torch.backends.cudnn.deterministic = deterministic
        loss32, gap32, worst32 = fit_gap(f32["one"][0], f32["two"][0], f32["one"][1], f32["two"][1])
        _, floor32, floor_worst = fit_gap(f32["one"][0], f32["moved"][0], f32["one"][1], f32["moved"][1])
        print(f"[5j] cnn in float32, cuDNN deterministic: data_parallel=2 (gloo, one card) vs one process: losses max rel "
              f"{loss32:.3e}, state max|d|/max {gap32:.3e} ({worst32}); the one-process fit against itself with its "
              f"input x (1 + 1e-7): {floor32:.3e} ({floor_worst}); not gated (the float64 fits above are) on {card}")
        print(f"[5j] all-reduce bytes a step (float32 gradients, one DDP bucket each): flagship cnn {counts['cnn']} "
              f"parameters, {4 * counts['cnn'] / 1e6:.3f} MB; ds_cnn at JAX's defaults {counts['ds_cnn']} parameters, "
              f"{4 * counts['ds_cnn'] / 1e6:.3f} MB (the ds_cnn adds 5 BatchNorm all-reduces a forward, 3 floats a "
              f"channel)")

        # the model axis of every deep family JAX places: two gloo ranks sharing the card, NCCL across two cards
        model_axis_checks(dev, card, [dev, dev], "gloo", X, y)
        if torch.cuda.device_count() >= 2:
            model_axis_checks(dev, card, [torch.device("cuda", 0), torch.device("cuda", 1)], "nccl", X, y)

        # world size 1 through NCCL: the DDP wrapper against the plain step
        mesh_out = pm.run_ranks(mesh_step_check, ((32, 512), card), [dev], backend="nccl")
        mesh_launches = sum(r["launches"] for r in mesh_out.values())
        for b, r in mesh_out.items():
            print(f"[5j] make_sharded_train_step on a 1-card NCCL mesh, waveform -> mel -> flagship cnn "
                  f"({r['params']} parameters), B={b} x 5 s: loss vs the plain step rel {r['loss_gap']:.3e} (tol "
                  f"{MESH_LOSS_TOL:g}), parameters after the step max|d|/max {r['param_gap']:.3e} (tol "
                  f"{MESH_PARAM_TOL:g}); mel_rfft launches {r['launches']}; step {r['ms_mesh']:.3f} ms vs plain "
                  f"{r['ms_plain']:.3f} ms: DDP overhead {r['ms_mesh'] - r['ms_plain']:.3f} ms "
                  f"({100 * (r['ms_mesh'] / r['ms_plain'] - 1):.1f} %) on {card}")
            check(r["loss_gap"] <= MESH_LOSS_TOL and r["param_gap"] <= MESH_PARAM_TOL,
                  f"5j: the 1-card mesh step disagrees with the plain step at B={b}")
            check(r["launches"] == 1, f"5j: the mesh step launched mel_rfft {r['launches']} times")

        # split paths on one card: 2 parts each
        clips = synth_clips(rng, 8)
        mel_kernel.counter.reset()
        f_split = get_extractor("audio_mel_spec")(duration=5.0, devices=[dev, dev])._device_batch(clips, None)
        split_launches = mel_kernel.counter.launches
        mel_kernel.counter.reset()
        f_one = get_extractor("audio_mel_spec")(duration=5.0, device=dev)._device_batch(clips, None)
        one_launches = mel_kernel.counter.launches
        gold = max(float(np.abs(f_split[i] - golden.mel_spec_feature(clips[i])).max()) for i in (0, 4, 7))
        print(f"[5j] extraction of 8 clips split in 2 parts on the card: bit for bit the one-call features "
              f"{bool(np.array_equal(f_split, f_one))}, 3 rows vs golden {gold:.3e} (tol {FEATURE_TOL:g}); mel_rfft "
              f"launches {split_launches} split, {one_launches} in one call")
        check(np.array_equal(f_split, f_one), "5j: the split extraction differs from the one call")
        check(gold <= FEATURE_TOL, "5j: the split extraction misses the golden gate")
        check(split_launches == 2 and one_launches == 1, "5j: not one mel_rfft launch a part")

        X_fit, y_fit, _, _ = fsc22_classical(np.random.default_rng(22))
        fold_of = search_cv.stratified_fold_ids(y_fit.astype(np.int64), 5, 42)
        cell = {"n_components": 50, "C": 1.0, "kernel": "rbf"}
        dec, cv_s = {}, {}
        for tag, devs in (("one", 1), ("split", [dev, dev])):
            eng = search_cv._CVEngine(X_fit, y_fit, fold_of, N_CLASSES, device=dev, devices=devs)
            t0 = time.perf_counter()
            dec[tag] = eng.svm_decisions(cell, eng._pca_parts(cell))
            cv_s[tag], parts = time.perf_counter() - t0, [len(p.folds) for p in eng.parts]
        cv_gap = float(np.abs(dec["split"] - dec["one"]).max() / np.abs(dec["one"]).max())
        print(f"[5j] pca_svm cell {cell} on {len(X_fit)} rows, 5 folds split in parts of {parts} on the card vs "
              f"unsplit: decisions max|d|/max {cv_gap:.3e} (tol {SPLIT_CV_TOL:g}); {cv_s['split']:.2f} s vs "
              f"{cv_s['one']:.2f} s on {card}")
        check(cv_gap <= SPLIT_CV_TOL, "5j: the split CV cell disagrees with the unsplit one")

        Xg = (X[..., None] - X.mean()) / X.std()
        arch = {"type": "cnn", **CNN_PARAMS, "dropout": 0.0, "n_classes": N_CLASSES, "input_shape": list(Xg.shape[1:])}
        states = tune_batched.init_states(arch, BATCHED_K, 42)
        lrs, rates, seeds = [3e-4, 1e-3, 3e-3, 9e-3], [0.3] * BATCHED_K, [43 + i for i in range(BATCHED_K)]
        idx = np.random.default_rng(42).permutation(len(Xg))[: (len(Xg) // 32) * 32].reshape(-1, 32)
        Xg_d, yg_d = torch.from_numpy(Xg).to(dev, torch.float64), torch.from_numpy(y.astype(np.int64)).to(dev)
        whole = tune_batched.TrialGroup(arch, states, lrs, rates, dev, torch.float64, noise_seeds=seeds)
        halves = [tune_batched.TrialGroup(arch, states[m], lrs[m], rates[m], dev, torch.float64, noise_seeds=seeds[m])
                  for m in (slice(0, 2), slice(2, 4))]
        loss_whole = whole.epoch(Xg_d, yg_d, idx).cpu()
        loss_halves = torch.cat([h.epoch(Xg_d, yg_d, idx) for h in halves]).cpu()
        trial_loss_gap = float(((loss_halves - loss_whole).abs() / loss_whole.abs()).max())
        trial_gap = max(float((torch.cat([h.params[k].detach() for h in halves]) - p.detach()).abs().max())
                        / max(float(p.detach().abs().max()), 1e-30) for k, p in whole.params.items())
        msgs: list[str] = []
        handler = logging.Handler(logging.INFO)
        handler.emit = lambda record: msgs.append(record.getMessage())
        port_log = logging.getLogger("audio_edge_ml_pipeline_torch")
        port_log.addHandler(handler)
        level, _ = port_log.level, port_log.setLevel(logging.INFO)
        try:
            draws = [{**CNN_PARAMS, "batch_size": 32, "learning_rate": lr, "dropout": 0.3} for lr in lrs]
            res = tune_batched.train_trial_group("cnn", draws, X, y, Xv, yv, N_CLASSES, 1, seed=42, device=dev,
                                                 devices=[dev, dev])
        finally:
            port_log.removeHandler(handler)
            port_log.setLevel(level)
        print(f"[5j] {BATCHED_K}-trial cnn group ({CNN_PARAMS}, dropout 0.3, masks from each trial's generator) "
              f"split in 2 parts on the card vs unsplit, one epoch in float64: losses max rel {trial_loss_gap:.3e} "
              f"(tol {GROUP_LOSS_TOL:g}), parameters max|d|/max {trial_gap:.3e} (tol {GROUP_PARAM_TOL:g}); "
              f"train_trial_group split: {[round(r['val_accuracy'], 4) for r in res]}")
        check(trial_loss_gap <= GROUP_LOSS_TOL and trial_gap <= GROUP_PARAM_TOL,
              "5j: the split trial group disagrees with the unsplit one")
        check(any("sharded over 2 devices" in m for m in msgs) and len(res) == BATCHED_K,
              "5j: train_trial_group did not split its trials")

        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            print(f"[5j] NCCL across cards (the train CLI with data_parallel, the tune CLI on "
                  f"fsc22-27-classes-tuning.yaml, the extraction over the cards, dryrun_multichip) needs >= 2 "
                  f"cards; this machine has {n_cards}")
        else:
            multi_card(min(4, n_cards), n_cards, dev, card, tmp, X, y, Xv, yv, names)
    print(f"[5j] phase time {time.perf_counter() - t_phase:.1f} s")
    return {"mel_launches": mesh_launches + split_launches}


def multi_card(n: int, n_cards: int, dev, card: str, tmp: Path, X, y, Xv, yv, names: list[str]) -> None:
    """5j on n >= 2 cards through NCCL (``phase_5j``)."""
    import logging
    import os

    from audio_edge_ml_pipeline_torch.entry import dryrun_multichip
    from audio_edge_ml_pipeline_torch.features import get as get_extractor
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.features.base import FeatureSet
    from audio_edge_ml_pipeline_torch.models.deep import MODEL_FILENAME, load_model_bundle
    from audio_edge_ml_pipeline_torch.ops import mel_kernel
    from audio_edge_ml_pipeline_torch.train import train, tune

    for tag, (Xs, ys) in (("mel_train", (X, y)), ("mel_val", (Xv, yv))):
        pipeline.FeaturePipeline.save(FeatureSet(features=Xs, feature_type="audio_mel_spec", modality="audio",
                                                 metadata=[{} for _ in ys], labels=ys, label_names=names), tmp / tag)
    X_ct, y_ct = fsc22_classical_train(np.random.default_rng(22))
    pipeline.FeaturePipeline.save(FeatureSet(features=X_ct, feature_type="classical", modality="audio",
                                             metadata=[{} for _ in y_ct], labels=y_ct, label_names=names),
                                  tmp / "classical_train")
    msgs: list[str] = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: msgs.append(record.getMessage())
    port_log = logging.getLogger("audio_edge_ml_pipeline_torch")
    port_log.addHandler(handler)
    level, _ = port_log.level, port_log.setLevel(logging.INFO)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        args = ["--features", str(tmp / "mel_train"), "--model", "cnn", "--experiment", "dp"] + sum(
            (["--param", f"{k}={json.dumps(v, separators=(',', ':'))}"]
             for k, v in {**CNN_PARAMS, "epochs": DP_EPOCHS, "dropout": 0.0, "batch_size": DP_BATCH}.items()), [])
        gaps, secs = {}, {}
        for dtype in ("float64", "float32"):
            for tag, extra in (("one", []), ("dp", ["--param", f"data_parallel={n}"])):
                t0 = time.perf_counter()
                train.main([*args, "--param", f"dtype={dtype}", "--output", str(tmp / f"cli_{dtype}_{tag}"), *extra])
                secs[dtype, tag] = time.perf_counter() - t0
            _, flat1, _, _ = load_model_bundle(tmp / f"cli_{dtype}_one" / "cnn" / MODEL_FILENAME)
            _, flatn, _, _ = load_model_bundle(tmp / f"cli_{dtype}_dp" / "cnn" / MODEL_FILENAME)
            gaps[dtype] = max((float(np.abs(flatn[k] - flat1[k]).max() / max(np.abs(flat1[k]).max(), 1e-30)), k)
                              for k in flat1)
        print(f"[5j] train CLI --param data_parallel={n} on {n} cards (NCCL) vs 1 card: bundle max|d|/max in float64 "
              f"{gaps['float64'][0]:.3e} ({gaps['float64'][1]}; tol {DP_PARAM_TOL:g}), in float32 {gaps['float32'][0]:.3e} "
              f"({gaps['float32'][1]}; not gated, beside the float32 floor above); float32 {secs['float32', 'dp']:.2f} s "
              f"vs {secs['float32', 'one']:.2f} s on {n} x {card}")
        check(any(f"data-parallel training over {n} devices" in m for m in msgs), "5j: no data-parallel log line")
        check(gaps["float64"][0] <= DP_PARAM_TOL, "5j: the data-parallel CLI run disagrees with the 1-card run")

        cfg = tuning_27_copy(tmp / "mel_train", tmp / "mel_val", tmp / "classical_train", tmp / "tune27")
        t0 = time.perf_counter()
        tune.main(["--config", str(cfg)])
        tune_s = time.perf_counter() - t0
        shortlist = json.loads((tmp / "tune27" / "tuned" / "shortlist.json").read_text())
        print(f"[5j] tune CLI on fsc22-27-classes-tuning.yaml (cut) across {n} cards: {tune_s:.2f} s; shortlist "
              f"{[(c['model'], round(c['val_f1_macro'], 4)) for c in shortlist['candidates']]}; "
              f"{[m for m in msgs if 'across' in m or 'split over' in m or 'sharded over' in m]}")
        check(sorted(c["model"] for c in shortlist["candidates"]) == ["cnn", "pca_svm"], "5j: the 27-class shortlist")
        check(any("across 4 devices" in m for m in msgs) and any(f"folds split over {n} devices" in m for m in msgs),
              "5j: the CV folds did not split over the cards")
    finally:
        os.chdir(cwd)
        port_log.removeHandler(handler)
        port_log.setLevel(level)
    clips = synth_clips(np.random.default_rng(3), 4 * n)
    mel_kernel.counter.reset()
    ex = get_extractor("audio_mel_spec")(duration=5.0)
    f_cards = ex._device_batch(clips, None)
    launches = mel_kernel.counter.launches
    f_one = get_extractor("audio_mel_spec")(duration=5.0, device=dev)._device_batch(clips, None)
    print(f"[5j] extraction over {len(ex.devices)} cards: {launches} mel_rfft launches, bit for bit the 1-card "
          f"features {bool(np.array_equal(f_cards, f_one))}")
    check(len(ex.devices) == n_cards and launches == n_cards and np.array_equal(f_cards, f_one),
          "5j: the extraction over the cards")
    t0 = time.perf_counter()
    line = dryrun_multichip(n)
    print(f"[5j] {line} ({time.perf_counter() - t0:.2f} s on {n} x {card})")


def main() -> int:
    import torch

    t_all = time.perf_counter()
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
    from audio_edge_ml_pipeline_torch.utils.dropout import GlobalBatchNoise

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
    kernels = ["mel_rfft", "mel_czt", "mel_folded", "mel_unfolded", "mel_epilogue"]
    built = _build.build([*kernels, "wavio"])   # and the native WAV reader (g++), all started together
    print(f"[2] build: {time.perf_counter() - t0:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in built.items()) or 'already built'})")
    for kname in kernels:
        ptxas = ptxas_report(_build.library_path(kname).with_suffix(".log").read_text())
        print(f"[2] {kname} ptxas: {' | '.join(ptxas)}")
    if sys.argv[1:] == ["--only", "5j"]:   # the parallel phase alone, e.g. its NCCL part on a machine of several cards
        phase_5j(dev, card)
        if torch.cuda.device_count() >= 2:   # and 5i's capture on a card that is not current, on a seeded bundle
            from audio_edge_ml_pipeline_torch.features.base import FeatureSet

            with tempfile.TemporaryDirectory(prefix="chip_smoke_5i_") as tmp_s:
                tmp = Path(tmp_s)
                bundle = seeded_bundle("cnn", CNN_PARAMS, (N_MELS, 1 + CLIP // HOP, 1), tmp / MODEL_FILENAME)
                X = np.random.default_rng(12).random((40, N_MELS, 1 + CLIP // HOP), dtype=np.float32)
                pipeline.FeaturePipeline.save(FeatureSet(features=X, feature_type="deep", modality="audio",
                                                         metadata=[{} for _ in X], labels=np.arange(40) % N_CLASSES,
                                                         label_names=[str(i) for i in range(N_CLASSES)]),
                                              tmp / "features")
                other_card_capture(tmp, bundle, tmp / "features", card)
        print(f"[7] the run took {time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["--only", "5l"]:   # the tools phase alone: it makes its own data
        phase_5l(dev, card)
        print(f"[7] the run took {time.perf_counter() - t_all:.1f} s")
        return 0

    # 3. kernel against its plain version, feature against the float64 golden copy
    rng = np.random.default_rng(0)

    entries = {  # entry -> (its module, its plain version, its earlier dense kernel's launch)
        "mel_power_folded": (mel_kernel, mel_kernel.mel_power_folded_plain, mel_kernel.launch_dense),
        "mel_power_unfolded": (mel_unfolded, mel_unfolded.mel_power_unfolded_plain, mel_unfolded.launch_dense),
    }

    def routed(n_fft: int, precise: bool) -> str:
        """The template instantiation ``route(n_fft)`` launches."""
        return mel_kernel.instantiation("mel_czt" if mel_kernel.route(n_fft) == "czt" else "rfft", n_fft, precise)

    errs_by_instantiation: dict[str, float] = {}   # max|d| against the plain version, by template instantiation

    def against_plain(entry: str, label: str, batch: int, n: int, sr: int, n_fft: int, hop: int,
                      n_mels: int, precise: bool = False) -> float:
        """One call of ``entry`` on the card, which must launch its kernel once
        on the route ``route(n_fft)`` names (its float64 instantiation if
        ``precise``), held against its plain version at KERNEL_REL_TOL of
        each clip's peak power, and if ``precise`` at F64_ELEMENT_TOL of
        each bin (the plain version's products run in float64, so only a
        float64 kernel meets that). Returns max|d|."""
        module, plain_fn, _ = entries[entry]
        czt = module.route(n_fft) == "czt"
        y = torch.from_numpy(synth_clips(rng, batch, n)).to(dev)
        module.counter.reset()
        module.counter_czt.reset()
        mel_kernel.counter_f64.reset()
        out = getattr(module, entry)(y, sr, n_mels, n_fft, hop, **({"precise": True} if precise else {}))
        torch.cuda.synchronize()
        launches = (module.counter.launches, module.counter_czt.launches)
        check(mel_kernel.counter_f64.launches == int(precise), f"{entry} float64 launches")
        kernel = routed(n_fft, precise)
        check(dict(module.counter.by_instantiation) == {kernel: 1},
              f"{entry} at n_fft {n_fft} launched {dict(module.counter.by_instantiation)}, not {kernel}")
        ref = plain_fn(y, sr, n_mels, n_fft, hop)
        err = (out - ref).abs()
        rel = float((err / ref.abs().amax(dim=(1, 2), keepdim=True)).max())
        rel_bin = float((err / ref.abs().clamp_min(torch.finfo(torch.float32).tiny)).max())
        errs_by_instantiation[kernel] = max(errs_by_instantiation.get(kernel, 0.0), float(err.max()))
        print(f"[3] {entry} n_fft {n_fft}, hop {hop}, {n_mels} mels ({kernel}) vs plain, {label}: "
              f"launches (all, czt) {launches}, max|d| {float(err.max()):.3e}, max|d|/clip peak {rel:.3e} "
              f"(tol {KERNEL_REL_TOL:g}), max|d|/|plain| per bin {rel_bin:.3e}"
              + (f" (tol {F64_ELEMENT_TOL:g})" if precise else " (not checked)"))
        check(not precise or rel_bin <= F64_ELEMENT_TOL,
              f"{entry}'s float64 instantiation disagrees with its plain version per bin at n_fft {n_fft}: {rel_bin:.3e}")
        check(launches == (1, int(czt)), f"{entry} at n_fft {n_fft} launched (all, czt) {launches}")
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
    # each entry's off-plan route (mel_czt, chirp-z at 482 and 2050), and the folded one's float64 instantiation
    for entry in entries:
        against_plain(entry, "B=4 x 5 s", 4, CLIP, SR, CZT_N_FFT, HOP, N_MELS)
    against_plain("mel_power_folded", "B=4 x 5 s", 4, CLIP, SR, CZT_N_FFT, HOP, N_MELS, precise=True)
    against_plain("mel_power_folded", f"MFCC front end at n_fft {CZT_N_FFT_22}", 2, 66150, 22050, CZT_N_FFT_22,
                  512, 128, precise=True)
    # the off-plan route at a direct size (M = 2048)
    against_plain("mel_power_folded", "direct, B=2 x 5 s @ 22.05 kHz", 2, CLIP22, SR22, DIRECT_N_FFT_22, MFCC_HOP,
                  MFCC_MELS)
    against_plain("mel_power_folded", "direct, B=2 x 5 s @ 22.05 kHz", 2, CLIP22, SR22, DIRECT_N_FFT_22, MFCC_HOP,
                  MFCC_MELS, precise=True)
    against_plain("mel_power_unfolded", "direct, B=2 x 5 s @ 22.05 kHz", 2, CLIP22, SR22, DIRECT_N_FFT_22, MFCC_HOP,
                  MFCC_MELS)
    # no even n_fft from 4 to 4096 raises, in either precision, against the plain version at SWEEP_N_FFT ...
    for n_fft in SWEEP_N_FFT:
        for precise in (False, True):
            against_plain("mel_power_folded", "sweep, B=2 x 1 s", 2, SR, SR, n_fft, HOP, N_MELS, precise=precise)
    # ... and every one off the compiled plans through both entries
    sweep_off_plan(dev, rng, mel_kernel, mel_unfolded, errs_by_instantiation)
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
    if sys.argv[1:] == ["--only", "mel"]:   # the mel kernels alone: phase 3, then phase 6's off-plan and four-pass times
        mel_route_times(dev, card, entries, *(torch.from_numpy(np.tile(synth_clips(rng, 8, 5 * sr, sr), (64, 1))).to(dev)
                                              for sr in (SR, SR22)))
        epilogue_times(dev, card, rng)
        print(f"[7] the run took {time.perf_counter() - t_all:.1f} s")
        return 0

    # 3c. the MFCC and classical features on the card, with TF32 allowed everywhere, at the extractors'
    # n_fft 1024, at 2048 (mel_rfft's route) and 2050 (mel_czt's float64 chirp-z route); the mel feature at 511 and 2048
    y22_np = synth_clips(rng, 4, CLIP22, SR22)
    y22 = torch.from_numpy(y22_np).to(dev)
    y16_np = synth_clips(rng, 4)
    y16 = torch.from_numpy(y16_np).to(dev)
    y22_64 = y22_np.astype(np.float64)
    t22 = {nf: 1 + CLIP22 // MFCC_HOP for nf in (MFCC_N_FFT, 2048, CZT_N_FFT_22)}
    f64 = {nf: routed(nf, True) for nf in (MFCC_N_FFT, 2048, CZT_N_FFT_22)}
    cases3c = {  # label -> (feature on the card, golden, tol, shape, launches (all, czt, float64), instantiation)
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
            (1, int(nf == CZT_N_FFT_22), 1), f64[nf])
           for name in ("mfcc_seq_feature", "classical_feature_vector") for nf in (2048, CZT_N_FFT_22)},
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
            mel_kernel.counter_czt.reset()
            mel_kernel.counter_f64.reset()
            feats3c[label] = fn().cpu().numpy()
            torch.cuda.synchronize()
            mfcc_launches[label] = ((mel_kernel.counter.launches, mel_kernel.counter_czt.launches,
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
              f"(all, czt, float64) {mfcc_launches[label][0]}, {mfcc_launches[label][1]}")
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
        mel_kernel.counter_czt.reset()
        mel_kernel.counter_epilogue.reset()
        t0 = time.perf_counter()
        pipeline.main(["--loader", "fsc22", "--dataset", str(fsc22), "--extractor", "audio_mel_spec",
                       "--split", "all", "--output", str(tmp / "features")])
        extract_s = time.perf_counter() - t0
        extract_launches = mel_kernel.counter.launches
        extract_czt = mel_kernel.counter_czt.launches   # may not launch
        extract_epilogue = mel_kernel.counter_epilogue.launches
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
        print(f"[4] extraction CLI: {fs} in {extract_s:.2f} s; mel_rfft launches {extract_launches - extract_czt}, "
              f"mel_czt launches {extract_czt}, mel_epilogue launches {extract_epilogue}; 3 rows vs float64 golden "
              f"max|d| {cli_err:.3e}")
        check(extract_launches > 0 and extract_czt == 0, "the extraction CLI did not run the FFT mel kernel")
        check(extract_epilogue == extract_launches,
              f"the extraction CLI launched the epilogue kernel {extract_epilogue} times for {extract_launches} batches")
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
        mel_unfolded.counter_czt.reset()
        mel_u = mel_unfolded.mel_power_unfolded(tree_d).cpu().numpy()
        unfolded_launches = mel_unfolded.counter.launches
        unfolded_czt = mel_unfolded.counter_czt.launches   # may not launch
        gold_rel = max(float(np.abs(mel_u[j].T - g).max() / np.abs(g).max())
                       for j, g in zip((0, n_clips // 2, n_clips - 1), gold_mel))
        print(f"[4] mel_power_unfolded on the {n_clips} tree clips: shape {mel_u.shape}, mel_rfft launches "
              f"{unfolded_launches - unfolded_czt}, mel_czt launches {unfolded_czt}; "
              f"3 clips vs float64 golden mel power max|d|/clip peak {gold_rel:.3e} (tol {GOLDEN_REL_TOL:g})")
        check(unfolded_launches == 1 and unfolded_czt == 0,
              f"mel_power_unfolded launched {unfolded_launches} kernels ({unfolded_czt} czt) for one call")
        check(mel_u.shape == (n_clips, 1 + CLIP // HOP, N_MELS), "unfolded mel shape")
        check(gold_rel <= GOLDEN_REL_TOL, "the unfolded kernel misses the golden mel power")
        # and its off-plan route, mel_czt (chirp-z), once that of its dense kernel
        mel_unfolded.counter.reset()
        mel_unfolded.counter_czt.reset()
        mel_ud = mel_unfolded.mel_power_unfolded(tree_d, n_fft=CZT_N_FFT).cpu().numpy()
        unfolded_czt_launches = dict(mel_unfolded.counter.by_instantiation)
        gold_rel_d = max(float(np.abs(mel_ud[j].T - g).max() / np.abs(g).max())
                         for j, g in ((j, golden.melspectrogram(tree[j].astype(np.float64), sr=SR, n_mels=N_MELS,
                                                                n_fft=CZT_N_FFT, hop_length=HOP))
                                      for j in (0, n_clips // 2, n_clips - 1)))
        print(f"[4] mel_power_unfolded at n_fft {CZT_N_FFT} on the {n_clips} tree clips: launches "
              f"{unfolded_czt_launches}, czt {mel_unfolded.counter_czt.launches}; 3 clips vs float64 golden mel power max|d|/clip peak "
              f"{gold_rel_d:.3e} (tol {GOLDEN_REL_TOL:g})")
        check(unfolded_czt_launches == {"mel_czt<float>": 1} and mel_unfolded.counter_czt.launches == 1,
              "mel_power_unfolded's off-plan route is not mel_czt")
        check(gold_rel_d <= GOLDEN_REL_TOL, "mel_czt through the unfolded entry misses the golden mel power")

        # 4c. the shipped extraction config on the same tree, through the CLI on the card
        cfg, shipped = shipped_config_copy(fsc22, tmp / "shipped")
        shipped_launches: dict[str, tuple[int, int]] = {}
        shipped_s: dict[str, float] = {}
        run_experiment = pipeline._run_experiment

        counters = (mel_kernel.counter, mel_kernel.counter_f64, mel_kernel.counter_czt)

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
                  f"{shipped_s[exp['name']]:.2f} s; mel_rfft launches {launches_exp[0] - launches_exp[2]} "
                  f"({launches_exp[1]} float64), czt {launches_exp[2]}; 3 rows vs float64 "
                  f"golden {err_exp:.3e} "
                  f"(tol {tol:g})")
            check(err_exp <= tol, f"{exp['name']} misses its gate against golden")
            mfcc_exp = exp["extractor"] != "audio_mel_spec"
            check(launches_exp[0] >= 1 and launches_exp[2] == 0 and launches_exp[1] == launches_exp[0] * mfcc_exp,
                  f"{exp['name']} launched (all, float64, czt) {launches_exp}: not the FFT mel kernel it should")

        native_reader_checks(audio_dir, [m["filename"] for m in fs.metadata], tmp)

        # 4d. the repaired sizes through the extraction CLI, counted by instantiation: mel_rfft's four-pass plans
        # and this slice's path, the off-plan route (mel_czt<float> at 482, mel_czt<double> at 2050)
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
            kernel = routed(prm["n_fft"], mfcc_exp)
            print(f"[4d] repaired size {exp['name']} ({exp['extractor']}, n_fft {prm['n_fft']}): {fs_exp} in "
                  f"{slice_s[exp['name']]:.2f} s; launches {slice_launches[exp['name']]}; 3 rows vs float64 golden "
                  f"{err_exp:.3e} (tol {FEATURE_TOL:g})")
            check(err_exp <= FEATURE_TOL, f"{exp['name']} misses its gate against golden")
            check(set(slice_launches[exp["name"]]) == {kernel}, f"{exp['name']} did not run {kernel}")
            for k, v in slice_launches[exp["name"]].items():
                path_launches[k] = path_launches.get(k, 0) + v

        # 4e-4g. BIRDeep end to end (ROADMAP §3 i), the augmentation stage, the AEP_PROFILE_DIR trace
        t4e = phase_4e(dev, tmp)
        t4f = phase_4f(dev, tmp)
        t4g = phase_4g(dev, tmp, card)

        # 4h-4j. audio_cqt on the same tree, then the image and video modalities
        t4h = phase_4h(dev, tmp, fsc22, split_rows["train"])
        t4i = phase_4i(dev, tmp)
        phase_4j(dev, tmp)

        # 4k-4l. the text and tabular modalities: no kernel of the port on their path
        mel_before = (mel_kernel.counter.launches, mel_kernel.counter_czt.launches, mel_unfolded.counter.launches,
                      mel_unfolded.counter_czt.launches)
        phase_4k(dev, tmp, card)
        phase_4l(dev, tmp, card)
        check((mel_kernel.counter.launches, mel_kernel.counter_czt.launches, mel_unfolded.counter.launches,
               mel_unfolded.counter_czt.launches) == mel_before, "4k-4l launched a mel kernel")

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
        mel_kernel.counter_czt.reset()
        mel_kernel.counter_epilogue.reset()
        sim = EdgeDeviceSimulator(bundle, class_names, folder, device_id="smoke",
                                  telemetry_dir=tmp / "telemetry", stats_dir=tmp / "stats", seed=0)
        t0 = time.perf_counter()
        sim.run(8)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_launches = mel_kernel.counter.launches
        serve_czt = mel_kernel.counter_czt.launches   # may not launch
        serve_epilogue = mel_kernel.counter_epilogue.launches
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
        print(f"[5] edge simulator: 8 requests in {serve_s:.3f} s, mel_rfft launches {serve_launches - serve_czt}, "
              f"mel_czt launches {serve_czt}, mel_epilogue launches {serve_epilogue}, "
              f"avg confidence {stats['avg_confidence']:.4f}; confidence vs all-CPU path max|d| {conf_err:.3e}")
        check(serve_launches == 8 and serve_czt == 0,
              f"the simulator launched the mel kernels {serve_launches} times ({serve_czt} czt) for 8 requests")
        check(serve_epilogue == 8, f"the simulator launched the epilogue kernel {serve_epilogue} times for 8 requests")
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
        mel_kernel.counter_czt.reset()
        mel_kernel.counter_epilogue.reset()
        sim = EdgeDeviceSimulator(trained, class_names, folder, device_id="trained",
                                  telemetry_dir=tmp / "telemetry", stats_dir=tmp / "stats", seed=1)
        sim.run(4)
        torch.cuda.synchronize()
        trained_launches = mel_kernel.counter.launches
        trained_czt = mel_kernel.counter_czt.launches   # may not launch
        trained_epilogue = mel_kernel.counter_epilogue.launches
        events = [json.loads(ln) for ln in (tmp / "telemetry" / "trained_telemetry.jsonl").read_text().splitlines()]
        print(f"[5b] edge simulator on the trained bundle: 4 requests, mel_rfft launches {trained_launches - trained_czt}, "
              f"mel_czt launches {trained_czt}, mel_epilogue launches {trained_epilogue}, "
              f"predictions {[e['prediction'] for e in events]}")
        check(len(events) == 4 and all(e["prediction"] in class_names for e in events), "served trained bundle")
        check(trained_launches == 4 and trained_czt == 0,
              f"the simulator launched the mel kernels {trained_launches} times ({trained_czt} czt) for 4 "
              "requests")
        check(trained_epilogue == 4, f"the simulator launched the epilogue kernel {trained_epilogue} times for 4 requests")

        X_step, y_step = fs.features[:32], fs.labels[:32]
        # From phase 5's seeded bundle, not the trained one: training on the card does not repeat from run to
        # run, and a ReLU or max-pool near-tie in one run's weights can go the other way on the CPU (once
        # 9.2e-5 of the 1e-4 limit on an H100).
        step = grad_gap(dev, X_step, y_step, bundle)
        loss_gpu, loss_cpu, loss_rel, grad_rel, grad_worst, n_grads = (
            step[k] for k in ("loss", "loss_cpu", "loss_rel", "grad_rel", "worst", "n_grads"))
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
            step = grad_gap(dev, fs_run.features[:32], fs_run.labels[:32], tmp / f"{model}_seeded.npz", model, params)
            loss_gpu, loss_cpu, loss_rel, grad_rel, grad_worst, n_grads = (
                step[k] for k in ("loss", "loss_cpu", "loss_rel", "grad_rel", "worst", "n_grads"))
            print(f"[5c] one {model} train step ({params}, B=32, dropout 0) card vs CPU: loss {loss_gpu:.6f} vs "
                  f"{loss_cpu:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_TOL:g}); gradients max|d|/max|g| "
                  f"{grad_rel:.3e} ({grad_worst}, the worst of {n_grads} tensors; tol {GRAD_TOL:g}, TF32 off)")
            check(loss_rel <= STEP_LOSS_TOL, f"the {model} train-step loss on the card disagrees with the CPU")
            check(grad_rel <= GRAD_TOL, f"the {model} train-step gradients on the card disagree with the CPU")

        # 5f. the post-training stages on 5c's runs: select, optimize, select --post-opt, deploy
        t5f = phase_5f(dev, tmp / "runs", experiment, tree[0])
        mel108 = pipeline.FeaturePipeline.load(tmp / "shipped" / "fsc22_mel_train")       # for 5g
        mfcc108 = pipeline.FeaturePipeline.load(tmp / "shipped" / "fsc22_mfcc_seq_train")

        # 5h-5i. the serving loop with the REST tracking backend; the compile stage on 5b's bundle
        t5h = phase_5h(dev, tmp, folder, class_names, card)
        phase_5i(dev, tmp, trained, tmp / "features", card)
        phase_5k(dev, tmp, trained, tmp / "features", card)

        # 5l. the repository tools and scripts through the port: the quick start, the manifest, stage 8
        t5l = phase_5l(dev, card)

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

    # 5g. the ds_cnn, the transformer, and the KD recipe (teacher, then student) through the train CLI on the card
    t5g = phase_5g(dev, mel108, mfcc108, t5e)

    # 5j. the parallel layer: data-parallel fits, the mesh step, the splits (NCCL across cards where there are >= 2)
    t5j = phase_5j(dev, card)

    # 6. timing at B=512 five-second clips
    batch = 512
    waves = torch.from_numpy(np.tile(synth_clips(rng, 8), (batch // 8, 1))).to(dev)

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
    # a yardstick on no path: the same mel power composed of library calls (cuFFT's STFT, then cuBLAS's mel GEMM)
    fb = torch.from_numpy(golden.mel_filterbank(SR, N_FFT, N_MELS).astype(np.float32)).to(dev)
    hann = torch.hann_window(N_FFT, periodic=True, device=dev)

    def composed():
        spec = torch.stft(waves, N_FFT, HOP, window=hann, center=True, pad_mode="constant", return_complex=True)
        return torch.matmul(fb, spec.abs() ** 2)

    with torch.inference_mode():
        ms_composed = cuda_ms(composed)
        ref = mel_kernel.mel_power_folded(waves).transpose(1, 2)
        composed_rel = float(((composed() - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)).max())
        del ref
    ms_unf_plain = cuda_ms(lambda: mel_unfolded.mel_power_unfolded_plain(waves))
    mel_nonzeros = int(np.count_nonzero(golden.mel_filterbank(SR, N_FFT, N_MELS)))
    bound_ms, bound_by, fft_ms, dense_ms, unf_dense_ms = mel_folded_bound(batch, CLIP, N_FFT, mel_nonzeros)
    nonzeros_400 = int(np.count_nonzero(golden.mel_filterbank(SR, 400, N_MELS)))
    bound_400, bound_by_400, fft_400, dense_400, unf_dense_400 = mel_folded_bound(batch, CLIP, 400, nonzeros_400)
    module, forward = flagship()
    module.to(dev)
    params = dict(served._net.state_dict())
    with torch.inference_mode():
        mel_kernel.counter.reset()
        mel_kernel.counter_epilogue.reset()
        ms_e2e = cuda_ms(lambda: forward(params, waves), iters=10)   # 3 warm-up calls and 10 timed
        forward_launches = (mel_kernel.counter.launches, mel_kernel.counter_epilogue.launches)
        check(forward_launches == (13, 13), f"13 flagship forwards launched (mel_rfft, mel_epilogue) {forward_launches}")
        mel = mel_kernel.mel_power_folded(waves).transpose(1, 2)
        ms_epilogue = cuda_ms(lambda: mel_kernel.launch_epilogue(mel, None, HOP))
        x = mel_kernel.launch_epilogue(mel, None, HOP).transpose(1, 2)[..., None]
        ms_cnn = cuda_ms(lambda: module(x), iters=10)

    print(f"[6] bound at B={batch} x 5 s, hop {HOP}, {N_MELS} mels: n_fft {N_FFT} {bound_ms:.4f} ms ({bound_by}; "
          f"least operations at the float32 peak: FFT {fft_ms:.4f} ms with {mel_nonzeros} mel nonzeros, dense "
          f"folded DFT {dense_ms:.3f} ms, dense unfolded DFT {unf_dense_ms:.3f} ms); n_fft 400 {bound_400:.4f} ms "
          f"({bound_by_400}; FFT {fft_400:.4f} ms with {nonzeros_400} mel nonzeros, dense folded {dense_400:.3f} ms, "
          f"dense unfolded {unf_dense_400:.3f} ms) on {card}")
    print(f"[6] n_fft {N_FFT}, mel_power_folded: mel_rfft {ms_kernel:.3f} ms ({ms_turns(turns[0])}), "
          f"{share(ms_kernel, bound_ms)}; dense mel_folded {ms_dense:.3f} ms ({ms_turns(turns[1])}), "
          f"{share(ms_dense, bound_ms)}, {100 * dense_ms / ms_dense:.1f} % of its formulation's peak; "
          f"mel_rfft is {ms_dense / ms_kernel:.1f}x faster; plain version {ms_plain:.3f} ms on {card}")
    print(f"[6] yardstick at B={batch} x 5 s, n_fft {N_FFT}: torch.stft -> abs()**2 -> mel matmul (composed of "
          f"library calls, not one call) {ms_composed:.3f} ms, {share(ms_composed, bound_ms)}; mel_rfft is "
          f"{ms_composed / ms_kernel:.2f}x faster; vs mel_rfft max|d|/clip peak {composed_rel:.3e} on {card}")
    check(composed_rel <= FEATURE_TOL, "the composed yardstick does not compute the kernel's function")
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
    # each step as fit calls it: its dropout masks from the fit's generator
    fit_noise = GlobalBatchNoise(torch.Generator(dev).manual_seed(0))
    for b in (32, 512):
        tr = CNNTrainer(filters=[16, 64, 64], first_stride=4, second_stride=2, batch_size=b, device=dev)
        Xb = np.random.default_rng(b).random((b, N_MELS, 1 + CLIP // HOP, 1), dtype=np.float32)
        tr.prepare_fit(Xb, N_CLASSES)
        tr._net.train()
        opt = torch.optim.Adam(tr._net.parameters(), lr=1e-3)
        X_d = torch.from_numpy(Xb).to(dev)
        y_d = torch.from_numpy(np.arange(b) % N_CLASSES).to(dev)
        idx, w = torch.arange(b, device=dev), torch.ones(b, device=dev)
        step_ms[b] = cuda_ms(lambda: tr.train_step(opt, X_d, y_d, idx, w, noise=fit_noise), iters=20)
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
            step_ms[f"{model} B={b}"] = cuda_ms(lambda: tr.train_step(opt, X_d, y_d, idx, w, noise=fit_noise),
                                                 iters=20)
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

        # what the classical vector's two float64 sums cost here: the rolloff's running sum and the groups'
        # mean and std (over each group's (B, K, T) values, K as the vector's groups), each against float32
        def rolloff_f32(S):
            total = torch.cumsum(S, dim=1)
            cand = torch.where(total < 0.85 * total[:, -1:, :], torch.finfo(S.dtype).max, freqs22[None, :, None])
            return torch.amin(cand, dim=1)

        def aggregate(dtype):
            return torch.cat([torch.cat([dsp._masked_mean(x.to(dtype), None, 2), dsp._masked_std(x.to(dtype), None, 2)],
                                        1) for x in group_vals], 1).to(torch.float32)

        freqs22 = torch.from_numpy(golden.fft_frequencies(SR22, MFCC_N_FFT).astype(np.float32)).to(dev)
        group_vals = [torch.rand(batch, k, Smag.shape[-1], device=dev) for k in (40, 40, 40, 1, 1, 1, 7, 1, 12, 6, 1, 1)]
        ms_repairs = {"rolloff float64 sum": cuda_ms(lambda: groups["rolloff"](Smag), iters=10),
                      "rolloff float32 sum": cuda_ms(lambda: rolloff_f32(Smag), iters=10),
                      "mean/std float64": cuda_ms(lambda: aggregate(torch.float64), iters=10),
                      "mean/std float32": cuda_ms(lambda: aggregate(torch.float32), iters=10)}
        del Smag, M40, group_vals
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
    print(f"[6] the classical vector's float64 sums at B={batch} x 5 s, 22.05 kHz, against float32 in this call: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms_repairs.items()) + f" on {card}")
    timed = mel_route_times(dev, card, entries, waves, waves22)
    epilogue_row = epilogue_times(dev, card, rng)
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

    print(f"[6] audio_cqt at B={CQT_BATCH} x 5 s, 22.05 kHz: cqt_feature {t4h['ms']:.3f} ms "
          f"({CQT_BATCH / t4h['ms'] * 1e3:.0f} clips/s), bound {t4h['bound_ms']:.3f} ms ({t4h['bound_by']}, "
          f"{t4h['flops'] / 1e9:.1f} G float64 operations), {100 * t4h['bound_ms'] / t4h['ms']:.2f} % of it; peak memory "
          f"{t4h['peak_gib']:.2f} GiB; float64 GEMM {t4h['gemm_rate'] / 1e12:.2f} TFLOP/s on {card}")
    print(f"[6] image_classical at B={IMAGE_BATCH} x 128 x 128: classical_image_vector_batch {t4i['image_ms']:.3f} ms "
          f"({IMAGE_BATCH / t4i['image_ms'] * 1e3:.0f} images/s; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in t4i["image_parts_ms"].items()) + "); MobileNetV2 embedder at 224: "
          + ", ".join(f"B={b} {v:.3f} ms ({b / v * 1e3:.0f} images/s)" for b, v in t4i["embed_ms"].items())
          + f" on {card}")
    check(all(np.isfinite([t4h["ms"], t4i["image_ms"], *t4i["image_parts_ms"].values(), *t4i["embed_ms"].values()])),
          "4h-4j timing")
    tuning_times(t5e, card, in_turns)
    deploy_times(t5f, card)
    family_times(dev, card, t5g)
    print(f"[6] augmentation stage on {card}: configs/augmentation.yaml {t4f['shipped_host_s']:.2f} s on the host "
          f"backend (workers 1) and {t4f['shipped_dev_s']:.2f} s on the device backend; time_stretch then pitch_shift "
          f"on every class ({N_CLASSES * AUG_PER_CLASS} clips x 4 copies) {t4f['aug_host_s']:.2f} s on the host backend "
          f"(workers {t4f['aug_workers']}) and {t4f['aug_dev_s']:.2f} s on the device backend (each a CLI process, "
          f"start-up included); time_stretch_batch alone at B={AUG_BATCH} x 5 s: {t4f['stretch_ms']:.2f} ms on the "
          f"card, {t4f['stretch_cpu_ms']:.1f} ms on the CPU (B=8, scaled to {AUG_BATCH})")

    check(all(np.isfinite([ms_kernel, ms_dense, ms_plain, ms_unf, ms_unf_dense, ms_unf_plain, ms_400, ms_400_folded,
                            ms_400_unfolded, ms_e2e, ms_epilogue, ms_cnn, *step_ms.values(), ms_mfcc_kernel, ms_mfcc_f64,
                            ms_mfcc_plain, ms_mfcc_seq, ms_classical, ms_mfcc_block, ms_mag_stft, ms_groups,
                            *(r[k] for v in timed.values() for r in v for k in ("ms", "plain_ms", "bound_ms"))])),
          "timing")
    for key, n in unfolded_czt_launches.items():   # 4b's off-plan call through the unfolded entry
        path_launches[key] = path_launches.get(key, 0) + n
    on_path = [key for key in timed if key.startswith(("mel_rfft", "mel_czt"))]   # the dense kernels are on none
    check(all(path_launches.get(key, 0) >= 1 for key in on_path),
          f"a kernel of this slice's path was not launched there: {path_launches}")

    # 7. results
    print(json.dumps({"kernels": [{
        "name": "mel_folded", "route": "cuda", "source": "audio_edge_ml_pipeline_torch/csrc/mel_rfft.cu",
        "replaces": "audio_edge_ml_pipeline_tpu/ops/pallas_mel.py:119",
        "launches": (extract_launches + shipped_f32 + t4e["mel_launches"] + t4f["mel_launches"] + t4g["mel_launches"]
                     + serve_launches + trained_launches + t5e["mel_launches"] + t5f["mel_launches"]
                     + t5g["mel_launches"] + t5h["mel_launches"] + t5j["mel_launches"] + t5l["mel_launches"]),
        "max_abs_err": worst_abs,
        "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "plain_products": "float64", "dense_ms": ms_dense,
        "dense_source": "audio_edge_ml_pipeline_torch/csrc/mel_folded.cu",
        "composed_library_ms": ms_composed,   # torch.stft -> abs()**2 -> mel matmul: a yardstick, not one call
    }, {
        "name": "mel_folded_f64", "route": "cuda", "source": "audio_edge_ml_pipeline_torch/csrc/mel_rfft.cu",
        "replaces": "audio_edge_ml_pipeline_tpu/ops/pallas_mel.py:119",
        "launches": shipped_f64 + t4e["f64_launches"], "max_abs_err": worst_abs_f64,
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
        **({"also_replaces": "audio_edge_ml_pipeline_tpu/ops/pallas_mel.py:35"} if key.startswith("mel_czt") else {}),
        "launches": path_launches.get(key, 0) if key in on_path else 0,
        "max_abs_err": max([errs_by_instantiation.get(key, 0.0)] + [r.get("max_abs_err", 0.0) for r in rows]),
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"], "bound_ms": rows[0]["bound_ms"],
        "bound_by": rows[0]["bound_by"], "library_ms": None, "shape": rows[0]["shape"], "entry": rows[0]["entry"],
        **({} if key in on_path else {"on_path": False, "replaced_by": "audio_edge_ml_pipeline_torch/csrc/mel_czt.cu"}),
        "also": [{k: r[k] for k in ("entry", "shape", "ms", "plain_ms", "bound_ms", "bound_by")} for r in rows[1:]],
    } for key, rows in timed.items()), {**epilogue_row, "launches": extract_epilogue + serve_epilogue + trained_epilogue
                                                        + forward_launches[1]}]}))
    print(f"[7] the smoke run took {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
