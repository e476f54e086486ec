"""The MFCC features and the classical feature vector, batched.

``mfcc``, ``mfcc_seq_feature`` and ``classical_feature_vector`` compute what
the functions of the same names in ``audio_edge_ml_pipeline_tpu/ops/dsp.py``
compute. Their mel power at even n_fft is ``mel_kernel.mel_power_folded``:
on a CUDA tensor the hand-written kernel that ``mel_kernel.route`` names
(``csrc/mel_rfft.cu`` at n_fft 1024, the MFCC default, and its other
plans; ``csrc/mel_folded.cu`` at any other even n_fft), in its float64
instantiation (``precise=True``: in float32 the kernel put the MFCC
sequence of fsc22-like clips 1.38e-5 from float64, over the 1e-5 gate),
counted on ``mel_kernel.counter`` and ``counter_f64``; on a CPU tensor its
plain version, whose products run in float64 too. Odd n_fft has no
fold and runs ``dsp.melspectrogram``'s framed basis product, as the JAX
package leaves it to XLA. Everything after the mel power is ``ops.dsp``'s
torch ops, whose products accumulate in float64 whatever the global matmul
flags say.
"""

from __future__ import annotations

import torch

from . import dsp, mel_kernel
from .golden import librosa_ref as ref
from .golden.librosa_ref import _ALL_CLASSICAL

_SCALAR_GROUPS = {"spectral_centroid", "spectral_rolloff", "spectral_bandwidth", "spectral_flatness", "zcr", "rms"}
_MFCC_GROUPS = {"mfcc", "delta_mfcc", "delta2_mfcc"}
_STFT_GROUPS = {"spectral_centroid", "spectral_rolloff", "spectral_bandwidth", "spectral_contrast",
                "spectral_flatness", "chroma", "tonnetz"}


def mel_power(y: torch.Tensor, sr: float, n_mels: int, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, n) -> (B, n_mels, T) mel power: the folded kernel's wrapper at
    even n_fft, the framed basis product at odd n_fft."""
    if n_fft % 2:
        return dsp.melspectrogram(y, sr, n_mels, n_fft, hop_length)
    mel = mel_kernel.mel_power_folded(y.contiguous(), sr, n_mels, n_fft, hop_length, precise=True)
    return mel.transpose(1, 2)


def mfcc(
    y: torch.Tensor,
    sr: float,
    n_mfcc: int,
    n_fft: int,
    hop_length: int,
    n_mels: int = 128,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, n) -> (B, n_mfcc, T); log-mel (ref=1.0, top_db=80) -> ortho DCT-II."""
    S_db = dsp.power_to_db(mel_power(y, sr, n_mels, n_fft, hop_length), ref_mode=1.0, amin=1e-10, top_db=80.0,
                           mask=mask)
    return dsp._matmul64(dsp._on(y.device, ref.dct_ii_ortho_matrix, n_mfcc, n_mels), S_db)


def mfcc_seq_feature(
    y: torch.Tensor,
    sr: float = 22050,
    n_mfcc: int = 40,
    n_fft: int = 1024,
    hop_length: int = 512,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """audio_mfcc_seq contract: (B, n) -> (B, n_mfcc, T), each coefficient
    z-scored over the clip's valid frames."""
    # the STFT's exact frame count: for odd n_fft the center padding is
    # n_fft - 1, one frame fewer than n_frames_for when hop divides n
    T = 1 + (y.shape[1] + 2 * (n_fft // 2) - n_fft) // hop_length
    mask = dsp.frame_mask(T, lengths, hop_length)
    M = mfcc(y, sr, n_mfcc, n_fft, hop_length, mask=mask)
    m2 = None if mask is None else mask[:, None, :]
    mean = dsp._masked_mean(M, m2, dim=2)[:, :, None]
    std = dsp._masked_std(M, m2, dim=2)[:, :, None] + 1e-8
    return ((M - mean) / std).to(torch.float32)


def classical_feature_vector(
    y: torch.Tensor,
    sr: float = 22050,
    n_mfcc: int = 40,
    n_mels: int = 128,
    n_fft: int = 1024,
    hop_length: int = 512,
    features: tuple[str, ...] | None = None,
    aggregations: tuple[str, ...] = ("mean", "std"),
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """audio_classical contract: (B, n) -> (B, feature_dim), 302-d by default.

    Per-group frame features aggregated (mean, std) in canonical order. One
    magnitude STFT serves every spectral group; the MFCC groups share one
    ``mfcc`` call."""
    if lengths is not None:
        # savgol deltas and per-band contrast sorts couple across frames, so
        # pad-masking cannot reproduce per-clip semantics near the boundary
        raise ValueError(
            "classical_feature_vector does not support masked variable-length "
            "batches; group clips by exact length (exact_length_batching)."
        )
    feats = tuple(_ALL_CLASSICAL) if features is None else tuple(k for k in _ALL_CLASSICAL if k in set(features))
    aggs = tuple(a for a in ("mean", "std") if a in set(aggregations))
    active = set(feats)

    Smag = dsp.stft_spectrum(y, n_fft, hop_length, power=1.0) if active & _STFT_GROUPS else None
    cache: dict[str, torch.Tensor] = {}
    if active & _MFCC_GROUPS:
        cache["mfcc"] = mfcc(y, sr, n_mfcc, n_fft, hop_length, n_mels=n_mels)
        if "delta_mfcc" in active:
            cache["delta_mfcc"] = dsp.delta(cache["mfcc"], order=1)
        if "delta2_mfcc" in active:
            cache["delta2_mfcc"] = dsp.delta(cache["mfcc"], order=2)
    if active & {"spectral_centroid", "spectral_bandwidth"}:
        cache["spectral_centroid"] = dsp.spectral_centroid_from_mag(Smag, sr, n_fft)[:, None, :]
    if "spectral_rolloff" in active:
        cache["spectral_rolloff"] = dsp.spectral_rolloff_from_mag(Smag, sr, n_fft)[:, None, :]
    if "spectral_bandwidth" in active:
        cache["spectral_bandwidth"] = dsp.spectral_bandwidth_from_mag(Smag, sr, n_fft)[:, None, :]
    if "spectral_contrast" in active:
        cache["spectral_contrast"] = dsp.spectral_contrast_from_mag(Smag, sr, n_fft)
    if "spectral_flatness" in active:
        cache["spectral_flatness"] = dsp.spectral_flatness_from_mag(Smag)[:, None, :]
    if active & {"chroma", "tonnetz"}:
        cache["chroma"] = dsp.chroma_from_power(Smag * Smag, sr, n_fft)
        if "tonnetz" in active:
            cache["tonnetz"] = dsp.tonnetz_from_chroma(cache["chroma"])
    if "zcr" in active:
        cache["zcr"] = dsp.zero_crossing_rate(y, hop_length=hop_length)[:, None, :]
    if "rms" in active:
        cache["rms"] = dsp.rms(y, frame_length=n_fft, hop_length=hop_length)[:, None, :]

    parts = []
    for key in feats:
        # the mean and std in float64: a float32 sum of T equal values ends an
        # ulp off in a card's reduction order, and the std of a constant group
        # (the rolloff of a steady tone near 6 kHz) then reads that ulp where
        # golden reads 0 (card vs CPU 4.9e-4 on an NVIDIA H100 80GB HBM3 at
        # 700 W, chip_smoke.py phase 4e; gate 1e-4)
        x = cache[key].to(torch.float64)  # (B, K, T)
        if key in _SCALAR_GROUPS:
            # aggregate over all values (librosa float(x.mean()) over (1, T))
            x = x.reshape(x.shape[0], 1, -1)
        if "mean" in aggs:
            parts.append(dsp._masked_mean(x, None, dim=2))
        if "std" in aggs:
            parts.append(dsp._masked_std(x, None, dim=2))
    return torch.cat(parts, dim=1).to(torch.float32)
