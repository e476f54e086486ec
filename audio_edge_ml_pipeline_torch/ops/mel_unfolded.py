"""The unfolded mel-power kernel: wrapper, route, plain version and launch counts.

``mel_power_unfolded`` computes what the TPU kernel
``audio_edge_ml_pipeline_tpu/ops/pallas_mel.py::_mel_kernel`` computes
(through ``mel_power_pallas``): each center-padded frame times the Hann
windowed cos|sin DFT basis (``dsp.dft_bases``), its power, and the slaney
mel product, (B, n) waveforms -> (B, T, n_mels) mel power, time-major, with
T = 1 + n // hop. That is the folded kernel's function, so on a CUDA tensor
it launches one of two hand-written kernels, chosen by ``route`` from n_fft
alone: the real FFT ``csrc/mel_rfft.cu`` (``mel_kernel.launch_rfft``) for
n_fft in {256, 320, 400, 480, 512, 640, 1024, 2048}, and
``csrc/mel_unfolded.cu``, the dense unfolded DFT, for every other even
n_fft; the dense one runs in float32 only and its shared memory holds n_fft
up to 3,070 at hop 160 (2,302 at hop 512). On a CPU tensor it runs
``mel_power_unfolded_plain``, the same product as torch ops on frames cut
with ``Tensor.unfold``. There is no fallback from one to another: a CUDA
tensor the routed kernel cannot take raises.

Odd n_fft is refused, as the JAX kernel refuses it (its frame tiles run out
of bounds there). Nothing in the port's CLIs calls this wrapper: no JAX path
calls ``mel_power_pallas``, and ``audio_mel_spec`` runs the folded kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, dsp, rfft_plan
from .golden import librosa_ref as ref
from .mel_kernel import F_ALIGN, SMEM_LIMIT, KernelCounter, _round_up, instantiation, launch_rfft

counter = KernelCounter("mel_unfolded")              # every launch of either kernel
counter_dense = KernelCounter("mel_unfolded_dense")  # the launches of the dense one among them
BLOCK_K = 64  # samples per partial DFT sum; csrc/mel_unfolded.cu's kBlockK


@functools.lru_cache(maxsize=None)
def constants(sr: int, n_fft: int, n_mels: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's float32 constants on ``device``, built once per device:
    (C (n_fft, f_pad), S (n_fft, f_pad), fb (f_pad, n_mels)), the two halves
    of ``dsp.dft_bases(n_fft).T`` and the mel bank, zero beyond the n_freq
    live columns / rows."""
    n_freq = 1 + n_fft // 2
    f_pad = _round_up(n_freq, F_ALIGN)
    basis = dsp.dft_bases(n_fft)                       # (2 n_freq, n_fft)
    C = np.zeros((n_fft, f_pad), np.float32); C[:, :n_freq] = basis[:n_freq].T
    S = np.zeros((n_fft, f_pad), np.float32); S[:, :n_freq] = basis[n_freq:].T
    fb = np.zeros((f_pad, n_mels), np.float32)
    fb[:n_freq] = ref.mel_filterbank(sr, n_fft, n_mels).astype(np.float32).T
    return tuple(torch.from_numpy(c).to(device) for c in (C, S, fb))


@functools.lru_cache(maxsize=8)
def _plain_tables(sr: int, n_fft: int, n_mels: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(basis.T (n_fft, 2 n_freq), fb.T (n_freq, n_mels)) on ``device``."""
    basis_t = torch.from_numpy(dsp.dft_bases(n_fft).T.copy()).to(device)
    fb_t = torch.from_numpy(ref.mel_filterbank(sr, n_fft, n_mels).astype(np.float32).T.copy()).to(device)
    return basis_t, fb_t


def mel_power_unfolded_plain(
    y: torch.Tensor, sr: int = 16000, n_mels: int = 40, n_fft: int = 512, hop_length: int = 160,
) -> torch.Tensor:
    """The kernel's plain version: (B, n) -> (B, T, n_mels). Frames of the
    zero-padded clip (``Tensor.unfold``) times the windowed DFT basis, power,
    then the mel product.

    The DFT sums each block of BLOCK_K samples apart and then adds the
    blocks in order, as the kernel does, so the two round alike: one float32
    GEMM over all n_fft samples rounds at the 1e-6 level of a clip's peak
    mel power (cuBLAS on an H100), more than the kernel-vs-plain check
    allows."""
    basis_t, fb_t = _plain_tables(sr, n_fft, n_mels, y.device)
    pad = n_fft // 2
    frames = torch.nn.functional.pad(y, (pad, pad)).unfold(1, n_fft, hop_length)  # (B, T, n_fft)
    spec = torch.matmul(frames[..., :BLOCK_K], basis_t[:BLOCK_K])
    for k in range(BLOCK_K, n_fft, BLOCK_K):
        spec = spec + torch.matmul(frames[..., k : k + BLOCK_K], basis_t[k : k + BLOCK_K])
    n_freq = 1 + n_fft // 2
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    return torch.matmul(re * re + im * im, fb_t)


def _check(y: torch.Tensor) -> None:
    if y.dtype != torch.float32:
        raise TypeError(f"mel_power_unfolded takes float32 waveforms, got {y.dtype}")
    if y.ndim != 2 or y.shape[0] == 0 or y.shape[1] == 0:
        raise ValueError(f"mel_power_unfolded takes a non-empty (B, n) batch, got shape {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("mel_power_unfolded takes a contiguous (B, n) tensor")


def route(n_fft: int) -> str:
    """The kernel that takes ``n_fft`` on a card: "rfft" (csrc/mel_rfft.cu)
    for the FFT's sizes, "dense" (csrc/mel_unfolded.cu) for any other even
    n_fft, as ``mel_kernel.route`` sends the folded entry's. Odd n_fft raises."""
    if n_fft % 2 or n_fft < 2:
        raise ValueError(
            f"mel_power_unfolded needs an even n_fft, got {n_fft}: the JAX kernel it ports "
            "(pallas_mel.mel_power_pallas) does not take odd sizes either")
    return "rfft" if rfft_plan.supports(n_fft) else "dense"


def _library() -> ctypes.CDLL:
    lib = _build.load_library("mel_unfolded")
    fn = lib.mel_unfolded_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, p, p, i, i, p, i, p, p]
        fn.restype = ctypes.c_int
        lib.mel_unfolded_smem_bytes.argtypes = [i, i, i]
        lib.mel_unfolded_smem_bytes.restype = ctypes.c_size_t
    return lib


def launch_dense(y: torch.Tensor, consts: tuple[torch.Tensor, ...], n_fft: int, hop_length: int) -> torch.Tensor:
    """csrc/mel_unfolded.cu on a CUDA (B, n) float32 tensor -> (B, T, n_mels).
    Counts nothing: the wrapper counts."""
    C, S, fb = consts
    batch, n = y.shape
    T = dsp.n_frames_for(n, hop_length)
    f_pad, n_mels = fb.shape
    lib = _library()
    smem = lib.mel_unfolded_smem_bytes(n_fft, hop_length, f_pad)
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_fft={n_fft}, hop={hop_length} need {smem} B of shared memory per block (> {SMEM_LIMIT})")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's y limit of 65535 clips")
    out = torch.empty((batch, T, n_mels), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.mel_unfolded_launch(
            y.data_ptr(), batch, n, T, n_fft, hop_length,
            C.data_ptr(), S.data_ptr(), 1 + n_fft // 2, f_pad,
            fb.data_ptr(), n_mels, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mel_unfolded kernel launch failed: cudaError {err}")
    return out


def mel_power_unfolded(
    y: torch.Tensor,
    sr: int = 16000,
    n_mels: int = 40,
    n_fft: int = 512,
    hop_length: int = 160,
) -> torch.Tensor:
    """(B, n) float32 waveforms -> (B, T, n_mels) mel power, T = 1 + n // hop.

    A CUDA tensor launches the kernel ``route(n_fft)`` names; a CPU tensor
    runs the plain version."""
    _check(y)
    kernel = route(n_fft)
    if y.device.type == "cuda":
        if kernel == "rfft":
            out = launch_rfft(y, sr, n_mels, n_fft, hop_length)
        else:
            out = launch_dense(y, constants(sr, n_fft, n_mels, y.device), n_fft, hop_length)
            counter_dense.add()
        counter.add(instantiation("mel_unfolded" if kernel == "dense" else kernel, n_fft, False))
        return out
    if y.device.type == "cpu":
        return mel_power_unfolded_plain(y, sr, n_mels, n_fft, hop_length)
    raise ValueError(f"mel_power_unfolded runs on cuda (kernel) or cpu (plain version), not {y.device}")
