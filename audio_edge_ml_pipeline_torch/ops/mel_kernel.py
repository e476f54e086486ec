"""The folded mel-power kernels: wrapper, route, plain version and launch counts.

``mel_power_folded`` computes what the TPU kernel
``audio_edge_ml_pipeline_tpu/ops/pallas_mel.py::_mel_folded_kernel`` computes
(through ``mel_power_pallas_folded``): the center-padded folded Hann STFT,
its power, and the slaney mel product, (B, n) waveforms -> (B, T, n_mels)
mel power, time-major. On a CUDA tensor it launches one of two hand-written
kernels, chosen by ``route`` from n_fft alone: ``csrc/mel_rfft.cu``, a real
FFT, for n_fft in {256, 320, 400, 512, 640, 1024} (``rfft_plan`` builds its
tables), and ``csrc/mel_folded.cu``, the dense folded DFT, for every other
even n_fft. On a CPU tensor it runs ``mel_power_folded_plain``, the same
gather (``dsp.fold_indices``) and GEMMs as torch ops. There is no fallback
from one to another: a CUDA tensor the routed kernel cannot take raises.

``launch_rfft`` and ``launch_dense`` launch a kernel and count nothing: the
wrapper counts. ``mel_unfolded.mel_power_unfolded`` calls ``launch_rfft``
too and adds to its own counter.

``precise=True`` (the MFCC features, ``ops/audio_features.py``) launches
``mel_rfft.cu``'s float64 instantiation on the FFT route: the same steps in
float64, which the MFCC's dB scale at ref = 1 needs (see that file). Those
launches count on ``counter`` and on ``counter_f64``. The dense route has no
float64 kernel, so ``precise=True`` on a CUDA tensor at an n_fft off the FFT
route raises rather than run the float32 dense kernel.

``mel_spec_feature`` adds the masked dB and min-max epilogue (torch ops, from
``ops.dsp``), as ``mel_spec_feature_pallas`` does on the TPU side.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build, dsp, rfft_plan
from .golden import librosa_ref as ref

F_ALIGN = 96              # f_pad is a multiple of 32 lanes x kChunksPerPass
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on Hopper


class KernelCounter:
    """Launches of one kernel, counted where the wrapper launches it."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.launches += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0


counter = KernelCounter("mel_folded")              # every launch of either kernel
counter_dense = KernelCounter("mel_folded_dense")  # the launches of the dense one among them
counter_f64 = KernelCounter("mel_folded_f64")      # the launches of mel_rfft's float64 instantiation among them


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def constants(sr: int, n_fft: int, n_mels: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The dense kernel's float32 constants on ``device``, built once per device:
    (A (half, f_pad), B (half, f_pad), wr (f_pad,), fb (f_pad, n_mels)), zero
    beyond the n_freq live columns / rows."""
    half = n_fft // 2
    n_freq = 1 + half
    f_pad = _round_up(n_freq, F_ALIGN)
    A_T, B_T, wr_half = dsp._folded_dft_bases(n_fft)
    A = np.zeros((half, f_pad), np.float32); A[:, :n_freq] = A_T
    B = np.zeros((half, f_pad), np.float32); B[:, :n_freq] = B_T
    wr = np.zeros(f_pad, np.float32); wr[:n_freq] = wr_half
    fb = np.zeros((f_pad, n_mels), np.float32)
    fb[:n_freq] = ref.mel_filterbank(sr, n_fft, n_mels).astype(np.float32).T
    return tuple(torch.from_numpy(c).to(device) for c in (A, B, wr, fb))


def mel_power_folded_plain(
    y: torch.Tensor, sr: int = 16000, n_mels: int = 40, n_fft: int = 512, hop_length: int = 160,
) -> torch.Tensor:
    """The kernel's plain version: (B, n) -> (B, T, n_mels) through
    ``dsp``'s folded STFT (the same gather indices) and mel GEMM."""
    return dsp.melspectrogram(y, sr, n_mels, n_fft, hop_length).transpose(1, 2)


def route(n_fft: int) -> str:
    """The kernel that takes ``n_fft`` on a card: "rfft" (csrc/mel_rfft.cu)
    for the FFT's sizes, "dense" (csrc/mel_folded.cu) for any other even
    n_fft. Odd n_fft raises: the fold pairs x[n] with x[n_fft - n]."""
    if n_fft % 2 or n_fft < 4:
        raise ValueError(f"the folded kernels need an even n_fft >= 4, got {n_fft}")
    return "rfft" if rfft_plan.supports(n_fft) else "dense"


def _check(y: torch.Tensor) -> None:
    if y.dtype != torch.float32:
        raise TypeError(f"mel_power_folded takes float32 waveforms, got {y.dtype}")
    if y.ndim != 2 or y.shape[0] == 0 or y.shape[1] == 0:
        raise ValueError(f"mel_power_folded takes a non-empty (B, n) batch, got shape {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("mel_power_folded takes a contiguous (B, n) tensor")


@functools.lru_cache(maxsize=None)
def rfft_constants(sr: int, n_fft: int, n_mels: int, device: torch.device,
                   precise: bool = False) -> tuple[torch.Tensor, ...]:
    """What csrc/mel_rfft.cu reads of ``rfft_plan.tables`` (``tables64`` if
    ``precise``), on ``device``, built once per device: (window, twiddles,
    split, weights, chunks, slots)."""
    tab = (rfft_plan.tables64 if precise else rfft_plan.tables)(sr, n_fft, n_mels)
    return tuple(torch.from_numpy(a).to(device) for a in (tab.window, tab.twiddles, tab.split, tab.weights,
                                                          tab.chunks, tab.slots))


def _rfft_library() -> ctypes.CDLL:
    lib = _build.load_library("mel_rfft")
    fn = lib.mel_rfft_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for launch, smem_bytes in ((lib.mel_rfft_launch, lib.mel_rfft_smem_bytes),
                                   (lib.mel_rfft_launch_f64, lib.mel_rfft_smem_bytes_f64)):
            launch.argtypes = [p, i, i, i, i, i, p, p, p, p, i, p, i, p, i, i, p, p]
            launch.restype = ctypes.c_int
            smem_bytes.argtypes = [i, i, i, i, i, i]
            smem_bytes.restype = ctypes.c_size_t
    return lib


def launch_rfft(y: torch.Tensor, sr: int, n_mels: int, n_fft: int, hop_length: int,
                precise: bool = False) -> torch.Tensor:
    """csrc/mel_rfft.cu on a CUDA (B, n) float32 tensor -> (B, T, n_mels),
    its float64 instantiation if ``precise``."""
    window, twiddles, split, weights, chunks, slots = rfft_constants(sr, n_fft, n_mels, y.device, precise)
    n_slots = int(rfft_plan.tables(sr, n_fft, n_mels).slots[:, 1].sum())
    batch, n = y.shape
    T = dsp.n_frames_for(n, hop_length)
    n_rounds = chunks.shape[0]
    lib = _rfft_library()
    launch, smem_bytes = ((lib.mel_rfft_launch_f64, lib.mel_rfft_smem_bytes_f64) if precise
                          else (lib.mel_rfft_launch, lib.mel_rfft_smem_bytes))
    smem = smem_bytes(n_fft, hop_length, n_mels, weights.numel(), n_rounds, n_slots)
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_fft={n_fft}, hop={hop_length}, n_mels={n_mels} need {smem} B of shared memory "
                         f"per block (> {SMEM_LIMIT})")
    out = torch.empty((batch, T, n_mels), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = launch(
            y.data_ptr(), batch, n, T, n_fft, hop_length, window.data_ptr(), twiddles.data_ptr(),
            split.data_ptr(), weights.data_ptr(), weights.numel(), chunks.data_ptr(), n_rounds,
            slots.data_ptr(), n_mels, n_slots, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mel_rfft kernel launch failed: cudaError {err}")
    return out


def _dense_library() -> ctypes.CDLL:
    lib = _build.load_library("mel_folded")
    fn = lib.mel_folded_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, p, p, p, i, i, p, i, p, p]
        fn.restype = ctypes.c_int
        lib.mel_folded_smem_bytes.argtypes = [i, i]
        lib.mel_folded_smem_bytes.restype = ctypes.c_size_t
    return lib


def launch_dense(y: torch.Tensor, consts: tuple[torch.Tensor, ...], n_fft: int, hop_length: int) -> torch.Tensor:
    """csrc/mel_folded.cu on a CUDA (B, n) float32 tensor -> (B, T, n_mels)."""
    A, B, wr, fb = consts
    batch, n = y.shape
    T = dsp.n_frames_for(n, hop_length)
    f_pad, n_mels = fb.shape
    lib = _dense_library()
    smem = lib.mel_folded_smem_bytes(n_fft, f_pad)
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_fft={n_fft} needs {smem} B of shared memory per block (> {SMEM_LIMIT})")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's y limit of 65535 clips")
    out = torch.empty((batch, T, n_mels), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.mel_folded_launch(
            y.data_ptr(), batch, n, T, n_fft, hop_length,
            A.data_ptr(), B.data_ptr(), wr.data_ptr(), 1 + n_fft // 2, f_pad,
            fb.data_ptr(), n_mels, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mel_folded kernel launch failed: cudaError {err}")
    return out


def mel_power_folded(
    y: torch.Tensor,
    sr: int = 16000,
    n_mels: int = 40,
    n_fft: int = 512,
    hop_length: int = 160,
    precise: bool = False,
) -> torch.Tensor:
    """(B, n) float32 waveforms -> (B, T, n_mels) mel power, T = 1 + n // hop.

    A CUDA tensor launches the kernel ``route(n_fft)`` names (on the FFT
    route, its float64 instantiation if ``precise``); a CPU tensor runs the
    plain version, whose products run in float64 either way."""
    _check(y)
    kernel = route(n_fft)
    if y.device.type == "cuda":
        if precise and kernel == "dense":
            raise ValueError(f"precise=True needs mel_rfft.cu's float64 instantiation, which has no plan for "
                             f"n_fft={n_fft}; it takes n_fft in {sorted(rfft_plan.RADICES)}, and the dense "
                             f"kernel runs in float32 only")
        if kernel == "rfft":
            out = launch_rfft(y, sr, n_mels, n_fft, hop_length, precise)
            if precise:
                counter_f64.add()
        else:
            out = launch_dense(y, constants(sr, n_fft, n_mels, y.device), n_fft, hop_length)
            counter_dense.add()
        counter.add()
        return out
    if y.device.type == "cpu":
        return mel_power_folded_plain(y, sr, n_mels, n_fft, hop_length)
    raise ValueError(f"mel_power_folded runs on cuda (kernel) or cpu (plain version), not {y.device}")


def mel_spec_feature(
    y: torch.Tensor,
    sr: int = 16000,
    n_mels: int = 40,
    n_fft: int = 512,
    hop_length: int = 160,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """audio_mel_spec contract on the folded kernel: (B, n) -> (B, n_mels, T)
    in [0, 1], with padded rows masked by ``lengths`` (samples per clip)."""
    mel = mel_power_folded(y, sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop_length)
    return dsp.mel_epilogue(mel.transpose(1, 2), lengths, hop_length)
