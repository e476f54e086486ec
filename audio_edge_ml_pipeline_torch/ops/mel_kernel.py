"""The folded mel-power kernels: wrapper, route, plain version and launch counts.

``mel_power_folded`` computes what the TPU kernel
``audio_edge_ml_pipeline_tpu/ops/pallas_mel.py::_mel_folded_kernel`` computes
(through ``mel_power_pallas_folded``): the center-padded folded Hann STFT,
its power, and the slaney mel product, (B, n) waveforms -> (B, T, n_mels)
mel power, time-major. On a CUDA tensor it launches one of two hand-written
kernels, chosen by ``route`` from n_fft alone: ``csrc/mel_rfft.cu``, a real
FFT of compiled plans, for n_fft in {256, 320, 400, 480, 512, 640, 1024,
2048} (``rfft_plan`` builds its tables), and ``csrc/mel_czt.cu``, a real FFT
of run-time length (direct where n_fft / 2 is 5-smooth, chirp-z elsewhere;
``czt_plan`` builds its plan and tables), for every other even n_fft. On a
CPU tensor it runs ``mel_power_folded_plain``, the same gather
(``dsp.fold_indices``) and GEMMs as torch ops. There is no fallback from one
to another: a CUDA tensor the routed kernel cannot take raises.

``launch_rfft`` and ``launch_czt`` launch a kernel and count nothing: the
wrapper counts, in all and by template instantiation
(``KernelCounter.by_instantiation``). ``mel_unfolded.mel_power_unfolded``
calls both too and adds to its own counters. ``launch_dense`` launches the
earlier design of the off-plan route, the dense folded DFT
``csrc/mel_folded.cu``: no route reaches it and no counter counts it;
``chip_smoke.py`` times it beside ``mel_czt``.

``precise=True`` (the MFCC features, ``ops/audio_features.py``) launches
the float64 instantiation of the routed kernel: the same steps in float64,
which the MFCC's dB scale at ref = 1 needs (see that file), on float64
tables. Those launches count on ``counter`` and on ``counter_f64``. Each
kernel sizes its tiles to the shared memory (``fit_tile``): ``mel_czt``
holds every even n_fft up to 16,384 in float32 and 10,240 in float64 at hop
160 and 40 mels (one warp of one frame a block there) and raises above.

``mel_spec_feature`` adds the masked dB and min-max epilogue, as
``mel_spec_feature_pallas`` does on the TPU side: on a CUDA tensor one
launch of ``csrc/mel_epilogue.cu`` (``launch_epilogue``, counted on
``counter_epilogue``), on a CPU tensor its plain version,
``dsp.mel_epilogue``'s torch ops. It takes the mel power in either layout,
frames-major (the kernels' (B, T, n_mels) through a transpose) or
mels-major, and writes with the input's strides (``epilogue_layout``). The
mel power is a ``mel`` span and the epilogue an ``epilogue`` span
(``utils.profiling.span``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import numpy as np
import torch

from ..utils.profiling import span
from . import _build, czt_plan, dsp, rfft_plan
from .golden import librosa_ref as ref

F_ALIGN = 96              # f_pad is a multiple of 32 lanes x kChunksPerPass
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on Hopper
RFFT_TILES = (32, 16, 8, 4, 2, 1)   # frames a tile that csrc/mel_rfft.cu takes, preferred first
DENSE_TILES = (32, 16, 8, 4)        # frames a block that csrc/mel_folded.cu is built for, preferred first
CZT_SHAPES = ((8, 32), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))  # csrc/mel_czt.cu's
                                    # (warps a block, frames a tile), preferred first


class KernelCounter:
    """Launches of one kernel, counted where the wrapper launches it: in all,
    and by template instantiation (``mel_rfft<M, float>``, ...)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0
        self.by_instantiation: collections.Counter[str] = collections.Counter()
        self._lock = threading.Lock()

    def add(self, instantiation: str | None = None) -> None:
        with self._lock:
            self.launches += 1
            if instantiation is not None:
                self.by_instantiation[instantiation] += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.by_instantiation.clear()


def instantiation(kernel: str, n_fft: int, precise: bool) -> str:
    """The template instantiation a launch runs: ``mel_rfft<M, T>`` (M =
    n_fft / 2) for kernel "rfft", else ``<kernel><T>`` (``mel_czt<T>``, or
    a dense kernel's), T float or double."""
    t = "double" if precise else "float"
    return f"mel_rfft<{n_fft // 2}, {t}>" if kernel == "rfft" else f"{kernel}<{t}>"


counter = KernelCounter("mel_folded")              # every launch of either routed kernel
counter_czt = KernelCounter("mel_folded_czt")      # the launches of csrc/mel_czt.cu among them
counter_f64 = KernelCounter("mel_folded_f64")      # the launches of either kernel's float64 instantiation among them
counter_epilogue = KernelCounter("mel_epilogue")   # launches of csrc/mel_epilogue.cu


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def constants(sr: int, n_fft: int, n_mels: int, device: torch.device,
              precise: bool = False) -> tuple[torch.Tensor, ...]:
    """The dense kernel's constants on ``device``, built once per device:
    (A (half, f_pad), B (half, f_pad), wr (f_pad,), fb (f_pad, n_mels)), zero
    beyond the n_freq live columns / rows; float32, or float64 if
    ``precise`` (the float64 instantiation's), both from the float64 bases
    and bank."""
    half = n_fft // 2
    n_freq = 1 + half
    f_pad = _round_up(n_freq, F_ALIGN)
    dtype = np.float64 if precise else np.float32
    A_T, B_T, wr_half = dsp._folded_dft_bases64(n_fft)
    A = np.zeros((half, f_pad), dtype); A[:, :n_freq] = A_T
    B = np.zeros((half, f_pad), dtype); B[:, :n_freq] = B_T
    wr = np.zeros(f_pad, dtype); wr[:n_freq] = wr_half
    fb = np.zeros((f_pad, n_mels), dtype)
    fb[:n_freq] = ref.mel_filterbank(sr, n_fft, n_mels).T
    return tuple(torch.from_numpy(c).to(device) for c in (A, B, wr, fb))


def mel_power_folded_plain(
    y: torch.Tensor, sr: int = 16000, n_mels: int = 40, n_fft: int = 512, hop_length: int = 160,
) -> torch.Tensor:
    """The kernel's plain version: (B, n) -> (B, T, n_mels) through
    ``dsp``'s folded STFT (the same gather indices) and mel GEMM."""
    return dsp.melspectrogram(y, sr, n_mels, n_fft, hop_length).transpose(1, 2)


def route(n_fft: int) -> str:
    """The kernel that takes ``n_fft`` on a card: "rfft" (csrc/mel_rfft.cu)
    for the compiled plans' sizes, "czt" (csrc/mel_czt.cu) for any other even
    n_fft. Odd n_fft raises: the fold pairs x[n] with x[n_fft - n]."""
    if n_fft % 2 or n_fft < 4:
        raise ValueError(f"the folded kernels need an even n_fft >= 4, got {n_fft}")
    return "rfft" if rfft_plan.supports(n_fft) else "czt"


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
            launch.argtypes = [p, i, i, i, i, i, i, p, p, p, p, i, p, i, p, i, i, p, p]
            launch.restype = ctypes.c_int
            smem_bytes.argtypes = [i, i, i, i, i, i, i]
            smem_bytes.restype = ctypes.c_size_t
    return lib


def fit_tile(smem_bytes, tiles: tuple[int, ...]) -> tuple[int, int]:
    """(frames a tile, shared memory a block) of the first of ``tiles`` whose
    ``smem_bytes(tile)`` fits in SMEM_LIMIT; ValueError when none does."""
    for tile in tiles:
        smem = smem_bytes(tile)
        if smem <= SMEM_LIMIT:
            return tile, smem
    raise ValueError(f"{smem} B of shared memory per block at {tiles[-1]} frames a tile (> {SMEM_LIMIT})")


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
    try:   # 32 frames a tile, fewer where a long hop's span would not fit
        tile, _ = fit_tile(lambda t: smem_bytes(n_fft, hop_length, n_mels, weights.numel(), n_rounds, n_slots, t),
                           RFFT_TILES)
    except ValueError as exc:
        raise ValueError(f"mel_rfft at n_fft={n_fft}, hop={hop_length}, n_mels={n_mels}: {exc}") from None
    out = torch.empty((batch, T, n_mels), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = launch(
            y.data_ptr(), batch, n, T, n_fft, hop_length, tile, window.data_ptr(), twiddles.data_ptr(),
            split.data_ptr(), weights.data_ptr(), weights.numel(), chunks.data_ptr(), n_rounds,
            slots.data_ptr(), n_mels, n_slots, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mel_rfft kernel launch failed: cudaError {err}")
    return out


@functools.lru_cache(maxsize=64)
def czt_constants(sr: int, n_fft: int, n_mels: int, device: torch.device,
                  precise: bool = False) -> tuple[torch.Tensor, ...]:
    """What csrc/mel_czt.cu reads of ``czt_plan.tables`` (``tables64`` if
    ``precise``), on ``device``, built once per device: (window, chirp, filt,
    positions, twiddles, split, weights, chunks, slots)."""
    tab = (czt_plan.tables64 if precise else czt_plan.tables)(sr, n_fft, n_mels)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (tab.window, tab.chirp, tab.filt, tab.positions, tab.twiddles, tab.split, tab.weights,
                           tab.chunks, tab.slots))


def _czt_library() -> ctypes.CDLL:
    lib = _build.load_library("mel_czt")
    if lib.mel_czt_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for launch in (lib.mel_czt_launch, lib.mel_czt_launch_f64):
            launch.argtypes = [p, i, i, i, i, i, i, i, i, i, i, p, p, p, i, p, p, p, p, p, p, p, p, i, p, i, i, p, p]
            launch.restype = ctypes.c_int
    return lib


def czt_shape(n_fft: int, hop_length: int, n_slots: int, precise: bool) -> tuple[int, int]:
    """(warps a block, frames a tile) of csrc/mel_czt.cu: the first of
    CZT_SHAPES whose shared memory fits in SMEM_LIMIT (its ``smem_bytes``);
    ValueError naming the kernel when none does."""
    scratch = czt_plan.scratch_size(czt_plan.plan(n_fft))
    t_bytes = 8 if precise else 4

    def smem(shape):
        warps, tile = shape
        return 4 * (((tile - 1) * hop_length + n_fft + 3) // 4 * 4) + t_bytes * warps * (2 * scratch + n_slots)

    try:
        return fit_tile(smem, CZT_SHAPES)[0]
    except ValueError:
        raise ValueError(f"mel_czt<{'double' if precise else 'float'}> at n_fft={n_fft}, hop={hop_length}: "
                         f"{smem(CZT_SHAPES[-1])} B of shared memory for one warp of one frame "
                         f"(> {SMEM_LIMIT})") from None


def launch_czt(y: torch.Tensor, sr: int, n_mels: int, n_fft: int, hop_length: int,
               precise: bool = False) -> torch.Tensor:
    """csrc/mel_czt.cu on a CUDA (B, n) float32 tensor -> (B, T, n_mels),
    its float64 instantiation if ``precise``."""
    plan = czt_plan.plan(n_fft)
    consts = czt_constants(sr, n_fft, n_mels, y.device, precise)
    chunks, slots = consts[7], consts[8]
    n_slots = int(czt_plan.tables(sr, n_fft, n_mels).slots[:, 1].sum())
    warps, tile = czt_shape(n_fft, hop_length, n_slots, precise)
    batch, n = y.shape
    T = dsp.n_frames_for(n, hop_length)
    S = len(plan.radices)
    ints = [(ctypes.c_int * max(S, 1))(*v) for v in (plan.radices, plan.lengths, plan.tw_offsets)]
    lib = _czt_library()
    launch = lib.mel_czt_launch_f64 if precise else lib.mel_czt_launch
    out = torch.empty((batch, T, n_mels), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = launch(
            y.data_ptr(), batch, n, T, n_fft, hop_length, tile, warps, int(plan.mode == "chirp"), plan.length, S,
            *ints, czt_plan.scratch_size(plan), *(c.data_ptr() for c in consts[:7]), chunks.data_ptr(),
            chunks.shape[0], slots.data_ptr(), n_mels, n_slots, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mel_czt kernel launch failed: cudaError {err}")
    return out


def _dense_library() -> ctypes.CDLL:
    lib = _build.load_library("mel_folded")
    fn = lib.mel_folded_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for launch in (lib.mel_folded_launch, lib.mel_folded_launch_f64):
            launch.argtypes = [p, i, i, i, i, i, i, p, p, p, i, i, p, i, p, p]
            launch.restype = ctypes.c_int
        lib.mel_folded_smem_bytes.argtypes = [i, i, i, i]
        lib.mel_folded_smem_bytes.restype = ctypes.c_size_t
    return lib


def launch_dense(y: torch.Tensor, consts: tuple[torch.Tensor, ...], n_fft: int, hop_length: int) -> torch.Tensor:
    """csrc/mel_folded.cu on a CUDA (B, n) float32 tensor -> (B, T, n_mels):
    its float64 instantiation if ``consts`` are float64, at the most frames
    a block (DENSE_TILES) that fit in shared memory. No route launches it:
    the earlier design of the off-plan route, kept to be timed beside
    ``launch_czt``."""
    A, B, wr, fb = consts
    batch, n = y.shape
    T = dsp.n_frames_for(n, hop_length)
    f_pad, n_mels = fb.shape
    lib = _dense_library()
    t_bytes = A.element_size()
    try:
        tile, _ = fit_tile(lambda t: lib.mel_folded_smem_bytes(n_fft, f_pad, t, t_bytes), DENSE_TILES)
    except ValueError as exc:
        raise ValueError(f"mel_folded at n_fft={n_fft} ({A.dtype}): {exc}") from None
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's y limit of 65535 clips")
    launch = lib.mel_folded_launch_f64 if t_bytes == 8 else lib.mel_folded_launch
    out = torch.empty((batch, T, n_mels), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = launch(
            y.data_ptr(), batch, n, T, n_fft, hop_length, tile,
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

    A CUDA tensor launches the kernel ``route(n_fft)`` names, its float64
    instantiation if ``precise``; a CPU tensor runs the plain version, whose
    products run in float64 either way. Either is a ``mel`` span: here the
    tables and the launch, ``dsp.melspectrogram`` the plain version."""
    _check(y)
    kernel = route(n_fft)
    if y.device.type == "cuda":
        with span("mel"):
            if kernel == "rfft":
                out = launch_rfft(y, sr, n_mels, n_fft, hop_length, precise)
            else:
                out = launch_czt(y, sr, n_mels, n_fft, hop_length, precise)
                counter_czt.add()
        if precise:
            counter_f64.add()
        counter.add(instantiation("mel_czt" if kernel == "czt" else kernel, n_fft, precise))
        return out
    if y.device.type == "cpu":
        return mel_power_folded_plain(y, sr, n_mels, n_fft, hop_length)
    raise ValueError(f"mel_power_folded runs on cuda (kernel) or cpu (plain version), not {y.device}")


def epilogue_layout(shape: tuple[int, ...], stride: tuple[int, ...], dtype: torch.dtype) -> str:
    """The layout of a (B, n_mels, T) mel power that csrc/mel_epilogue.cu
    takes: "frames" where each clip is stored (T, n_mels) (strides (n_mels
    T, 1, n_mels)), "mels" where it is stored (n_mels, T) (strides (n_mels T,
    T, 1)); the stride of a dimension of size 1 is free. TypeError for
    another dtype than float32, ValueError for any other shape or strides."""
    if dtype != torch.float32:
        raise TypeError(f"the mel epilogue kernel takes float32 mel power, got {dtype}")
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"the mel epilogue kernel takes a non-empty (B, n_mels, T) tensor, got shape {tuple(shape)}")
    _, n_mels, n_frames = shape
    size = n_mels * n_frames
    if size >= 2 ** 31:
        raise ValueError(f"the mel epilogue kernel takes clips of fewer than 2^31 values, got {n_mels} x {n_frames}")
    for layout, want in (("mels", (size, n_frames, 1)), ("frames", (size, 1, n_mels))):
        if all(s == w for s, w, n in zip(stride, want, shape) if n > 1):
            return layout
    raise ValueError(f"the mel epilogue kernel takes a frames-major or mels-major (B, n_mels, T) tensor, "
                     f"got strides {tuple(stride)} at shape {tuple(shape)}")


def epilogue_lengths(lengths: torch.Tensor, batch: int, device: torch.device) -> torch.Tensor:
    """``lengths`` as csrc/mel_epilogue.cu reads them: (batch,) int64,
    contiguous, on ``device`` (the mel power's); a no-op for what
    ``features.base`` passes. TypeError for a dtype that is not an integer,
    ValueError for another shape or device."""
    if lengths.dtype.is_floating_point or lengths.dtype.is_complex or lengths.dtype == torch.bool:
        raise TypeError(f"lengths are sample counts, got {lengths.dtype}")
    if tuple(lengths.shape) != (batch,):
        raise ValueError(f"lengths must hold one count a clip, shape ({batch},), got {tuple(lengths.shape)}")
    if lengths.device != device:
        raise ValueError(f"lengths on {lengths.device}, the mel power on {device}")
    return lengths.to(torch.int64).contiguous()


def _epilogue_library() -> ctypes.CDLL:
    lib = _build.load_library("mel_epilogue")
    if lib.mel_epilogue_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mel_epilogue_launch.argtypes = [p, p, i, i, i, i, i, p, p]
        lib.mel_epilogue_launch.restype = ctypes.c_int
    return lib


def launch_epilogue(mel: torch.Tensor, lengths: torch.Tensor | None, hop_length: int) -> torch.Tensor:
    """csrc/mel_epilogue.cu on a CUDA (B, n_mels, T) float32 mel power ->
    ``dsp.mel_epilogue(mel, lengths, hop_length)``, with ``mel``'s strides.
    One launch on the current stream; allocates only the output."""
    layout = epilogue_layout(tuple(mel.shape), mel.stride(), mel.dtype)
    if hop_length < 1:
        raise ValueError(f"hop_length must be at least 1, got {hop_length}")
    batch, n_mels, n_frames = mel.shape
    if lengths is not None:
        lengths = epilogue_lengths(lengths, batch, mel.device)
    out = torch.empty_strided(mel.shape, mel.stride(), dtype=torch.float32, device=mel.device)
    lib = _epilogue_library()
    with torch.cuda.device(mel.device):
        stream = torch.cuda.current_stream(mel.device).cuda_stream
        err = lib.mel_epilogue_launch(mel.data_ptr(), None if lengths is None else lengths.data_ptr(), batch, n_mels,
                                      n_frames, hop_length, int(layout == "frames"), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mel_epilogue kernel launch failed: cudaError {err}")
    return out


def mel_spec_feature(
    y: torch.Tensor,
    sr: int = 16000,
    n_mels: int = 40,
    n_fft: int = 512,
    hop_length: int = 160,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """audio_mel_spec contract on the folded kernel: (B, n) -> (B, n_mels, T)
    in [0, 1], with padded rows masked by ``lengths`` (samples per clip).

    Odd n_fft has no fold: its mel power is ``dsp.melspectrogram``'s framed
    basis product (torch ops, as the JAX package leaves that branch to XLA),
    whose T is one frame fewer than ``dsp.n_frames_for`` when hop divides n;
    the epilogue masks by that tensor's own T. The epilogue is one launch of
    csrc/mel_epilogue.cu on a CUDA tensor, ``dsp.mel_epilogue`` on a CPU
    one."""
    if n_fft % 2:
        mel = dsp.melspectrogram(y, sr, n_mels, n_fft, hop_length)
    else:
        mel = mel_power_folded(y, sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop_length).transpose(1, 2)
    if mel.device.type != "cuda":
        return dsp.mel_epilogue(mel, lengths, hop_length)
    with span("epilogue"):
        out = launch_epilogue(mel, lengths, hop_length)
    counter_epilogue.add()
    return out
