#!/usr/bin/env python3
"""Split the time of the FFT mel kernel (audio_edge_ml_pipeline_torch/csrc/mel_rfft.cu)
by timing it beside copies with one design choice undone or one stage cut.

Each variant is the shipped source with one text substitution, built with
the port's nvcc flags into build/variants/ and launched on the same
B=512 five-second clips (chip_smoke.synth_clips, hop 160, 40 mels, n_fft
512 or the one --n-fft names, any size of rfft_plan.RADICES) through the
same tables, in alternating turns on one card:

  shipped             the kernel as it is
  one_filter_a_lane   the same binary with a schedule of one whole filter a
                      lane (filter j on lane j % 32), instead of balanced chunks
  pad1                one float of scratch padding every 32 values, not five
  ldg_span            the tile span loaded by __ldg and st.shared, not cp.async
  no_mel              (wrong output) the mel chunk sums cut
  no_later_passes     (wrong output) every FFT pass after the first cut
  span_only           (wrong output) every frame cut: tables, spans, nothing else

The first four must agree with the plain version within chip_smoke's
KERNEL_REL_TOL; the last three only time what is left.

Usage (on a machine with an NVIDIA card and nvcc):
    python3 scripts/torch_mel_rfft_variants.py [--n-fft 400]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from audio_edge_ml_pipeline_torch.ops import _build, mel_kernel, rfft_plan  # noqa: E402

SR, HOP, N_MELS, BATCH = 16000, 160, 40, 512
SUBSTITUTIONS = {
    "pad1": ("return i + 5 * (i >> 5);", "return i + (i >> 5);"),
    "ldg_span": ("copy_async(xs + i, inside ? row + j : row, inside);", "xs[i] = inside ? __ldg(row + j) : 0.0f;"),
    "no_mel": ("for (int q = 0; q < n_rounds; ++q) {", "for (int q = 0; q < 0; ++q) {"),
    "no_later_passes": ("p1.run(re, im, lane);\n      p2.run(re, im, lane);\n      p3.run(re, im, lane);", ""),
    "span_only": ("for (int f = warp; f < tile_t; f += W) {", "for (int f = warp; f < 0; f += W) {"),
}
DIAGNOSTIC = {"no_mel", "no_later_passes", "span_only"}


def one_filter_a_lane(tab: rfft_plan.Tables) -> tuple[np.ndarray, np.ndarray]:
    """(chunks, slots): filter j whole, on lane j % 32 in round j // 32."""
    n_mels = len(tab.bands)
    chunks = np.full((-(-n_mels // rfft_plan.LANES), rfft_plan.LANES, 4), -1, np.int32)
    chunks[..., :3] = 0
    for j, (lo, length, off) in enumerate(tab.bands.tolist()):
        chunks[j // rfft_plan.LANES, j % rfft_plan.LANES] = (lo, length, off, j)
    return chunks, np.stack([np.arange(n_mels), np.ones(n_mels)], axis=1).astype(np.int32)


def build(out_dir: Path) -> dict[str, Path]:
    source = (_build.CSRC / "mel_rfft.cu").read_text()
    sources = {"shipped": source}
    for name, (old, new) in SUBSTITUTIONS.items():
        if old not in source:
            raise SystemExit(f"variant {name}: {old!r} is no longer in mel_rfft.cu")
        sources[name] = source.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: ptxas {' | '.join(regs)}")
    return {name: out_dir / f"lib{name}.so" for name in sources}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-fft", type=int, default=512, choices=sorted(rfft_plan.RADICES))
    n_fft = parser.parse_args(argv).n_fft
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = build(REPO / "build" / "variants")
    waves = torch.from_numpy(np.tile(chip_smoke.synth_clips(np.random.default_rng(0), 8), (BATCH // 8, 1))).to(dev)
    n = waves.shape[1]
    T = 1 + n // HOP
    tab = rfft_plan.tables(SR, n_fft, N_MELS)
    plain = mel_kernel.mel_power_folded_plain(waves, SR, N_MELS, n_fft, HOP)
    scale = plain.abs().amax(dim=(1, 2), keepdim=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int

    def launcher(lib_path: Path, chunks_np: np.ndarray, slots_np: np.ndarray):
        lib = ctypes.CDLL(str(lib_path))
        fn, smem_bytes = lib.mel_rfft_launch, lib.mel_rfft_smem_bytes
        fn.argtypes = [p, i, i, i, i, i, i, p, p, p, p, i, p, i, p, i, i, p, p]
        fn.restype = i
        smem_bytes.argtypes = [i] * 7
        smem_bytes.restype = ctypes.c_size_t
        tile, _ = mel_kernel.fit_tile(lambda t: smem_bytes(n_fft, HOP, N_MELS, len(tab.weights), chunks_np.shape[0],
                                                           int(slots_np[:, 1].sum()), t), mel_kernel.RFFT_TILES)
        window, twiddles, split, weights = (torch.from_numpy(a).to(dev) for a in (tab.window, tab.twiddles,
                                                                                   tab.split, tab.weights))
        chunks, slots = torch.from_numpy(chunks_np).to(dev), torch.from_numpy(slots_np).to(dev)
        out = torch.empty((BATCH, T, N_MELS), device=dev)
        keep = (window, twiddles, split, weights, chunks, slots)

        def run():
            err = fn(waves.data_ptr(), BATCH, n, T, n_fft, HOP, tile, *(t.data_ptr() for t in keep[:4]), weights.numel(),
                     chunks.data_ptr(), chunks.shape[0], slots.data_ptr(), N_MELS, int(slots_np[:, 1].sum()),
                     out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out
        return run

    runs = {name: launcher(path, tab.chunks, tab.slots) for name, path in libs.items()}
    runs["one_filter_a_lane"] = launcher(libs["shipped"], *one_filter_a_lane(tab))
    for name, run in runs.items():
        out = run()
        torch.cuda.synchronize()
        rel = float(((out - plain).abs() / scale).max())
        if name not in DIAGNOSTIC and not rel <= chip_smoke.KERNEL_REL_TOL:
            raise SystemExit(f"{name} disagrees with the plain version: {rel:.3e}")
    names = list(runs)
    times: dict[str, list[float]] = {name: [] for name in names}
    for turn in range(4):
        for name in names if turn % 2 == 0 else names[::-1]:
            times[name].append(chip_smoke.cuda_ms(runs[name]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"mel_rfft variants at B={BATCH} x 5 s, n_fft {n_fft}, hop {HOP}, {N_MELS} mels on {card}:")
    for name in names:
        tag = " (diagnostic, wrong output)" if name in DIAGNOSTIC else ""
        print(f"  {name:18s} {np.mean(times[name]):.4f} ms  turns {' '.join(f'{t:.4f}' for t in times[name])}{tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
